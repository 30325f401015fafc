"""Architecture configurations: the port's own copy of the dataclasses."""
