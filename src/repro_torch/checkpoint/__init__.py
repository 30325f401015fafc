"""Checkpoint files: numpy on disk, in the reference's format."""
