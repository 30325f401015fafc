"""Launch drivers of the LM stack (port of ``repro.launch``): ``train``
and ``serve``."""
