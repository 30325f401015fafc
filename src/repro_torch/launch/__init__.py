"""Launch drivers of the LM stack (port of ``repro.launch``): ``train``
and ``serve``; the two-stage partition pipeline (``pipeline``); and the
dry run (``dryrun``, with ``specs``, ``mesh`` and ``roofline``) and the
hill climb over it (``hillclimb``)."""
