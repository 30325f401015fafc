"""Hand-written CUDA kernels for Hopper, one subpackage per kernel family.

Each subpackage mirrors ``repro.kernels``'s (kernel.py, ops.py, ref.py)
triple: ``csrc/*.cu`` holds the CUDA source, ``kernel.py`` the wrappers that
launch it (built at first use by :mod:`repro_torch.kernels.build`), ``ref.py``
the plain PyTorch version of each kernel and ``ops.py`` the differentiable
op. A wrapper picks by tensor device only: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises.

``autotune`` holds the kernel-selection tables: the free fields of each
kernel's launch plan (split counts, heads per block, the SSD's inner chunk
and form) per op, shape, dtype and card (``artifacts/autotune_torch/*.json``,
keyed ``op|shape|dtype|backend``), read on the CUDA path only; a miss is the
plan's own rule. Sweep on the card with ``tools/autotune_tables.py``;
validate with ``python -m repro_torch.kernels.autotune --check``.
"""
