"""PyTorch/CUDA port of ``repro``: the split-FL simulation on an NVIDIA GPU.

Mirrors ``repro``'s layout (``core/ fl/ models/ kernels/``). Imports torch and
numpy, never jax and nothing of ``repro``.
"""
