"""The Mamba-2 SSD chunked scan (forward) on CUDA."""
