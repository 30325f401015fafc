"""Fused matmul + bias + activation, forward and backward, on CUDA."""
