"""Flash attention, forward and the dq / dk-dv backward pair, on CUDA."""
