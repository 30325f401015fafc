"""Checkpoint files: numpy on disk, in the reference's format."""
from repro_torch.checkpoint.store import (all_steps, gc_steps, latest_step,
                                          load_pytree, save_pytree)

__all__ = ["save_pytree", "load_pytree", "latest_step", "all_steps",
           "gc_steps"]
