"""Optimizers over nested dicts of tensors (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (Optimizer, adamw, clip_by_global_norm,
                                          cosine_schedule, global_norm, sgd)

__all__ = ["Optimizer", "adamw", "sgd", "cosine_schedule",
           "clip_by_global_norm", "global_norm"]
