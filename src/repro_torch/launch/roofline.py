"""Roofline terms of a traced step (port of the roofline half of
``repro.launch.hlo_analysis``).

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at the
700 W power limit): 989e12 bf16 FLOP/s on the tensor cores and 3.35e12 B/s
of HBM3. A card set below 700 W runs slower under load, so a time from
these terms is a bound against the data sheet, not a measurement.

The reference's ``collective_bytes`` and ``roofline_from_compiled`` parse
XLA's optimized HLO text and its ``cost_analysis()``; a PyTorch step has
neither, so they have no counterpart. The dry run
(:mod:`repro_torch.launch.dryrun`) counts FLOPs and bytes from the traced
ops instead, and no collective traffic: the port has no model-parallel
program whose collectives a trace could see, so the collective term reads
``None`` and the bottleneck is taken over compute and memory.
"""
from __future__ import annotations

import dataclasses

# one H100 SXM: dense bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# why the collective term is empty
NO_COLLECTIVES = ("not counted: a PyTorch trace has no partitioned program "
                  "and so no collectives to count")


@dataclasses.dataclass
class Roofline:
    """Global quantities of one step on ``chips`` H100s: its terms divide
    by the chip count."""
    flops: float
    hbm_bytes: float
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": None,
            "t_collective_reason": NO_COLLECTIVES,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.flops,
            "hlo_bytes": self.hbm_bytes,
            "collective_bytes": None,
            "chips": self.chips,
            "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                      "card": "NVIDIA H100 SXM data sheet, 700 W"},
        }
