"""The control plane: layer-level cost model, device-specific participation
rates and the DDSRA Lyapunov scheduler (numpy, host-side)."""
from repro_torch.core import costmodel, ddsra, hungarian, lyapunov
from repro_torch.core import network, participation, schedulers

__all__ = ["costmodel", "ddsra", "hungarian", "lyapunov", "network",
           "participation", "schedulers"]
