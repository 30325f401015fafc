"""The control plane: layer-level cost model, device-specific participation
rates and the DDSRA Lyapunov scheduler with its baselines.

The control plane exists twice: ``ddsra`` is the host-side numpy oracle
(Algorithm 1 as written), ``ddsra_batched`` the same algorithm as batched
torch float64 on the simulation's device, one CUDA graph replay a round on
a card (registered as policy ``"ddsra_jax"``, the reference's name);
``baseline_batched`` and ``policy_sweep`` run the fixed-resource baselines
and the policies x seeds x V sweep grid the same way."""
from repro_torch.core import baseline_batched, costmodel, ddsra
from repro_torch.core import ddsra_batched, hungarian, lyapunov, network
from repro_torch.core import participation, partition, policy_sweep
from repro_torch.core import schedulers

__all__ = ["baseline_batched", "costmodel", "ddsra", "ddsra_batched",
           "hungarian", "lyapunov", "network", "participation",
           "partition", "policy_sweep", "schedulers"]
