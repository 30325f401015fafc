"""Wireless channel + energy model (paper Sec. III-C).

IID block-fading channels, OFDM uplink/downlink between gateways and the BS,
energy-harvesting arrivals at devices and gateways. The simulation
environment is host-side numpy (``Network.draw``), drawn from the same
generator in the same order as ``repro.core.network`` so both packages see
identical channel states for a seed. :func:`draw_state` is the same law
drawn with a ``torch.Generator`` on the control plane's device (another
stream), for sweeps whose draws never leave the device
(``repro_torch.core.ddsra_batched.DDSRAPlan.simulate_v_sweep``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class NetworkConfig:
    n_gateways: int = 6
    n_devices: int = 12
    n_channels: int = 3
    # channel
    h0_db: float = -30.0          # path loss constant
    d0: float = 1.0               # reference distance (m)
    nu: float = 2.0               # path-loss exponent
    bandwidth_up: float = 1e6     # B^u (Hz)
    bandwidth_down: float = 20e6  # B^d (Hz)
    noise_psd_dbm: float = -174.0 # N0 (dBm/Hz)
    p_bs: float = 1.0             # BS transmit power (W)
    p_max: float = 0.2            # gateway max transmit power (W)
    # the paper only says interference is Gaussian "with different variances";
    # chosen here to sit near the thermal noise floor so SINRs land in the
    # 10-30 dB regime the paper's delays imply
    interference_up_var: float = 1e-26
    interference_down_var: float = 1e-25
    # energy
    e_dev_max: float = 5.0        # J per round (uniform arrival bound)
    e_gw_max: float = 30.0
    v_dev: float = 1e-27          # effective switched capacitance
    v_gw: float = 1e-27
    # compute
    phi_dev: float = 16.0         # FLOPs / cycle
    phi_gw: float = 32.0
    f_dev_range: tuple = (0.1e9, 1.0e9)
    f_gw_max: float = 4.0e9
    f_gw_min: float = 0.1e9
    # memory (bytes)
    g_dev_max: float = 2e9
    g_gw_max: float = 4e9
    dist_range: tuple = (1000.0, 2000.0)


@dataclasses.dataclass
class ChannelState:
    """Per-round draw: gains/interference for every (gateway, channel)."""
    h_up: np.ndarray       # (M, J)
    h_down: np.ndarray     # (M, J)
    i_up: np.ndarray       # (M, J)
    i_down: np.ndarray     # (M, J)
    e_dev: np.ndarray      # (N,) energy arrivals
    e_gw: np.ndarray       # (M,)


class ChannelStateT(NamedTuple):
    """:class:`ChannelState` with tensor leaves, for the batched control
    plane (port of ``repro.core.network.ChannelStateT``).

    The same six leaves as the dataclass, each with any leading axes
    (rounds, lanes): ``(..., M, J)`` gains and interference, ``(..., N)``
    and ``(..., M)`` energy arrivals."""
    h_up: torch.Tensor
    h_down: torch.Tensor
    i_up: torch.Tensor
    i_down: torch.Tensor
    e_dev: torch.Tensor
    e_gw: torch.Tensor

    @classmethod
    def of(cls, st: ChannelState, device="cuda",
           dtype=torch.float64) -> "ChannelStateT":
        """Lift one host-drawn :class:`ChannelState` onto ``device`` (f64
        by default: the control plane's precision contract)."""
        device = resolve_device(device)
        return cls(*[torch.as_tensor(np.asarray(getattr(st, f)), dtype=dtype)
                     .to(device) for f in cls._fields])

    def map(self, fn) -> "ChannelStateT":
        """The state with ``fn`` applied to every leaf."""
        return ChannelStateT(*[fn(x) for x in self])


def stack_states(states: Sequence[ChannelState], device="cuda",
                 dtype=torch.float64) -> ChannelStateT:
    """Stack host-drawn :class:`ChannelState` draws into one
    :class:`ChannelStateT` with a leading round axis, on ``device``.
    Stacking nests: ``stack_states`` per seed, then ``torch.stack`` leaf by
    leaf over seeds, gives (S, T, ...) leaves for the seeds x V sweep."""
    device = resolve_device(device)
    return ChannelStateT(*[
        torch.as_tensor(np.stack([np.asarray(getattr(s, f)) for s in states]),
                        dtype=dtype).to(device)
        for f in ChannelStateT._fields])


class Network:
    def __init__(self, cfg: NetworkConfig, rng: Optional[np.random.Generator] = None):
        self.cfg = cfg
        self.rng = rng or np.random.default_rng(0)
        self.h0 = 10 ** (cfg.h0_db / 10)
        self.n0 = 10 ** (cfg.noise_psd_dbm / 10) / 1000.0   # W/Hz
        # static deployment
        self.dist = self.rng.uniform(*cfg.dist_range, size=cfg.n_gateways)
        self.f_dev = self.rng.uniform(*cfg.f_dev_range, size=cfg.n_devices)
        # devices -> gateways round-robin (2 per gateway in the paper setup)
        self.assign = np.arange(cfg.n_devices) % cfg.n_gateways
        self.a = np.zeros((cfg.n_devices, cfg.n_gateways))
        self.a[np.arange(cfg.n_devices), self.assign] = 1.0

    def devices_of(self, m: int) -> np.ndarray:
        return np.where(self.assign == m)[0]

    def draw(self) -> ChannelState:
        cfg, rng = self.cfg, self.rng
        m, j = cfg.n_gateways, cfg.n_channels
        path = self.h0 * (cfg.d0 / self.dist[:, None]) ** cfg.nu
        h_up = path * rng.exponential(1.0, size=(m, j))
        h_down = path * rng.exponential(1.0, size=(m, j))
        i_up = np.abs(rng.normal(0, np.sqrt(cfg.interference_up_var), (m, j)))
        i_down = np.abs(rng.normal(0, np.sqrt(cfg.interference_down_var), (m, j)))
        e_dev = rng.uniform(0, cfg.e_dev_max, cfg.n_devices)
        e_gw = rng.uniform(0, cfg.e_gw_max, cfg.n_gateways)
        return ChannelState(h_up, h_down, i_up, i_down, e_dev, e_gw)

    # rates / delays / energies -------------------------------------------------

    def uplink_rate(self, m: int, j: int, p: float, st: ChannelState) -> float:
        cfg = self.cfg
        sinr = p * st.h_up[m, j] / (cfg.bandwidth_up * self.n0 + st.i_up[m, j])
        return cfg.bandwidth_up * np.log2(1.0 + sinr)

    def downlink_rate(self, m: int, j: int, st: ChannelState) -> float:
        cfg = self.cfg
        sinr = cfg.p_bs * st.h_down[m, j] / (cfg.bandwidth_down * self.n0 + st.i_down[m, j])
        return cfg.bandwidth_down * np.log2(1.0 + sinr)

    def uplink_time(self, m: int, j: int, p: float, gamma: float, st: ChannelState) -> float:
        """Eq. (7): model upload time."""
        r = self.uplink_rate(m, j, p, st)
        return np.inf if r <= 0 else gamma * 8.0 / r

    def downlink_time(self, m: int, j: int, gamma: float, st: ChannelState) -> float:
        """Eq. (6)."""
        r = self.downlink_rate(m, j, st)
        return np.inf if r <= 0 else gamma * 8.0 / r

    def uplink_energy(self, m: int, j: int, p: float, gamma: float, st: ChannelState) -> float:
        """Eq. (8)."""
        return p * self.uplink_time(m, j, p, gamma, st)


def draw_state(generator: torch.Generator, path: torch.Tensor,
               n_channels: int, n_devices: int, *, e_dev_max: float,
               e_gw_max: float, i_up_var: float, i_down_var: float,
               shape: tuple = ()) -> ChannelStateT:
    """``Network.draw`` with a ``torch.Generator`` (port of
    ``repro.core.network.draw_state_jax``): the same distributions
    (exponential fading on the path-loss factor, folded-normal
    interference, uniform energy arrivals), drawn on ``path``'s device
    in ``path``'s dtype with leading axes ``shape`` (one draw per round
    of a trajectory: ``shape=(rounds,)``). ``path`` is the (M,)
    per-gateway path-loss factor ``h0 * (d0 / dist)^nu``; the generator
    lives on the same device. Leaf by leaf, each over all of ``shape``.

    The stream is neither numpy's nor jax's, so this is for sweeps whose
    draws stay on the device, not for runs that replay ``Network.draw``.
    """
    m_gw = path.shape[0]
    kw = dict(generator=generator, device=path.device, dtype=path.dtype)
    mj = (*shape, m_gw, n_channels)

    def exponential():
        return torch.empty(mj, device=path.device,
                           dtype=path.dtype).exponential_(generator=generator)

    h_up = path[:, None] * exponential()
    h_down = path[:, None] * exponential()
    i_up = torch.abs(torch.randn(mj, **kw) * math.sqrt(i_up_var))
    i_down = torch.abs(torch.randn(mj, **kw) * math.sqrt(i_down_var))
    e_dev = torch.rand((*shape, n_devices), **kw) * e_dev_max
    e_gw = torch.rand((*shape, m_gw), **kw) * e_gw_max
    return ChannelStateT(h_up, h_down, i_up, i_down, e_dev, e_gw)
