"""Batched DDSRA control plane: the numpy Algorithm 1 as torch float64 over
an explicit lane axis (port of ``repro.core.ddsra_jax``).

``repro_torch.core.ddsra`` is the host-side oracle: Python loops over every
(gateway m, channel j) pair, 40-trip scalar bisections for the partition /
frequency / power sub-problems (21)-(24), and a Python Kuhn-Munkres per
lambda cap for the channel assignment (26)-(29). This module is the same
algorithm as tensor programs:

* every function takes a leading lane axis ``B`` (a stepwise round is
  ``B = 1``, a seeds x V sweep ``B = S * V``) and solves all B x M x J
  (lane, gateway, channel) pairs at once, in place of the reference's
  ``vmap``;
* every bisection is a fixed-trip loop (the oracle's lo/hi/mid
  trajectory, infeasibility carried as a sticky mask instead of an early
  ``return None``), so the solve is branch-free;
* the lambda-cap sweep solves the assignment at all M * J caps at once with
  the batched Hungarian (:func:`repro_torch.core.hungarian.
  assign_channels_t`) and replays the oracle's first-wins /
  1e-12-improvement pick by pointer doubling;
* nothing in a round reads a tensor on the host, so on CUDA one round over
  all of a plan's lanes is captured once as a ``torch.cuda.CUDAGraph``
  per lane count and replayed every round (the counterpart of the
  reference's one compile per network shape;
  :data:`repro_torch.graphs.CAPTURE_COUNTS`). On
  the CPU the same functions run eagerly.

Precision: the oracle is float64 and the bisections resolve constraint
boundaries far below float32's grid, so the control plane is float64 on
its device whatever the data plane's dtype. Parity with the oracle and
with the reference (identical assignments, selected sets and cuts, Lambda
and tau within 1e-6, queues bit-identical for identical selections) is
held in ``tests/test_torch_ddsra_batched.py``.

Ragged shop floors are padded: per-gateway device vectors are (M, n_max)
with a validity mask; padded lanes carry ``kd = 0`` and are masked out of
every reduction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.ddsra import (GatewaySolution, RoundDecision, Workload,
                                    _PSI, _cum)
from repro_torch.core.hungarian import assign_channels_t
from repro_torch.core.lyapunov import update_queues_t
from repro_torch.core.network import (ChannelState, ChannelStateT, Network,
                                      draw_state)
from repro_torch.graphs import GraphedStep, scan_rounds

_BCD_ITERS = 4        # block-coordinate descent sweeps (oracle: bcd_iters)
_PART_ITERS = 40      # bisection trips for (21), (22), (23)/(24)
_FREQ_ITERS = 40
_POW_ITERS = 60
_INF = math.inf


class _Cfg(NamedTuple):
    """NetworkConfig scalars (host floats) the round reads directly."""
    phi_gw: float
    f_gw_max: float
    g_dev_max: float
    g_gw_max: float
    p_max: float
    p_bs: float
    b_up: float
    b_down: float
    noise_up: float         # b_up * n0
    noise_down: float       # b_down * n0
    e_dev_max: float
    e_gw_max: float
    i_up_var: float
    i_down_var: float


class _Statics(NamedTuple):
    """Per-(workload, network) tensors on the plan's device: everything the
    round solve reads. The per-device coefficients are formed on the host
    in numpy, in the oracle's order of operations, so they carry the
    oracle's exact values; divisions in the round divide by tensors (a
    CUDA division by a host scalar multiplies by its reciprocal)."""
    cfg: _Cfg
    tot_f: float
    cumf: torch.Tensor      # (L+1,) cumulative FLOPs prefix
    cumg: torch.Tensor      # (L+1,) cumulative memory prefix
    ftail: torch.Tensor     # (L+1,) tot_f - cumf: FLOPs above each cut
    gw_work: torch.Tensor   # (L+1,) ftail / phi_gw: gateway cycles a sample
    cuts1: torch.Tensor     # (L+1,) int64 1..L+1: a cut's index plus one
    # indexed by "last ok cut plus one" (0: none ok, which the oracle's
    # ``big_l - argmax`` reads as L): the cut, and ftail and gtail at it
    cut_of: torch.Tensor    # (L+2,) int64
    ftail_m: torch.Tensor   # (L+2,)
    gtail_m: torch.Tensor   # (L+2,)
    gamma8: torch.Tensor    # () model size in bits
    f_gw_max: torch.Tensor  # () f_gw_max, as a divisor
    kd: torch.Tensor        # (M, n_max) K * d_tilde, 0 on padded lanes
    valid: torch.Tensor     # (M, n_max) bool
    invalid: torch.Tensor   # (M, n_max) bool, ~valid
    phi_f_dev: torch.Tensor  # (M, n_max) phi_dev * f_dev
    e_dev_coef: torch.Tensor  # (M, n_max) kd * v_dev / phi_dev
    e_grid_coef: torch.Tensor  # (M, n_max) kd * v_dev / phi_dev * f_dev**2
    f_dev2: torch.Tensor    # (M, n_max) f_dev ** 2
    e_gw_coef: torch.Tensor  # (M, n_max) kd * v_gw / phi_gw
    kd_v_gw: torch.Tensor   # (M, n_max) kd * v_gw
    t_dev_grid: torch.Tensor  # (M, n_max, L+1) cumf / (phi_dev * f_dev)
    n_loc: torch.Tensor     # (M,) devices per gateway (float)
    kd_max: torch.Tensor    # (M,) max of kd over the gateway's devices
    phi_f_dev_min: torch.Tensor  # (M,) phi_dev * min f_dev
    f_gw0: torch.Tensor     # (M,) f_gw_max / max(n_loc, 1)
    f_floor: torch.Tensor   # (M,) f_gw_min / max(n_loc, 1)
    f_floor_hi: torch.Tensor  # (M,) max(f_floor, 1e3)
    dev_idx: torch.Tensor   # (M, n_max) int64 device index, 0 on padding
    path: torch.Tensor      # (M,) path-loss factor for the device draw


class RoundContextT(NamedTuple):
    """Tensor twin of ``repro_torch.core.schedulers.RoundContext``: the
    per-round scheduling inputs the batched round reads, per lane."""
    queues: torch.Tensor       # (B, M) virtual-queue backlog Q_m(t)
    gamma_rates: torch.Tensor  # (M,) participation-rate targets
    v: torch.Tensor            # (B,) Lyapunov trade-off weight


class DecisionArrays(NamedTuple):
    """Raw per-round DDSRA solver outputs, padded-dense over (B, M, J[,
    n_max]). :meth:`DDSRAPlan.round` repackages them as the oracle's
    :class:`RoundDecision` for the stepwise host path."""
    feasible: torch.Tensor     # (B, M, J) bool
    lam: torch.Tensor          # (B, M, J) round delay (inf = infeasible)
    l: torch.Tensor            # (B, M, J, n_max) int64 partition points
    f_gw: torch.Tensor         # (B, M, J, n_max) gateway frequency split
    p_tx: torch.Tensor         # (B, M, J) transmit power
    e_dev: torch.Tensor        # (B, M, J, n_max) device energy used
    e_gw: torch.Tensor         # (B, M, J) gateway energy used
    eye: torch.Tensor          # (B, M, J) channel assignment indicator
    selected: torch.Tensor     # (B, M) bool participation
    tau: torch.Tensor          # (B,) round delay
    queues: torch.Tensor       # (B, M) post-update queues (Eq. 14)


class RoundDecisionT(NamedTuple):
    """The resolved schedule as tensors (port of ``repro.core.ddsra_jax.
    RoundDecisionT``): per-device cuts scattered out of the padded lanes,
    the trained mask with infeasible selections failed out, the realized
    delay. Produced by :func:`resolve_decision_arrays` on the device and
    by ``repro_torch.fl.sim.resolve_decision`` on the host."""
    selected: torch.Tensor     # (B, M) bool scheduled participation
    trained: torch.Tensor      # (B, M) bool actually-training gateways
    l_dev: torch.Tensor        # (B, N) int64 per-device partition points
    gw_delay: torch.Tensor     # (B, M) per-gateway delay (0 if not trained)
    delay: torch.Tensor        # (B,) realized delay (max over trained)
    tau: torch.Tensor          # (B,) scheduler-reported round delay
    failures: torch.Tensor     # (B,) int64 infeasible selections
    queues: torch.Tensor       # (B, M) post-update queues


# ---------------------------------------------------------------------------
# masked reductions over the padded device lane (the last axis), with the
# padded lanes' mask ``invalid``; a constant goes in by masked_fill (a
# Python scalar in torch.where becomes a tensor: one more launch)
# ---------------------------------------------------------------------------


def _msum(x, invalid):
    return x.masked_fill(invalid, 0.0).sum(-1)


def _mmax(x, invalid):
    return x.masked_fill(invalid, -_INF).amax(-1)


def _mmin(x, invalid):
    return x.masked_fill(invalid, _INF).amin(-1)


def _mall(cond, invalid):
    return (cond | invalid).all(-1)


# ---------------------------------------------------------------------------
# link model (network.py's rate/time/energy on tensors)
# ---------------------------------------------------------------------------


# A rate is b * log2(1 + sinr) with sinr >= 0 (powers, gains and
# interference are non-negative), so it is +0 or positive, and
# ``gamma8 / r`` is already the reference's inf where r <= 0.


def _uplink_time(c: _Cfg, gamma8, p, h, i_up):
    return gamma8 / (c.b_up * torch.log2(1.0 + p * h / (c.noise_up + i_up)))


def _uplink_energy(c: _Cfg, gamma8, p, h, i_up):
    return p * _uplink_time(c, gamma8, p, h, i_up)


def _downlink_time(c: _Cfg, gamma8, h, i_down):
    return gamma8 / (c.b_down
                     * torch.log2(1.0 + c.p_bs * h / (c.noise_down + i_down)))


# ---------------------------------------------------------------------------
# inner solvers over all (lane, gateway, channel) pairs: fixed-trip
# bisections. Pair tensors are (B, M, J), device-lane tensors (B, M, J,
# n_max) or broadcastable to it; statics enter as (1, M, 1, n_max).
# ---------------------------------------------------------------------------


def _bisect(feasible, lo, hi, best, iters: int):
    """The oracle's bisection: keep the feasible side, carry the last
    feasible payload (one value per device lane). ``best`` must be
    ``feasible(hi)``'s payload."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok, sol = feasible(mid)
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
        best = torch.where(ok[..., None], sol, best)
    return best


def _lane(x):
    """A per-(gateway, device) static as (1, M, 1, n_max[, ...])."""
    return x[None, :, None]


def _partition_static(s: _Statics, e_dev):
    """The per-device bounds of sub-problem (21) from C7' (memory) and C10'
    (energy), which no BCD sweep changes: (feasible (B, M, 1), whether
    each cut is within them (B, M, 1, n_max, L+1))."""
    c = s.cfg
    mem_ok = s.cumg <= c.g_dev_max                              # (L+1,)
    e_grid = _lane(s.e_grid_coef)[..., None] * s.cumf
    ok_static = mem_ok & (e_grid <= e_dev[..., None])
    static_ok = _mall(ok_static.any(-1), _lane(s.invalid))
    # the oracle caps each device's cut at its last statically ok cut
    # (L where none is): the cuts above it are barred
    last1 = s.cut_of[(ok_static * s.cuts1).amax(-1)] + 1
    return static_ok, s.cuts1 > last1[..., None]


def _solve_partition(s: _Statics, static, f_gw, e_gw_budget):
    """Sub-problem (21): bisection on eta; returns (feasible, l per lane).

    A cut outside the static bounds gets time NaN, which no eta reaches;
    "some cut meets eta" for every device is "the largest of the devices'
    fastest allowed cuts meets eta"; the gateway's memory and energy
    sums gather from tables masked on padded lanes."""
    c = s.cfg
    invalid = _lane(s.invalid)
    static_ok, barred = static
    gw_t = f_gw.mul(c.phi_gw).clamp_min(1e-9)
    t_grid = _lane(s.kd)[..., None] * (
        _lane(s.t_dev_grid) + s.ftail / gw_t[..., None])
    slowest = _mmax(t_grid.masked_fill(barred, _INF).amin(-1), invalid)
    t_grid = t_grid.masked_fill(barred, torch.nan)
    # the gateway's memory and training energy at every cut, stacked, and
    # their budgets: (B, M, J, n_max, 2, L+2) and (B, M, J, 2)
    e_tab = (_lane(s.e_gw_coef) * f_gw ** 2)[..., None] * s.ftail_m
    tabs = torch.stack(torch.broadcast_tensors(s.gtail_m, e_tab), -2)
    tabs = tabs.masked_fill(invalid[..., None, None], 0.0)
    budgets = torch.stack(torch.broadcast_tensors(
        torch.full_like(e_gw_budget, c.g_gw_max), e_gw_budget), -1)

    def feasible(eta):
        """Largest cut per device with time <= eta (as that cut plus one),
        then joint C8'/C9'."""
        last1 = ((t_grid <= eta[..., None, None]) * s.cuts1).amax(-1)
        used = tabs.gather(-1, last1[..., None, None].expand(
            *last1.shape, 2, 1)).sum((-3, -1))
        ok = (slowest <= eta) & (used <= budgets).all(-1)
        return ok, last1

    lo = torch.zeros_like(e_gw_budget)
    hi = (s.kd_max[None, :, None] * s.tot_f / torch.minimum(
        s.phi_f_dev_min[None, :, None],
        _mmin(f_gw, invalid).clamp_min(1e-9).mul(c.phi_gw)))
    ok_hi, best0 = feasible(hi)
    best = _bisect(feasible, lo, hi, best0, _PART_ITERS)
    return static_ok & ok_hi, s.cut_of[best]


def _solve_frequency(s: _Statics, l, e_gw_budget):
    """Sub-problem (22): bisection on theta; returns (feasible, f per
    lane)."""
    c = s.cfg
    kd, invalid = _lane(s.kd), _lane(s.invalid)
    dev_t = s.cumf[l] / _lane(s.phi_f_dev)      # per-sample device time
    gw_work = s.gw_work[l]                      # cycles on gateway
    all_on_device = _mall(gw_work <= 0, invalid)
    f_floor = s.f_floor[None, :, None, None]
    e_coef = _lane(s.kd_v_gw) * gw_work

    def f_of(theta):
        denom = theta[..., None] / kd - dev_t   # padded: kd=0 -> +inf
        denom_ok = _mall(denom > 0, invalid)
        f = (gw_work / denom).clamp_min(0.0).masked_fill(invalid, 0.0)
        sum_ok = f.sum(-1) <= c.f_gw_max
        e = _msum(e_coef * f ** 2, invalid)
        return denom_ok & sum_ok & (e <= e_gw_budget), f

    lo = _mmax(kd * (dev_t + gw_work / s.f_gw_max), invalid)
    hi = _mmax(kd * (dev_t + gw_work / s.f_floor_hi[None, :, None, None]),
               invalid)
    hi = torch.maximum(hi, lo * 4 + 1.0)
    ok_hi, best0 = f_of(hi)
    best = _bisect(f_of, lo, hi, best0, _FREQ_ITERS)

    feas = all_on_device | ok_hi
    f = torch.where(all_on_device[..., None],
                    f_floor.masked_fill(invalid, 0.0), best)
    return feas, f


def _solve_power(s: _Statics, h_up, i_up, e_budget):
    """(23)/(24): largest transmit power whose upload energy fits.

    Opposite bisection direction from (21)/(22): a feasible mid *raises*
    ``lo`` (we want the largest feasible power), and ``lo`` is returned."""
    c = s.cfg

    def fits(p):
        return _uplink_energy(c, s.gamma8, p, h_up, i_up) <= e_budget

    p_max = torch.full_like(e_budget, c.p_max)
    lo, hi = torch.zeros_like(e_budget), p_max
    for _ in range(_POW_ITERS):
        mid = 0.5 * (lo + hi)
        ok = fits(mid)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    p = torch.where(fits(p_max), p_max, lo)
    return p.masked_fill(e_budget <= 0, 0.0)


def _solve_gateway(s: _Statics, e_dev, e_gw_m, h_up, h_down, i_up, i_down):
    """Full BCD for every (lane, m, j): the batched twin of
    ``solve_gateway``. ``e_dev`` is (B, M, 1, n_max) (inf on padding),
    ``e_gw_m`` (B, M, 1), the channel tensors (B, M, J).

    All carries are frozen the moment a sub-solve fails (sticky ``feas``
    mask), mirroring the oracle's early ``return infeasible``."""
    c = s.cfg
    invalid = _lane(s.invalid)
    pairs = h_up.shape
    lanes = (*pairs, s.kd.shape[-1])

    feas = (s.n_loc[None, :, None] > 0).expand(pairs)
    l = torch.zeros(lanes, dtype=torch.long, device=h_up.device)
    f_gw = s.f_gw0[None, :, None, None].expand(lanes)
    p_tx = torch.full_like(h_up, c.p_max)
    e_tra_gw = torch.zeros_like(h_up)
    static = _partition_static(s, e_dev)

    for _ in range(_BCD_ITERS):
        e_up = _uplink_energy(c, s.gamma8, p_tx, h_up, i_up)
        e_budget = e_gw_m - e_up
        ok_l, l_new = _solve_partition(s, static, f_gw, e_budget)
        ok_l = feas & ok_l
        l = torch.where(ok_l[..., None], l_new, l)
        ok_f, f_new = _solve_frequency(s, l_new, e_budget)
        ok_f = ok_l & ok_f
        f_cand = f_new.clamp_min(1e3)
        f_gw = torch.where(ok_f[..., None], f_cand, f_gw)
        e_tra_new = _msum(_lane(s.e_gw_coef) * s.ftail[l_new]
                          * f_cand ** 2, invalid)
        e_tra_gw = torch.where(ok_f, e_tra_new, e_tra_gw)
        p_new = _solve_power(s, h_up, i_up, e_gw_m - e_tra_new)
        ok_p = ok_f & (p_new > 0)
        p_tx = torch.where(ok_p, p_new, p_tx)
        feas = ok_p

    # Lambda_{m,j} (18) and the emitted resources
    cl = s.cumf[l]
    t_dev = cl / _lane(s.phi_f_dev)
    top = s.ftail[l]
    t_gw = (top / f_gw.mul(c.phi_gw).clamp_min(1e-9)).masked_fill(top <= 0,
                                                                   0.0)
    t_train = _mmax(_lane(s.kd) * (t_dev + t_gw), invalid)
    lam = (t_train + _uplink_time(c, s.gamma8, p_tx, h_up, i_up)
           + _downlink_time(c, s.gamma8, h_down, i_down))
    lam = lam.masked_fill(~feas, _INF)
    e_dev_used = _lane(s.e_dev_coef) * cl * _lane(s.f_dev2)
    e_gw_used = e_tra_gw + _uplink_energy(c, s.gamma8, p_tx, h_up, i_up)
    return feas, lam, l, f_gw, p_tx, e_dev_used, e_gw_used


# ---------------------------------------------------------------------------
# channel assignment (26)-(29): the batched Hungarian over the lambda caps
# ---------------------------------------------------------------------------


def _first_wins(ok, obj):
    """The oracle's pick over the caps in order: the first ``ok`` cap, then
    each later ``ok`` cap whose objective beats the current pick's by more
    than 1e-12. Returns (index (B,), found (B,)).

    Each cap's successor in that chain is a function of the cap alone, so
    the chain's end is found by pointer doubling: log2(K) gathers instead
    of a K-step loop."""
    k = ok.shape[-1]
    idx = torch.arange(k, device=ok.device)
    beats = (ok[:, None, :] & (obj[:, None, :] < obj[:, :, None] - 1e-12)
             & (idx > idx[:, None]))
    nxt = idx.masked_fill(~beats, k).amin(-1)
    nxt = torch.where(nxt < k, nxt, idx)         # the chain's end: itself
    for _ in range(max(1, math.ceil(math.log2(k)))):
        nxt = nxt.gather(-1, nxt)
    first = idx.masked_fill(~ok, k).amin(-1)
    found = first < k
    best = nxt.gather(-1, first.clamp_max(k - 1)[:, None]).squeeze(-1)
    return best, found


def _assignment(lam, queues, v):
    """The oracle's cap sweep, batched: sort each lane's M*J delays
    descending (a superset of ``np.unique(...)[::-1]``: a repeated cap
    gives the identical assignment and loses the strict-improvement test),
    solve the Theta assignment at every cap with the batched Hungarian,
    and replay the first-wins / 1e-12 objective pick."""
    b, m_gw, j_ch = lam.shape
    k = m_gw * j_ch
    finite = torch.isfinite(lam)
    caps = torch.sort(lam.masked_fill(~finite, -_INF).reshape(b, k),
                      dim=-1).values.flip(-1)                      # (B, K)
    allowed = finite[:, None] & (lam[:, None] <= caps[..., None, None]
                                 + 1e-12)                        # (B,K,M,J)
    theta = (-queues)[:, None, :, None].expand(b, k, m_gw, j_ch).masked_fill(
        ~allowed, _PSI)
    # a feasible assignment needs >=1 allowed gateway per channel
    ch_ok = allowed.any(-2).all(-1)
    eyes = assign_channels_t(theta)
    picked = eyes > 0
    banned = (picked & ~allowed).flatten(-2).any(-1)
    tau = lam[:, None].masked_fill(~picked, -_INF).flatten(-2).amax(-1)
    obj = v[:, None] * tau - (queues[:, None] * eyes.sum(-1)).sum(-1)
    cap_ok = torch.isfinite(caps) & ch_ok & ~banned

    best, found = _first_wins(cap_ok, obj)
    eye = eyes.gather(1, best[:, None, None, None].expand(b, 1, m_gw, j_ch))
    eye = eye.squeeze(1) * found[:, None, None]
    selected = eye.sum(-1) > 0
    tau = lam.masked_fill(eye <= 0, -_INF).flatten(1).amax(-1)
    return eye, selected, tau.masked_fill(~selected.any(-1), 0.0)


# ---------------------------------------------------------------------------
# the round, its resolution and the graphed step
# ---------------------------------------------------------------------------


def _round(s: _Statics, st: ChannelStateT, ctx: RoundContextT
           ) -> DecisionArrays:
    """One whole DDSRA round over every lane of ``st`` (leaves (B, ...))."""
    e_dev = st.e_dev[:, s.dev_idx].masked_fill(s.invalid, _INF)[:, :, None]
    feas, lam, l, f_gw, p_tx, e_dev_used, e_gw_used = _solve_gateway(
        s, e_dev, st.e_gw[..., None], st.h_up, st.h_down, st.i_up,
        st.i_down)
    eye, selected, tau = _assignment(lam, ctx.queues, ctx.v)
    # Eq. (14)
    new_q = update_queues_t(ctx.queues, selected, ctx.gamma_rates)
    return DecisionArrays(feasible=feas, lam=lam, l=l, f_gw=f_gw, p_tx=p_tx,
                          e_dev=e_dev_used, e_gw=e_gw_used, eye=eye,
                          selected=selected, tau=tau, queues=new_q)


def resolve_decision_arrays(s: _Statics, out: DecisionArrays,
                            n_devices: int) -> RoundDecisionT:
    """Resolve raw solver outputs into :class:`RoundDecisionT`, the tensor
    twin of ``repro_torch.fl.sim.resolve_decision`` (port of the
    reference's ``resolve_decision_arrays``):

    * each selected gateway's channel is the argmax of its ``eye`` row;
    * a selection whose solve is infeasible (or non-finite delay) *fails*
      instead of training, counted in ``failures``;
    * the trained gateways' per-lane cuts scatter-add (int64) into the
      dense (B, N) ``l_dev`` (padded lanes carry ``dev_idx = 0`` but add
      exact zeros);
    * the realized delay is the max over trained gateways, 0 if none.
    """
    b, m_gw, _, n_max = out.l.shape
    j_star = out.eye.argmax(-1)                                  # (B, M)
    lam_sel = out.lam.gather(-1, j_star[..., None]).squeeze(-1)
    feas_sel = out.feasible.gather(-1, j_star[..., None]).squeeze(-1)
    trained = out.selected & feas_sel & torch.isfinite(lam_sel)
    failures = (out.selected & ~trained).sum(-1)
    l_sel = out.l.gather(2, j_star[:, :, None, None].expand(
        b, m_gw, 1, n_max)).squeeze(2)                        # (B, M, n)
    vals = l_sel * (s.valid & trained[..., None])
    l_dev = torch.zeros((b, n_devices), dtype=out.l.dtype,
                        device=out.l.device).scatter_add_(
        -1, s.dev_idx.reshape(1, -1).expand(b, -1), vals.reshape(b, -1))
    gw_delay = lam_sel.masked_fill(~trained, 0.0)
    delay = lam_sel.masked_fill(~trained, -_INF).amax(-1).masked_fill(
        ~trained.any(-1), 0.0)
    return RoundDecisionT(selected=out.selected, trained=trained,
                          l_dev=l_dev, gw_delay=gw_delay, delay=delay,
                          tau=out.tau, failures=failures, queues=out.queues)


def _lanes(st: ChannelStateT, t: int, v_count: int) -> ChannelStateT:
    """Round ``t`` of (S, T, ...) states, each seed's draw broadcast over
    ``v_count`` V lanes: (S * V, ...) leaves, lane ``s * V + v``."""
    return st.map(lambda x: x[:, t, None].expand(
        x.shape[0], v_count, *x.shape[2:]).reshape(-1, *x.shape[2:]))


@dataclasses.dataclass
class DDSRAPlan:
    """The batched control plane for one (Workload, Network) pair on one
    device (port of ``repro.core.ddsra_jax.DDSRAPlan``).

    Build once per simulation (``DDSRAPlan.build``); ``round(st, ...)``
    then runs the whole Algorithm 1 step as one graph replay on CUDA (one
    capture per lane count, :attr:`captures`) and repackages the outputs
    as the oracle's :class:`RoundDecision`.
    """
    statics: _Statics
    n_devices: int
    n_gateways: int
    n_channels: int
    n_max: int
    n_loc_host: np.ndarray      # (M,) int: for slicing padded lanes
    device: torch.device

    def __post_init__(self):
        self._step = GraphedStep(self._step_fn, "round")

    @classmethod
    def build(cls, w: Workload, net: Network, device="cuda") -> "DDSRAPlan":
        cfg = net.cfg
        device = torch.device(device)
        m_gw, n_dev = cfg.n_gateways, cfg.n_devices
        counts = np.bincount(net.assign, minlength=m_gw)
        n_max = max(int(counts.max()), 1)
        kd = np.zeros((m_gw, n_max))
        f_dev = np.ones((m_gw, n_max))
        valid = np.zeros((m_gw, n_max), bool)
        dev_idx = np.zeros((m_gw, n_max), np.int64)
        for m in range(m_gw):
            devs = net.devices_of(m)
            kd[m, :len(devs)] = w.k_iters * w.d_tilde[devs]
            f_dev[m, :len(devs)] = net.f_dev[devs]
            valid[m, :len(devs)] = True
            dev_idx[m, :len(devs)] = devs
        c = _Cfg(*[float(x) for x in (
            cfg.phi_gw, cfg.f_gw_max, cfg.g_dev_max, cfg.g_gw_max,
            cfg.p_max, cfg.p_bs, cfg.bandwidth_up, cfg.bandwidth_down,
            cfg.bandwidth_up * net.n0, cfg.bandwidth_down * net.n0,
            cfg.e_dev_max, cfg.e_gw_max, cfg.interference_up_var,
            cfg.interference_down_var)])
        cumf, cumg = _cum(w.flops), _cum(w.mem)
        big_l = len(cumf) - 1
        cut_of = np.concatenate([[big_l], np.arange(big_l + 1)])
        ftail, gtail = cumf[-1] - cumf, cumg[-1] - cumg
        n_loc = np.maximum(counts, 1)
        f_floor = cfg.f_gw_min / n_loc
        phi_f_dev = cfg.phi_dev * f_dev
        e_dev_coef = kd * cfg.v_dev / cfg.phi_dev

        def t(x, dtype=torch.float64):
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

        statics = _Statics(
            cfg=c, tot_f=float(cumf[-1]), cumf=t(cumf), cumg=t(cumg),
            ftail=t(ftail), gw_work=t(ftail / cfg.phi_gw),
            cuts1=t(np.arange(1, big_l + 2), torch.long),
            cut_of=t(cut_of, torch.long), ftail_m=t(ftail[cut_of]),
            gtail_m=t(gtail[cut_of]), gamma8=t(float(w.gamma) * 8.0),
            f_gw_max=t(float(cfg.f_gw_max)),
            kd=t(kd), valid=t(valid, torch.bool),
            invalid=t(~valid, torch.bool), phi_f_dev=t(phi_f_dev),
            e_dev_coef=t(e_dev_coef),
            e_grid_coef=t(e_dev_coef * f_dev ** 2), f_dev2=t(f_dev ** 2),
            e_gw_coef=t(kd * cfg.v_gw / cfg.phi_gw),
            kd_v_gw=t(kd * cfg.v_gw),
            t_dev_grid=t(cumf[None, None, :] / phi_f_dev[..., None]),
            n_loc=t(counts.astype(float)),
            kd_max=t(np.where(valid, kd, -np.inf).max(axis=1)),
            phi_f_dev_min=t(cfg.phi_dev * np.where(valid, f_dev, np.inf)
                            .min(axis=1)),
            f_gw0=t(cfg.f_gw_max / n_loc), f_floor=t(f_floor),
            f_floor_hi=t(np.maximum(f_floor, 1e3)),
            dev_idx=t(dev_idx, torch.long),
            path=t(net.h0 * (cfg.d0 / net.dist) ** cfg.nu))
        return cls(statics, n_dev, m_gw, cfg.n_channels, n_max,
                   counts.astype(int), device)

    @property
    def captures(self) -> int:
        """CUDA graphs this plan captured: one per lane count it ran."""
        return len(self._step.graphs)

    def _step_fn(self, h_up, h_down, i_up, i_down, e_dev, e_gw, queues,
                 gamma_rates, v):
        """One round over all lanes, raw and resolved: the graphed step.
        The queues come last, for :func:`scan_rounds`."""
        out = _round(self.statics,
                     ChannelStateT(h_up, h_down, i_up, i_down, e_dev, e_gw),
                     RoundContextT(queues, gamma_rates, v))
        dec = resolve_decision_arrays(self.statics, out, self.n_devices)
        return (*out[:-1], *dec[:-1], out.queues)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64)).to(self.device)

    # -- one oracle-parity round ----------------------------------------

    def round_arrays(self, st: ChannelState, queues, gamma_rates, v
                     ) -> DecisionArrays:
        """Run one round on a host-drawn ChannelState; returns the raw
        :class:`DecisionArrays` with a lane axis of 1, copied out of the
        graph's buffers."""
        got = self._step(*ChannelStateT.of(st, self.device).map(
            lambda x: x[None]), self._t(queues)[None],
            self._t(gamma_rates), self._t([v]))
        n = len(DecisionArrays._fields)
        return DecisionArrays(*[x.clone() for x in got[:n - 1]], got[-1]
                              .clone())

    def round(self, st: ChannelState, queues, gamma_rates, v
              ) -> RoundDecision:
        """Oracle-compatible round: the batched solve (B = 1) plus host
        repackaging."""
        return self.host_decision(
            self.round_arrays(st, queues, gamma_rates, v))

    def host_decision(self, out: DecisionArrays) -> RoundDecision:
        """Lane 0 of ``out`` as the oracle's :class:`RoundDecision`, with a
        :class:`GatewaySolution` for each assigned pair."""
        out = DecisionArrays(*[x[0].cpu().numpy() for x in out])
        sols = {}
        for m, j in zip(*np.nonzero(out.eye > 0)):
            n = int(self.n_loc_host[m])
            sols[(int(m), int(j))] = GatewaySolution(
                bool(out.feasible[m, j]), float(out.lam[m, j]),
                out.l[m, j, :n].astype(int), out.f_gw[m, j, :n],
                float(out.p_tx[m, j]), out.e_dev[m, j, :n],
                float(out.e_gw[m, j]))
        selected = out.eye.sum(axis=1) > 0
        return RoundDecision(out.eye, selected, out.lam, sols,
                             float(out.tau), out.queues)

    # -- decide trajectories ----------------------------------------------

    def _scan(self, rounds: int, state_at, queues0, gamma_rates, v):
        """``rounds`` graphed rounds over ``v``'s lanes: the stacked step
        outputs, (T, B, ...) each."""
        gamma = self._t(gamma_rates)
        return scan_rounds(self._step, rounds,
                           lambda t, q: (*state_at(t), q, gamma, v), queues0)

    def decide_scan(self, states: ChannelStateT, queues, gamma_rates, v
                    ) -> RoundDecisionT:
        """The whole decide trajectory over ``states`` (leaves with a
        leading round axis, host-drawn so the numpy channel stream is
        kept), one graph replay a round; returns the stacked resolved
        :class:`RoundDecisionT`, every leaf with a leading (rounds,) axis,
        on the plan's device."""
        states = states.map(lambda x: x.to(self.device, torch.float64))
        outs = self._scan(states.h_up.shape[0],
                          lambda t: states.map(lambda x: x[t, None]),
                          self._t(queues)[None], gamma_rates,
                          self._t([v]))
        return RoundDecisionT(*[x[:, 0] for x in self.resolved(outs)])

    @staticmethod
    def resolved(outs) -> RoundDecisionT:
        """The resolved decisions among a scan's stacked step outputs."""
        return RoundDecisionT(*outs[len(DecisionArrays._fields) - 1:])

    def sweep_states(self, states: ChannelStateT, gamma_rates, v_values,
                     queues=None):
        """seeds x V sweep over host-drawn channel trajectories: ``states``
        leaves carry leading (seeds, rounds) axes; all V lanes of a seed
        share its channel draws (the fair-sweep contract). One graph over
        the S * V lanes, replayed once a round. Returns numpy (taus,
        selected, queues) shaped (seeds, len(v_values), rounds[, M])."""
        states = states.map(lambda x: x.to(self.device, torch.float64))
        n_seeds, rounds = states.h_up.shape[:2]
        v_count = len(v_values)
        q0 = np.zeros(self.n_gateways) if queues is None else queues
        outs = self._scan(rounds, lambda t: _lanes(states, t, v_count),
                          self._t(q0)[None].expand(n_seeds * v_count, -1),
                          gamma_rates, self._t(v_values).repeat(n_seeds))
        return self._sweep_out(outs, n_seeds, v_count)

    def _sweep_out(self, outs, n_seeds: int, v_count: int):
        """(taus, selected, queues) of a lane scan as numpy (S, V, T[,
        M])."""
        f = DecisionArrays._fields
        rounds = outs[0].shape[0]

        def grid(x):
            x = x.reshape(rounds, n_seeds, v_count, *x.shape[2:])
            return x.movedim(0, 2).cpu().numpy()

        return (grid(outs[f.index("tau")]), grid(outs[f.index("selected")]),
                grid(outs[-1]))

    def simulate_v_sweep(self, generator: Optional[torch.Generator],
                         gamma_rates, v_values, rounds: int):
        """DDSRA runs over V with the channel draws on the device
        (:func:`repro_torch.core.network.draw_state`, from ``generator``, a
        ``torch.Generator`` on the plan's device; ``None`` seeds one with
        0): (taus, selected) of shape (len(v_values), rounds[, M]). All V
        lanes share each round's draw (the fair-sweep contract), so the
        trade-off curve isolates V. The same as :meth:`sweep_states` over
        one seed's trajectory of those draws."""
        s = self.statics
        c = s.cfg
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        states = draw_state(generator, s.path, self.n_channels,
                            self.n_devices, e_dev_max=c.e_dev_max,
                            e_gw_max=c.e_gw_max, i_up_var=c.i_up_var,
                            i_down_var=c.i_down_var, shape=(1, rounds))
        taus, sel, _ = self.sweep_states(states, gamma_rates, v_values)
        return taus[0], sel[0]
