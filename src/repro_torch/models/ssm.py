"""Mamba-2 SSD (state-space duality) block, sequence mode and decode step
(port of ``repro.models.ssm``).

Follows arXiv:2405.21060: within a chunk the quadratic (attention-like)
dual form, across chunks a linear recurrence on the carried state.

Slot-batched like every block of the port: x is ``(S, B, seq, D)`` and
each parameter is per slot (a leading ``S`` axis; a stride-0 expanded view
when every slot shares it). B/C projections are shared across heads
(n_groups = 1). Routing mirrors the reference's: on the card the scan goes
through the SSD op (:mod:`repro_torch.kernels.ssd_scan.ops`, the CUDA
kernel forward); CPU tensors take :func:`ssd_chunked`, the reference's own
path off the TPU (its ``default_impl() == "ref"``). The decode step
(:func:`mamba_step`, one token of one model, no slot axis) runs the
single-token recurrence :func:`ssd_step` in plain torch on both devices,
as the reference does outside any kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import decay_rates
from repro_torch.models.layers import rms_norm, slot_bcast, slot_mm


def _split_proj(x, params, cfg: ArchConfig):
    d_in = cfg.ssm.d_inner(cfg.d_model)
    z, xin = torch.split(slot_mm(x, params["w_xz"]), d_in, dim=-1)
    b_ssm, c_ssm = torch.chunk(slot_mm(x, params["w_bc"]), 2, dim=-1)
    dt = F.softplus(slot_mm(x, params["w_dt"]).float()
                    + slot_bcast(params["dt_bias"], x.dim()).float())
    return z, xin, b_ssm, c_ssm, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (S, B, seq, C), w (S, K, C), b (S, C)."""
    k, seq = w.shape[1], x.shape[-2]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[..., i:i + seq, :] * slot_bcast(w[:, i], x.dim())
              for i in range(k))
    return F.silu(out + slot_bcast(b, x.dim()))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in plain PyTorch.

    xh (B,S,n,p); dt (B,S,n) fp32; a_log (n,) or (G, n) per slot of B // G
    rows; b_ssm/c_ssm (B,S,ds). Returns (y (B,S,n,p), final state
    (B,n,ds,p)).
    """
    bsz, s, n, p = xh.shape
    ds = b_ssm.shape[-1]
    nc, rem = divmod(s, chunk)
    if rem:
        raise ValueError(f"seq {s} is not a multiple of chunk {chunk}")
    a = decay_rates(a_log, bsz)                     # (n,) or (B, n)
    a = a if a.dim() == 1 else a[None, :, None, :]

    def rs(t, extra):  # (B,S,...) -> (NC, B, chunk, ...)
        return t.reshape(bsz, nc, chunk, *extra).transpose(0, 1)

    xc = rs(xh, (n, p))
    dtc = rs(dt, (n,))
    bcs = rs(b_ssm, (ds,))
    ccs = rs(c_ssm, (ds,))

    adt = dtc * a                                   # (NC,B,Q,n) log-decay
    cum = torch.cumsum(adt, dim=2)                  # inclusive cumsum

    # intra-chunk dual (quadratic) term
    qpos = torch.arange(chunk, device=xh.device)
    causal = qpos[:, None] >= qpos[None, :]
    scores = torch.einsum("cbqs,cbks->cbqk", ccs, bcs)
    # exp(cum_q - cum_k) where q >= k, else 0: the exponent is masked to
    # -inf before the exp (the reference zeroes the exp's result after it,
    # the same values). Above the diagonal cum_q - cum_k grows with the
    # chunk; over 256 steps it overflows exp, and inf's gradient times the
    # mask's 0 would be NaN
    ldec = torch.exp(torch.where(
        causal[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))
    w = scores[..., None] * ldec
    w = w * dtc[:, :, None, :, :]                   # * dt_k
    y_intra = torch.einsum("cbqkn,cbknp->cbqnp", w.to(xh.dtype), xc)

    # per-chunk end states
    wk = torch.exp(cum[:, :, -1:, :] - cum) * dtc   # (NC,B,Q,n)
    states = torch.einsum("cbks,cbkn,cbknp->cbnsp", bcs, wk.to(xh.dtype), xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])       # (NC,B,n)

    h = torch.zeros((bsz, n, ds, p), dtype=torch.float32, device=xh.device)
    y_inter = []
    for ci in range(nc):
        # inter-chunk contribution, using the state *before* this chunk
        y_inter.append(torch.einsum("bqs,bnsp,bqn->bqnp", ccs[ci],
                                    h.to(xh.dtype),
                                    torch.exp(cum[ci]).to(xh.dtype)))
        h = h * chunk_decay[ci][..., None, None] + states[ci].float()
    y = y_intra + torch.stack(y_inter)              # (NC,B,Q,n,p)
    return y.transpose(0, 1).reshape(bsz, s, n, p), h


def mamba_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                cfg: ArchConfig) -> torch.Tensor:
    """Full Mamba-2 block, sequence mode: x (S, B, seq, D) -> same shape."""
    s_cfg = cfg.ssm
    d_in = s_cfg.d_inner(cfg.d_model)
    n, p, ds = s_cfg.n_heads(cfg.d_model), s_cfg.head_dim, s_cfg.d_state
    seq = x.shape[-2]

    z, xin, b_ssm, c_ssm, dt = _split_proj(x, params, cfg)
    conv_in = torch.cat([xin, b_ssm, c_ssm], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    xin, b_ssm, c_ssm = torch.split(conv_out, [d_in, ds, ds], dim=-1)

    # rows = slots x batch, grouped by slot: a_log (S, n) is per slot
    xh = xin.reshape(-1, seq, n, p)
    scan = (dt.reshape(-1, seq, n), params["a_log"],
            b_ssm.reshape(-1, seq, ds), c_ssm.reshape(-1, seq, ds))
    chunk = min(s_cfg.chunk_size, seq)
    if xh.is_cuda:
        y = ssd_ops.ssd(xh, *scan, chunk=chunk)
    else:
        y, _ = ssd_chunked(xh, *scan, chunk)
    y = y.reshape(*x.shape[:-1], n, p)
    y = y + slot_bcast(params["d_skip"], y.dim() - 1)[..., None] \
        * xin.reshape(y.shape)
    y = y.reshape(*x.shape[:-1], d_in)
    y = rms_norm(y * F.silu(z), slot_bcast(params["norm"], y.dim()),
                 cfg.norm_eps)
    return slot_mm(y, params["w_out"])


def ssd_step(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_ssm: torch.Tensor, c_ssm: torch.Tensor,
             h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. xh (B,n,p); dt (B,n) f32; a_log (n,); b/c
    (B,ds); h (B,n,ds,p) f32 -> (y (B,n,p) in xh's dtype, new h f32)."""
    a = -torch.exp(a_log.float())
    dec = torch.exp(dt * a)                             # (B,n)
    upd = (dt[..., None, None] * b_ssm[:, None, :, None]
           * xh[:, :, None, :].float())
    h = h * dec[..., None, None] + upd
    y = torch.einsum("bnsp,bs->bnp", h, c_ssm.float())
    return y.to(xh.dtype), h


def mamba_step(x: torch.Tensor, params: Dict[str, torch.Tensor],
               cfg: ArchConfig, conv_state: torch.Tensor,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Decode step of one model. x (B,1,D); conv_state (B,K-1,C); h
    (B,n,ds,p) f32 -> (out (B,1,D), new conv_state (the window shifted by
    one), new h)."""
    s_cfg = cfg.ssm
    d_in = s_cfg.d_inner(cfg.d_model)
    n, p, ds = s_cfg.n_heads(cfg.d_model), s_cfg.head_dim, s_cfg.d_state
    bsz = x.shape[0]

    one_slot = {k: params[k][None] for k in ("w_xz", "w_bc", "w_dt",
                                             "dt_bias")}
    z, xin, b_ssm, c_ssm, dt = (t[0] for t in _split_proj(x[:, 0][None],
                                                          one_slot, cfg))
    conv_in = torch.cat([xin, b_ssm, c_ssm], dim=-1)            # (B,C)
    full = torch.cat([conv_state, conv_in[:, None, :]], dim=1)  # (B,K,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", full, params["conv_w"])
                      + params["conv_b"])
    xin, b_ssm, c_ssm = torch.split(conv_out, [d_in, ds, ds], dim=-1)

    xh = xin.reshape(bsz, n, p)
    y, h = ssd_step(xh, dt, params["a_log"], b_ssm, c_ssm, h)
    y = y + params["d_skip"].to(x.dtype)[:, None] * xh
    y = y.reshape(bsz, d_in)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return (y @ params["w_out"])[:, None], full[:, 1:], h
