"""The parts of ``jax.random`` that the traced data plane draws with, in
torch: threefry2x32, ``PRNGKey``, ``fold_in`` and the 32-bit ``uniform``,
as JAX 0.9 computes them by default (``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``).

threefry2x32 is a pure counter hash on 32-bit words, so the draws are the
same bits on any device. Words are kept as uint32 values in int64 tensors
(torch has no uint32 arithmetic), masked to 32 bits after each add and
shift. Every function broadcasts over leading axes: one call draws for
every slot of a tier at once, on the CPU or inside a CUDA graph.

* ``prng_key(s)`` is the key (s >> 32, s & 0xFFFFFFFF): (0, s) for a
  seed below 2**32, ``jax.random.key_data(jax.random.PRNGKey(s))``;
* ``fold_in(k, d)`` is threefry(k, (0, d));
* the bits of shape (L,) are x0 ^ x1 of threefry(k, (0, iota(L)));
* ``uniform`` is bitcast((bits >> 9) | 0x3F800000) - 1, in [0, 1).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of the words (x0, x1) under the key (k0, k1):
    20 rounds in five groups of four, with a key injection before the
    first group and after each. Arguments are int64 tensors (or Python
    ints) holding uint32 values and broadcast together; returns the two
    output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & MASK
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data: a (2,) int64 tensor on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=resolve_device(device))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2) and data (...) broadcast
    together; returns keys (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data & MASK)
    return torch.stack((y0, y1), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for keys (..., 2): (..., n) uint32
    values, the xor of the two output words of threefry over the counters
    (0, i)."""
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, iota)
    return y0 ^ y1


def mantissas(key: torch.Tensor, n: int) -> torch.Tensor:
    """The 23 mantissa bits ``uniform`` keeps, (..., n) int64: ``uniform``
    is exactly ``mantissas * 2**-23``, so it orders the draws as they do."""
    return random_bits(key, n) >> 9


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float32 for keys (..., 2)."""
    bits = (mantissas(key, n) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0
