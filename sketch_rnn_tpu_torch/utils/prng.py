"""The parts of ``jax.random`` that serving uses, in torch integer ops.

The serving engine's determinism contract is per request: step ``t`` of
a request draws ``uniform(fold_in(request_key, t), (4,))``. This module
reproduces those draws BITWISE (``tests/test_torch_prng.py``), so one
request key gives the same strokes in the JAX package and in the port.

Keys are threefry2x32 key data: two 32-bit words, ``key(seed) == [0,
seed]``. torch has no full uint32 arithmetic, so every word here is held
in an ``int64`` tensor with values in ``[0, 2**32)`` and every sum is
masked back to 32 bits. A key is a tensor of shape ``[..., 2]``; all
functions broadcast over the leading dimensions and run on whatever
device their inputs lie on.

Layouts follow ``jax.config.jax_threefry_partitionable=True`` (the
default of the JAX versions this repo runs): ``split`` and the bits of
``uniform`` hash the 64-bit iota ``(hi=0, lo=i)`` with the key, and a
32-bit draw is the XOR of the hash's two output words.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block cipher (Salmon et al. 2011) as
    ``jax.random``'s ``threefry2x32_p`` computes it; all operands are
    int64 tensors holding uint32 values (broadcastable)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for an int32 seed:
    ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64,
                        device=device)


def _as_words(data, like: torch.Tensor) -> torch.Tensor:
    d = torch.as_tensor(data, device=like.device)
    return d.to(torch.int64) & _MASK


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the key with the 2x32 counter
    ``(0, data)``. ``data`` (int or tensor) broadcasts against the key's
    leading dimensions."""
    d = _as_words(data, k)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable layout): ``[..., num, 2]``,
    subkey ``i`` being the hash of the counter ``(0, i)``."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    k = k[..., None, :]
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def uniform(k: torch.Tensor, shape: Union[int, Sequence[int]] = (4,)
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in ``[0, 1)``, float32, shape
    ``[..., *shape]``. Element ``i``'s 32 random bits are the XOR of the
    two words hashed from the counter ``(0, i)`` (partitionable layout);
    their top 23 bits become the mantissa of a float in ``[1, 2)``, minus
    1."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    kk = k[..., None, :]
    y0, y1 = threefry2x32(kk[..., 0], kk[..., 1], torch.zeros_like(i), i)
    bits = (y0 ^ y1).reshape(*k.shape[:-1], *shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)
