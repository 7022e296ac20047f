"""The parts of ``jax.random`` that the port uses, in torch integer ops.

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

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar made on ``device`` by a fill, not copied from the
    host: inside a captured CUDA graph a host-to-device copy is refused."""
    return torch.full((), float(x), dtype=torch.float32, device=device)


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


def random_bits(k: torch.Tensor, shape: Union[int, Sequence[int]]
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words as int64), shape
    ``[..., *shape]``: element ``i``'s bits are the XOR of the two words
    hashed from the counter ``(0, i)`` (partitionable layout)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    kk = k[..., None, :]
    y0, y1 = threefry2x32(kk[..., 0], kk[..., 1], torch.zeros_like(i), i)
    return (y0 ^ y1).reshape(tuple(k.shape[:-1]) + shape)


def uniform(k: torch.Tensor, shape: Union[int, Sequence[int]] = (4,),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, shape
    ``[..., *shape]``: the top 23 of each element's random bits become
    the mantissa of a float in ``[1, 2)``, minus 1, then scaled to the
    range in float32 and held at ``minval`` or above."""
    bits = random_bits(k, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = f - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return torch.clamp_min(f, 0.0)
    lo = _f32(minval, k.device)
    hi = _f32(maxval, k.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def bernoulli(k: torch.Tensor, p: float,
              shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (mode "low", as JAX defaults): ``uniform(key, shape) < float32(p)``,
    a bool tensor of shape ``[..., *shape]``."""
    return uniform(k, shape) < _f32(np.float32(p), k.device)


def randint(k: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (), minval, maxval, jnp.int32)`` for
    ``0 <= minval < maxval <= 2**31 - 1``: a scalar int32 per key
    (``[...]``). JAX draws 32 bits from each half of ``split(key)`` and
    folds them into the span in uint32 arithmetic,
    ``((hi % span) * mult + lo % span) % span`` with ``mult = ((2**16 %
    span)**2 mod 2**32) % span`` — which wraps to 0 for spans above
    2**16, so there only ``lo`` counts."""
    if not 0 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint covers 0 <= minval < maxval <= 2**31-1, "
                         f"got [{minval}, {maxval})")
    k1, k2 = split(k, 2).unbind(dim=-2)
    hi = random_bits(k1, ())
    lo = random_bits(k2, ())
    span = maxval - minval
    mult = ((((2 ** 16) % span) ** 2) & _MASK) % span
    off = (((hi % span) * mult & _MASK) + lo % span) & _MASK
    return (minval + off % span).to(torch.int32)


# XLA's float32 erf_inv (Giles 2010): a degree-8 polynomial in
# w = -log1p(-x*x), one branch for w < 5 and one for the tails
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` as XLA lowers it (not torch.erfinv's)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, _f32(a, x.device), _f32(b, x.device))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k: torch.Tensor, shape: Union[int, Sequence[int]]
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform in ``(-1, 1)``. The uniform is
    bitwise JAX's; ``erf_inv`` follows XLA's polynomial, whose log1p and
    multiply-adds the CPU backends may round apart by an ulp
    (``tests/test_torch_prng.py`` states the tolerance)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return float(np.float32(np.sqrt(2.0))) * erfinv(u)
