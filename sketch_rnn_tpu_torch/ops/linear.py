"""Parameter initializers and the dense helpers every cell shares.

The port of ``sketch_rnn_tpu/ops/linear.py``. Initializers draw from an
explicit ``torch.Generator`` on the CPU (so a seed gives the same
weights whatever device they are moved to); they are not bitwise
``jax.random``'s, which is why the tests carry JAX-made weights across
with ``convert.params_from_jax`` instead.
"""

from __future__ import annotations

import math

import torch


def orthogonal(gen: torch.Generator, shape) -> torch.Tensor:
    """Orthogonal init (recurrent weights)."""
    if len(shape) < 2:
        raise ValueError("orthogonal init needs >=2 dims")
    rows, cols = math.prod(shape[:-1]), shape[-1]
    n = max(rows, cols)
    a = torch.randn((n, n), generator=gen, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q[:rows, :cols].reshape(shape).contiguous()


def xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -lim, lim, generator=gen)


def normal_init(gen: torch.Generator, shape, stddev: float
                ) -> torch.Tensor:
    return stddev * torch.randn(shape, generator=gen, dtype=torch.float32)


def matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype=None
           ) -> torch.Tensor:
    """``x @ w`` in float32; with ``compute_dtype`` the operands are first
    rounded to it (products of the rounded values, f32 accumulation)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    return torch.matmul(x, w)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the trailing axis: biased variance, ``rsqrt``."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta
