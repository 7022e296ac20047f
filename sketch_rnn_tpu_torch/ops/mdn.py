"""Mixture-density-network head.

The port of ``get_mixture_params`` from ``sketch_rnn_tpu/ops/mdn.py``.
The raw projection's layout is ``[pen(3) | logits | mu1 | mu2 | ls1 |
ls2 | rho]``, each block ``M`` wide. The losses come with the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MixtureParams(NamedTuple):
    """Per-step GMM + pen parameters; leading dims are arbitrary."""

    log_pi: torch.Tensor      # [..., M] log mixture weights (normalized)
    mu1: torch.Tensor         # [..., M]
    mu2: torch.Tensor         # [..., M]
    log_s1: torch.Tensor      # [..., M] log std of dx
    log_s2: torch.Tensor      # [..., M] log std of dy
    rho: torch.Tensor         # [..., M] correlation in (-1, 1)
    pen_logits: torch.Tensor  # [..., 3]


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``'s association: ``shifted - log(sum(exp(
    shifted)))`` with ``shifted = x - max(x)``."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s association: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def get_mixture_params(raw: torch.Tensor, num_mixture: int
                       ) -> MixtureParams:
    """Split a ``[..., 6M+3]`` projection into normalized GMM parameters."""
    m = num_mixture
    if raw.shape[-1] != 6 * m + 3:
        raise ValueError(
            f"expected trailing dim {6 * m + 3}, got {tuple(raw.shape)}")
    body = raw[..., 3:].reshape(*raw.shape[:-1], 6, m)
    logits, mu1, mu2, ls1, ls2, rho_raw = body.unbind(dim=-2)
    return MixtureParams(
        log_pi=log_softmax(logits),
        mu1=mu1,
        mu2=mu2,
        log_s1=ls1,
        log_s2=ls2,
        rho=torch.tanh(rho_raw),
        pen_logits=raw[..., :3],
    )
