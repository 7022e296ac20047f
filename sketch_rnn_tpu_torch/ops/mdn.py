"""Mixture-density-network head and the VAE losses.

The port of ``sketch_rnn_tpu/ops/mdn.py``: ``get_mixture_params`` and the
losses. The raw projection's layout is ``[pen(3) | logits | mu1 | mu2 |
ls1 | ls2 | rho]``, each block ``M`` wide. The losses keep the canonical
asymmetry: the offset GMM NLL is masked to each sequence's true length
(``fs = 1 - p3(target)``), the pen cross-entropy is unmasked in training
and masked in eval, and both are normalized by ``max_seq_len * B``
whatever the mask; the KL term has the free-bits floor. Data-parallel
``axis_name`` sums come with a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    shifted)))`` with ``shifted = x - max(x)``, the max held constant
    under differentiation as JAX holds it."""
    shifted = x - x.amax(dim=-1, keepdim=True).detach()
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


LOG_2PI = 1.8378770664093453  # log(2*pi)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis: ``max + log(sum(exp(x -
    max)))`` with a finite max (an all ``-inf`` row gives ``-inf``)."""
    mx = x.amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)).detach()
    return (mx + torch.log(torch.exp(x - mx).sum(dim=-1, keepdim=True))
            ).squeeze(-1)


def bivariate_normal_logpdf(dx: torch.Tensor, dy: torch.Tensor,
                            mp: MixtureParams) -> torch.Tensor:
    """Log pdf of (dx, dy) under each component; returns ``[..., M]``."""
    zx = (dx[..., None] - mp.mu1) * torch.exp(-mp.log_s1)
    zy = (dy[..., None] - mp.mu2) * torch.exp(-mp.log_s2)
    one_m_r2 = torch.clamp(1.0 - torch.square(mp.rho), 1e-6, 1.0)
    z = zx * zx + zy * zy - 2.0 * mp.rho * zx * zy
    return (-z / (2.0 * one_m_r2)
            - 0.5 * torch.log(one_m_r2) - mp.log_s1 - mp.log_s2 - LOG_2PI)


def gmm_nll(dx: torch.Tensor, dy: torch.Tensor, mp: MixtureParams
            ) -> torch.Tensor:
    """Negative log-likelihood of offsets under the mixture, per step."""
    return -logsumexp(mp.log_pi + bivariate_normal_logpdf(dx, dy, mp))


def reconstruction_sums(mp: MixtureParams, target: torch.Tensor,
                        mask_pen: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example time-summed ``(offset_nll, pen_ce)``, each ``[B]``;
    ``target`` is time-major stroke-5 ``[T, B, 5]``."""
    dx, dy, pen = target[..., 0], target[..., 1], target[..., 2:5]
    fs = 1.0 - pen[..., 2]  # 0 from the first end-of-sketch row onward
    nll = gmm_nll(dx, dy, mp) * fs
    pen_ce = -(pen * log_softmax(mp.pen_logits)).sum(dim=-1)
    if mask_pen:
        pen_ce = pen_ce * fs
    return nll.sum(dim=0), pen_ce.sum(dim=0)


def reconstruction_loss(mp: MixtureParams, target: torch.Tensor,
                        max_seq_len: int, mask_pen: bool = False,
                        weights: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offset-GMM NLL + pen-state CE as scalars, each divided by
    ``max_seq_len * B`` (``weights [B]`` weight each example and replace
    ``B`` by their sum)."""
    if target.shape[0] > max_seq_len:
        raise ValueError(
            f"target has {target.shape[0]} steps but max_seq_len="
            f"{max_seq_len}: the fixed normalizer would under-weight "
            f"every step; pass the model's true max_seq_len")
    nll, pen_ce = reconstruction_sums(mp, target, mask_pen)
    if weights is None:
        denom = float(max_seq_len * target.shape[1])
    else:
        w = weights.to(torch.float32)
        nll, pen_ce = nll * w, pen_ce * w
        denom = max_seq_len * torch.clamp_min(w.sum(), 1.0)
    return nll.sum() / denom, pen_ce.sum() / denom


def kl_per_example(mu: torch.Tensor, presig: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) per example (mean over latent dims), ``[B]``."""
    return -0.5 * (1.0 + presig - torch.square(mu)
                   - torch.exp(presig)).mean(dim=-1)


def kl_loss(mu: torch.Tensor, presig: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)), mean over batch and latent dims (a weighted
    batch mean with ``weights [B]``)."""
    per = kl_per_example(mu, presig)
    if weights is None:
        return per.sum() / float(per.shape[0])
    w = weights.to(torch.float32)
    return (per * w).sum() / torch.clamp_min(w.sum(), 1.0)


def kl_cost_with_floor(kl: torch.Tensor, kl_tolerance: float
                       ) -> torch.Tensor:
    """The free-bits floor: the cost saturates at ``kl_tolerance``."""
    return torch.clamp_min(kl, kl_tolerance)
