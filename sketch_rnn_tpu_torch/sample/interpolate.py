"""Latent-space utilities: encode, interpolate.

The port of ``sketch_rnn_tpu/sample/interpolate.py``: the posterior mean
of a loader batch (the deterministic embedding), linear and spherical
interpolation, and a grid of latents between two ends. The interpolation
is float32 in the JAX module's association; its ``linspace`` is JAX's
bit for bit (``i * (1 / (n - 1))``, as XLA folds the division, the last
point exactly 1), so the latents agree with JAX's to float32 rounding
(``tests/test_torch_sample.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from sketch_rnn_tpu_torch.utils.device import resolve_device, tree_to


def encode_mu(model, params, batch, device=None) -> torch.Tensor:
    """Posterior mean ``[B, Nz]`` for a loader batch (``strokes [B,
    Nmax+1, 5]``, ``seq_len``), on the card unless ``device="cpu"``. The
    encoder reads the sequence without the start token, as in training,
    with no dropout."""
    dev = resolve_device(device)
    strokes = torch.as_tensor(batch["strokes"]).to(dev).transpose(0, 1)[1:]
    seq_len = torch.as_tensor(batch["seq_len"]).to(dev)
    mu, _ = model.encode(tree_to(params, dev), strokes, seq_len)
    return mu


def _f32(z) -> torch.Tensor:
    return torch.as_tensor(z, dtype=torch.float32)


def lerp(z0, z1, t):
    return (1.0 - t) * z0 + t * z1


def slerp(z0, z1, t) -> torch.Tensor:
    """Spherical interpolation (canonical for VAE latents on ~N(0,I))."""
    z0, z1 = _f32(z0), _f32(z1)
    t = torch.as_tensor(t, dtype=torch.float32, device=z0.device)
    dot = torch.sum(z0 * z1) / (torch.linalg.norm(z0)
                                * torch.linalg.norm(z1))
    omega = torch.arccos(torch.clamp(dot, -1.0 + 1e-7, 1.0 - 1e-7))
    so = torch.sin(omega)
    return torch.where(
        so < 1e-6,
        lerp(z0, z1, t),
        (torch.sin((1.0 - t) * omega) / so) * z0
        + (torch.sin(t * omega) / so) * z1)


def linspace(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, n)`` in float32: ``i * (1 / (n - 1))``
    (XLA turns the division by the constant into that product), the last
    point exactly 1."""
    if n == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    inv = float(np.float32(1.0) / np.float32(n - 1))
    steps = torch.arange(n - 1, dtype=torch.float32, device=device) * inv
    return torch.cat([steps, torch.ones((1,), dtype=torch.float32,
                                        device=device)])


def interpolate_latents(z0, z1, n: int = 10, mode: str = "slerp"
                        ) -> torch.Tensor:
    """``n`` latents from z0 to z1 inclusive, stacked ``[n, Nz]``."""
    if mode not in ("slerp", "lerp"):
        raise ValueError(f"mode must be slerp|lerp, got {mode!r}")
    z0, z1 = _f32(z0), _f32(z1)
    f = slerp if mode == "slerp" else lerp
    return torch.stack([f(z0, z1, t) for t in linspace(n, z0.device)])
