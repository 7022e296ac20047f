"""Carry parameters between the JAX package and the port.

A parameter tree of ``sketch_rnn_tpu.models.vae.SketchRNN.init_params``
(``dec/*``, ``out_w``, ``out_b``, ``enc_fwd/*``, ``enc_bwd/*``,
``mu_*``, ``presig_*``, ``dec_init_*``, ``class_embed``) with numpy
leaves maps to the port's dict of tensors with the SAME names and the
SAME layouts — ``[in, out]`` weights, ``[4, H]`` layer-norm parameters —
so no transpose hides in the conversion and the round trip is bitwise.
This module never imports JAX: callers hand it numpy leaves
(``jax.device_get(tree)``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sketch_rnn_tpu_torch.utils.device import resolve_device


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy-convertible leaves -> nested dict of tensors on
    ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(device)

    return conv(tree)


def params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's dict of tensors -> nested dict of numpy arrays (ready for
    ``jax.device_put``)."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy().copy()
