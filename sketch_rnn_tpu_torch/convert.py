"""Carry parameters between the JAX package and the port.

A parameter tree of ``sketch_rnn_tpu.models.vae.SketchRNN.init_params``
(``dec/*``, ``out_w``, ``out_b``, ``enc_fwd/*``, ``enc_bwd/*``,
``mu_*``, ``presig_*``, ``dec_init_*``, ``class_embed``) with numpy
leaves maps to the port's dict of tensors with the SAME names and the
SAME layouts — ``[in, out]`` weights, ``[4, H]`` layer-norm parameters —
so no transpose hides in the conversion and the round trip is bitwise.
A training state carries across the same way, optax's Adam moments and
counts included (:func:`train_state_from_jax`, :func:`train_state_to_jax`),
so a run started in one package continues in the other. This module
never imports JAX: callers hand it numpy leaves (``jax.device_get(tree)``).
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


def train_state_from_jax(state, device=None):
    """A JAX ``TrainState(params, opt_state, step)`` with numpy leaves
    (``jax.device_get(state)``) -> the port's ``TrainState``. The optax
    state is read by position, ``(clip state, (ScaleByAdamState(count,
    mu, nu), ScaleByScheduleState(count)))``, so the same layout as
    nested tuples (what :func:`train_state_to_jax` returns) works too."""
    from sketch_rnn_tpu_torch.train.state import (AdamState, OptState,
                                                  TrainState)

    params, opt_state, step = state[0], state[1], state[2]
    adam, sched = opt_state[1][0], opt_state[1][1]
    return TrainState(
        params_from_jax(params, device),
        OptState(AdamState(int(np.asarray(adam[0])),
                           params_from_jax(adam[1], device),
                           params_from_jax(adam[2], device)),
                 int(np.asarray(sched[0]))),
        int(np.asarray(step)))


def train_state_to_jax(state):
    """The port's ``TrainState`` -> ``(params, ((), ((count, mu, nu),
    (schedule_count,))), step)`` with numpy leaves and int32 counts: the
    leaves in the order of the JAX package's optax ``TrainState``, ready
    for ``jax.tree_util.tree_unflatten`` with that state's structure."""
    adam = state.opt_state.adam
    i32 = lambda v: np.asarray(v, np.int32)
    return (params_to_jax(state.params),
            ((), ((i32(adam.count), params_to_jax(adam.mu),
                   params_to_jax(adam.nu)),
                  (i32(state.opt_state.schedule_count),))),
            i32(state.step))
