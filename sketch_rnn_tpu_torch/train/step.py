"""The train step on one device.

The port of ``sketch_rnn_tpu/train/step.py``'s single-device step
(``_make_single_step_core`` with no mesh): ``(state, batch, key) ->
(state, metrics)``. The loss and its gradients go through
``SketchRNN.loss`` with ``train=True`` (on the card, the fused training
kernels carry both RNNs forward and backward), then the hand-written
``clip -> adam`` update of ``train/state.py``. The metrics are the JAX
package's: ``loss``, ``recon``, ``offset_nll``, ``pen_ce``, ``kl``,
``kl_raw``, ``kl_weight``, ``grad_norm`` and ``lr``, as 0-dim tensors on
the device (reading them is the caller's choice, and a host sync).

Requests this slice does not serve raise, naming the later slice
(:func:`check_trainable`).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.train.schedules import kl_weight_schedule, lr_schedule
from sketch_rnn_tpu_torch.train.state import (TrainState, apply_optimizer,
                                              tree_items)
from sketch_rnn_tpu_torch.utils.device import resolve_device

Metrics = Dict[str, torch.Tensor]
StepFn = Callable[..., Tuple[TrainState, Metrics]]

_NEXT = "comes with the next slice of the PyTorch port"
_LATER = "comes with a later slice of the PyTorch port"


def check_trainable(hps: HParams) -> None:
    """Refuse, by name, the training requests this slice does not serve."""
    if hps.compute_dtype != "float32" or hps.fused_residual_dtype != \
            "float32":
        raise NotImplementedError(
            f"compute_dtype={hps.compute_dtype}, fused_residual_dtype="
            f"{hps.fused_residual_dtype}: bfloat16 training {_NEXT}; train "
            f"with compute_dtype=float32,fused_residual_dtype=float32")
    if "hyper" in (hps.dec_model, hps.enc_model):
        raise NotImplementedError(
            f"the hyper cell (fused_hyper_lstm) {_LATER}")
    if hps.dec_model == "lstm":
        raise NotImplementedError(
            f"training the lstm decoder (its fused_lstm kernel) {_NEXT}; "
            f"train dec_model=layer_norm")
    if not hps.fused_rnn:
        raise NotImplementedError(
            f"fused_rnn=false in training (its scan path draws bernoulli "
            f"dropout masks) {_LATER}; train with fused_rnn=true")
    if hps.use_input_dropout or hps.use_output_dropout:
        raise NotImplementedError(f"input and output dropout {_LATER}")
    if hps.steps_per_call > 1:
        raise NotImplementedError(
            f"steps_per_call={hps.steps_per_call} {_LATER}")
    if hps.bucket_edges:
        raise NotImplementedError(f"bucket_edges {_LATER}")
    if hps.transfer_dtype != "float32":
        raise NotImplementedError(
            f"transfer_dtype={hps.transfer_dtype} {_LATER}")


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def _with_leaves(params, leaves):
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)

    return rebuild(params)


def make_train_step(model, hps: HParams, device=None) -> StepFn:
    """Build ``step(state, batch, key) -> (state, metrics)``. ``batch`` is
    a loader dict (numpy or tensors), moved to ``device`` (the card unless
    ``device="cpu"``); ``key`` a threefry key (``utils/prng.py``)."""
    check_trainable(hps)
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch, key: torch.Tensor
                ) -> Tuple[TrainState, Metrics]:
        batch = batch_to_device(batch, dev)
        kl_w = kl_weight_schedule(hps, state.step)
        leaves = [p.detach().requires_grad_(True)
                  for _, p in tree_items(state.params)]
        params = _with_leaves(state.params, leaves)
        total, metrics = model.loss(params, batch, key, kl_w, train=True)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = _with_leaves(state.params, [
            g if g is not None else torch.zeros_like(p)
            for g, p in zip(grads, leaves)])
        new_params, opt_state, g_norm = apply_optimizer(
            hps, grads, state.opt_state, state.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = g_norm
        metrics["lr"] = lr_schedule(hps, state.step).to(dev)
        return TrainState(new_params, opt_state, state.step + 1), metrics

    return step_fn
