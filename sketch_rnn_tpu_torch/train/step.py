"""The train step on one device.

The port of ``sketch_rnn_tpu/train/step.py``'s single-device step
(``_make_single_step_core`` with no mesh): ``(state, batch, key) ->
(state, metrics)``. The loss and its gradients go through
``SketchRNN.loss`` with ``train=True`` (at ``fused_rnn=true`` the fused
training kernels carry both RNNs forward and backward; at
``fused_rnn=false`` the plain cell loop of ``ops/rnn.py`` does, under
autograd, with ``hps.remat``), then the hand-written
``clip -> adam`` update of ``train/state.py``. The metrics are the JAX
package's: ``loss``, ``recon``, ``offset_nll``, ``pen_ce``, ``kl``,
``kl_raw``, ``kl_weight``, ``grad_norm`` and ``lr``, as 0-dim tensors on
the device (reading them is the caller's choice, and a host sync).

The eval steps (``make_eval_step``, ``make_per_class_eval_step``) are
the JAX package's single-device eval cores: the loss with ``train=False``
(no dropout, pen CE masked, KL weight 1) plus ``weight_sum``, the batch's
count of real rows, under ``torch.no_grad`` (the fused kernels run their
forwards only).

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
EvalFn = Callable[..., Metrics]

_LATER = "comes with a later slice of the PyTorch port"


def check_trainable(hps: HParams) -> None:
    """Refuse, by name, the training requests this slice does not serve."""
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


def make_eval_step(model, hps: HParams, device=None) -> EvalFn:
    """``eval(params, batch, key) -> metrics``: the eval-mode loss's
    metrics plus ``weight_sum``, the sum of the batch's ``weights`` (its
    rows when it has none), as 0-dim tensors on ``device``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_fn(params, batch, key: torch.Tensor) -> Metrics:
        batch = batch_to_device(batch, dev)
        _, metrics = model.loss(params, batch, key, 1.0, train=False)
        if "weights" in batch:
            ws = batch["weights"].to(torch.float32).sum()
        else:
            ws = torch.tensor(float(batch["strokes"].shape[0]), device=dev)
        metrics["weight_sum"] = ws
        return metrics

    return eval_fn


def make_per_class_eval_step(model, hps: HParams, device=None) -> EvalFn:
    """``eval(params, batch, key) -> metrics`` with every metric a
    ``[num_classes]`` vector (``SketchRNN.eval_metrics_per_class``)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_fn(params, batch, key: torch.Tensor) -> Metrics:
        return model.eval_metrics_per_class(params,
                                            batch_to_device(batch, dev), key)

    return eval_fn
