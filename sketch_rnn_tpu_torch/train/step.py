"""The train steps on one device, single and K at a call.

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

Everything a step derives from the host's counts (the KL weight and the
learning rate at ``state.step``, Adam's step size and bias corrections)
is computed on the host by :func:`step_scalars`, and everything it draws
from its key (the posterior noise, the dropout seeds) by the model's
``packed_draws``; both reach the step's tensor body as one row of one
staged tensor, copied to the card in one transfer a call
(:func:`stage_steps`). So the body reads nothing from the host and hashes
no key on the card, and :func:`make_multi_train_step` (the JAX package's
``make_multi_train_step``: K optimizer steps a call, ``steps_per_call``)
runs K bodies as one CUDA graph replay on the card (``train/graph.py``);
on the CPU, as the same body K times (the plain version). Micro-step
``i`` trains on ``batches[i]`` with ``fold_in(key, i)``, so the K call is
bit for bit K single steps with those keys; its metrics are the window's
(:func:`replay_window_metrics`).

The eval steps (``make_eval_step``, ``make_per_class_eval_step``) are
the JAX package's single-device eval cores: the loss with ``train=False``
(no dropout, pen CE masked, KL weight 1) plus ``weight_sum``, the batch's
count of real rows, under ``torch.no_grad`` (the fused kernels run their
forwards only). Their K-batch forms (``make_multi_eval_step``,
``make_multi_per_class_eval_step``, ``eval_steps_per_call``) stack every
metric ``[K, ...]``, batch ``idx[j]`` with ``fold_in(key, idx[j])``.

Requests this slice does not serve raise, naming the later slice
(:func:`check_trainable`).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.train.graph import GraphedCall
from sketch_rnn_tpu_torch.train.schedules import kl_weight_schedule, lr_schedule
from sketch_rnn_tpu_torch.train.state import (TrainState, adam_update,
                                              next_opt_state,
                                              optimizer_scalars, tree_items)
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.device import resolve_device, to_device

Metrics = Dict[str, torch.Tensor]
StepFn = Callable[..., Tuple[TrainState, Metrics]]
EvalFn = Callable[..., Metrics]

_LATER = "comes with a later slice of the PyTorch port"


def check_trainable(hps: HParams) -> None:
    """Refuse, by name, the training requests this slice does not serve."""
    if hps.use_input_dropout or hps.use_output_dropout:
        raise NotImplementedError(f"input and output dropout {_LATER}")
    if hps.bucket_edges:
        raise NotImplementedError(f"bucket_edges {_LATER}")


def host_tensors(batch) -> Dict[str, torch.Tensor]:
    """A loader batch as tensors where it lies (numpy on the host)."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in batch.items()}


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy or tensors) as tensors on ``device``."""
    return {k: v.to(device) for k, v in host_tensors(batch).items()}


def _with_leaves(params, leaves):
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)

    return rebuild(params)


def step_scalars(hps: HParams, step: int, count: int,
                 schedule_count: int) -> torch.Tensor:
    """The host values of the step at ``state.step == step`` whose
    optimizer counts are ``count`` (Adam's) and ``schedule_count``, as a
    float32 vector on the CPU: ``[kl_weight, lr, -step size, 1 - b1^c, 1
    - b2^c]`` (``train/state.optimizer_scalars`` for the last three)."""
    return torch.cat([kl_weight_schedule(hps, step).reshape(1),
                      lr_schedule(hps, step).reshape(1),
                      optimizer_scalars(hps, count, schedule_count)])


def stage_steps(model, hps: HParams, state: TrainState, keys: torch.Tensor,
                batch_size: int) -> torch.Tensor:
    """The host values of the ``K = len(keys)`` steps from ``state``,
    step ``i`` with key ``keys[i]``, as a float32 ``[K, 5 + L]`` tensor on
    the CPU: each row :func:`step_scalars` then the model's
    ``packed_draws``; :func:`train_body` takes a row apart."""
    a = state.opt_state
    scalars = torch.stack([step_scalars(hps, state.step + i,
                                        a.adam.count + i,
                                        a.schedule_count + i)
                           for i in range(keys.shape[0])])
    return torch.cat([scalars, model.packed_draws(keys.cpu(), batch_size,
                                                  True)], dim=-1)


def _batch_size(batch) -> int:
    return batch["strokes"].shape[0]


def train_body(model, hps: HParams, params, mu, nu, batch, row):
    """One train step on tensors: the loss and its gradients, then the
    update. ``row`` is the step's row of :func:`stage_steps`, on the
    parameters' device, which is where every value of the step is made.
    Returns ``(params, mu, nu, metrics)``."""
    kl_w, lr, opt = row[0], row[1], row[2:5]
    draws = model.unpack_draws(row[5:], _batch_size(batch), True)
    leaves = [p.detach().requires_grad_(True) for _, p in tree_items(params)]
    live = _with_leaves(params, leaves)
    total, metrics = model.loss(live, batch, draws, kl_w, train=True)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = _with_leaves(params, [
        g if g is not None else torch.zeros_like(p)
        for g, p in zip(grads, leaves)])
    new_params, mu, nu, g_norm = adam_update(hps, grads, mu, nu, params, opt)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = g_norm
    metrics["lr"] = lr
    return new_params, mu, nu, metrics


def make_train_step(model, hps: HParams, device=None) -> StepFn:
    """Build ``step(state, batch, key) -> (state, metrics)``. ``batch`` is
    a loader dict (numpy or tensors), moved to ``device`` (the card unless
    ``device="cpu"``); ``key`` a threefry key (``utils/prng.py``)."""
    check_trainable(hps)
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch, key: torch.Tensor
                ) -> Tuple[TrainState, Metrics]:
        batch = batch_to_device(batch, dev)
        row = to_device(stage_steps(model, hps, state, key[None],
                                    _batch_size(batch)), dev)[0]
        a = state.opt_state.adam
        params, mu, nu, metrics = train_body(model, hps, state.params, a.mu,
                                             a.nu, batch, row)
        return TrainState(params, next_opt_state(state.opt_state, mu, nu),
                          state.step + 1), metrics

    return step_fn


def replay_window_metrics(per_step: Sequence[Metrics]) -> Metrics:
    """Fold a window's per-micro-step metrics into one row, the K call's
    semantics (the JAX package's ``replay_window_metrics``): the MEAN over
    the window, ``grad_norm_max`` its max, ``lr`` and ``kl_weight`` the
    last micro-step's. Tensor math on the device, no host sync; the K call
    and the loop's remainder both fold with it."""
    sums = gmax = None
    for m in per_step:
        g = m["grad_norm"]
        gmax = g if gmax is None else torch.maximum(gmax, g)
        sums = (dict(m) if sums is None
                else {name: sums[name] + m[name] for name in sums})
    metrics = {name: v / len(per_step) for name, v in sums.items()}
    metrics["grad_norm_max"] = gmax
    metrics["lr"] = per_step[-1]["lr"]
    metrics["kl_weight"] = per_step[-1]["kl_weight"]
    return metrics


def make_multi_train_step(model, hps: HParams, device=None,
                          key_by_global_step: bool = False) -> StepFn:
    """Build ``step(state, batches, key) -> (state, metrics)``: K =
    ``hps.steps_per_call`` optimizer steps a call, ``batches`` a loader
    dict stacked ``[K, ...]``. Micro-step ``i`` trains on ``batches[i]``
    with ``fold_in(key, i)`` and the schedules at the live step, so a call
    is K single steps with those keys, bit for bit; the metrics are
    :func:`replay_window_metrics` of the K. On the card the K steps are
    one CUDA graph replay (``train/graph.py``), held by the returned
    function as ``graphed``: its first call runs the K steps eagerly as
    the capture's warm-up and captures them, and the graph's memory goes
    with the function. On the CPU the same body runs K times. K=1 is
    :func:`make_train_step`. ``key_by_global_step`` (the bucket-run
    scheduler's keys) is refused by name."""
    if key_by_global_step:
        raise NotImplementedError(
            f"key_by_global_step (the bucket-run scheduler) {_LATER}")
    k = hps.steps_per_call
    if k == 1:
        return make_train_step(model, hps, device)
    check_trainable(hps)
    dev = resolve_device(device)

    def body(params, mu, nu, batches, rows):
        per_step = []
        for i in range(rows.shape[0]):
            params, mu, nu, m = train_body(
                model, hps, params, mu, nu,
                {n: v[i] for n, v in batches.items()}, rows[i])
            per_step.append(m)
        return params, mu, nu, replay_window_metrics(per_step)

    call = (GraphedCall(body, f"train step x{k}", dev)
            if dev.type == "cuda" else body)

    def multi_fn(state: TrainState, batches, key: torch.Tensor
                 ) -> Tuple[TrainState, Metrics]:
        batches = host_tensors(batches)
        kk, b = batches["strokes"].shape[:2]
        if kk != k:
            raise ValueError(f"a {k}-step call takes batches stacked [{k}, "
                             f"...], got {kk}")
        keys = prng.fold_in(key.cpu(), torch.arange(k))
        rows = stage_steps(model, hps, state, keys, b)
        if dev.type != "cuda":
            batches, rows = batch_to_device(batches, dev), rows.to(dev)
        a = state.opt_state.adam
        params, mu, nu, metrics = call(state.params, a.mu, a.nu, batches,
                                      rows)
        return TrainState(params, next_opt_state(state.opt_state, mu, nu, k),
                          state.step + k), metrics

    multi_fn.graphed = call if dev.type == "cuda" else None
    return multi_fn


def eval_body(model, hps: HParams, params, batch, row) -> Metrics:
    """The eval-mode loss's metrics plus ``weight_sum`` on one batch of
    tensors; ``row``: the batch's draws (:func:`stage_eval`) on their
    device."""
    draws = model.unpack_draws(row, _batch_size(batch), False)
    _, metrics = model.loss(params, batch, draws, 1.0, train=False)
    if "weights" in batch:
        ws = batch["weights"].to(torch.float32).sum()
    else:
        ws = torch.full((), float(_batch_size(batch)), dtype=torch.float32,
                        device=batch["strokes"].device)
    metrics["weight_sum"] = ws
    return metrics


def stage_eval(model, keys: torch.Tensor, batch_size: int) -> torch.Tensor:
    """The eval draws of batch ``j`` with key ``keys[j]``, ``[K, L]`` on
    the CPU (the model's ``packed_draws``)."""
    return model.packed_draws(keys.cpu(), batch_size, False)


def _eval_step(body, model, hps: HParams, device) -> EvalFn:
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_fn(params, batch, key: torch.Tensor) -> Metrics:
        batch = batch_to_device(batch, dev)
        row = to_device(stage_eval(model, key[None], _batch_size(batch)),
                        dev)[0]
        return body(model, hps, params, batch, row)

    return eval_fn


def make_eval_step(model, hps: HParams, device=None) -> EvalFn:
    """``eval(params, batch, key) -> metrics``: the eval-mode loss's
    metrics plus ``weight_sum``, the sum of the batch's ``weights`` (its
    rows when it has none), as 0-dim tensors on ``device``."""
    return _eval_step(eval_body, model, hps, device)


def per_class_body(model, hps: HParams, params, batch, row) -> Metrics:
    draws = model.unpack_draws(row, _batch_size(batch), False)
    return model.eval_metrics_per_class(params, batch, draws)


def make_per_class_eval_step(model, hps: HParams, device=None) -> EvalFn:
    """``eval(params, batch, key) -> metrics`` with every metric a
    ``[num_classes]`` vector (``SketchRNN.eval_metrics_per_class``)."""
    return _eval_step(per_class_body, model, hps, device)


def _make_multi_eval(one, model, hps: HParams, device, name: str):
    """``eval(params, batches, key, idx) -> metrics`` over a ``[K, ...]``
    stack of batches, every metric stacked ``[K, ...]``; batch ``j`` uses
    ``fold_in(key, idx[j])``. One CUDA graph replay per call on the card
    (a graph per ``(K, B, T)``, held by the returned function as
    ``graphed``), the same body K times on the CPU."""
    dev = resolve_device(device)

    @torch.no_grad()
    def body(params, batches, rows):
        outs = [one(model, hps, params, {n: v[j] for n, v in batches.items()},
                    rows[j]) for j in range(rows.shape[0])]
        return {m: torch.stack([o[m] for o in outs]) for m in outs[0]}

    call = GraphedCall(body, name, dev) if dev.type == "cuda" else body

    def multi_fn(params, batches, key: torch.Tensor,
                 idx: Sequence[int]) -> Metrics:
        batches = host_tensors(batches)
        keys = prng.fold_in(key.cpu(), torch.as_tensor(list(idx)))
        rows = stage_eval(model, keys, batches["strokes"].shape[1])
        if dev.type != "cuda":
            batches, rows = batch_to_device(batches, dev), rows.to(dev)
        return call(params, batches, rows)

    multi_fn.graphed = call if dev.type == "cuda" else None
    return multi_fn


def make_multi_eval_step(model, hps: HParams, device=None):
    """K-batch eval (:func:`_make_multi_eval` of :func:`make_eval_step`'s
    body); pair it with ``hps.eval_steps_per_call`` as ``evaluate``'s
    ``multi=`` argument."""
    return _make_multi_eval(eval_body, model, hps, device, "eval step xK")


def make_multi_per_class_eval_step(model, hps: HParams, device=None):
    """K-batch per-class eval (metrics stacked ``[K, C]``)."""
    return _make_multi_eval(per_class_body, model, hps, device,
                            "per-class eval step xK")
