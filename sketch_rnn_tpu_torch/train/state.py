"""Train state and the optimizer.

The port of ``sketch_rnn_tpu/train/state.py``: the JAX package's optax
chain ``clip_by_global_norm(grad_clip) -> adam(lr_schedule)`` written out
by hand to optax's definitions:

- the global norm is ``sqrt`` of the sum, leaf by leaf in the tree's
  (sorted-key) order, of each leaf's sum of squares; below ``grad_clip``
  the gradients pass unchanged, else each is ``(g / norm) * grad_clip``;
- Adam with ``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8`` outside the
  square root: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  bias corrections ``1 - b^count`` at the incremented count, update
  ``mu_hat / (sqrt(nu_hat) + eps)``;
- the step is ``-lr_schedule(count)`` at the schedule's PRE-increment
  count, then ``params + update``.

The optimizer state mirrors optax's: ``OptState(adam=AdamState(count, mu,
nu), schedule_count)`` (the clip has no state), with the counts held on
the host as Python ints (they are what optax keeps as int32 scalars).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.train.schedules import lr_schedule

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    count: int
    mu: Dict[str, Any]
    nu: Dict[str, Any]


class OptState(NamedTuple):
    adam: AdamState
    schedule_count: int


class TrainState(NamedTuple):
    params: Dict[str, Any]
    opt_state: OptState
    step: int


def tree_items(tree, prefix=()) -> List:
    """``[(path, leaf)]`` in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros_like(p)
    return OptState(AdamState(0, tree_map(zeros, params),
                              tree_map(zeros, params)), 0)


def make_train_state(params) -> TrainState:
    return TrainState(params, init_opt_state(params), 0)


def global_norm(tree) -> torch.Tensor:
    total = None
    for _, g in tree_items(tree):
        s = torch.sum(g * g)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


@torch.no_grad()
def apply_optimizer(hps: HParams, grads, opt_state: OptState, params):
    """One ``clip_by_global_norm -> adam(lr_schedule)`` update. Returns
    ``(new_params, new_opt_state, grad_norm)``; nothing is updated in
    place."""
    dev = next(iter(tree_items(params)))[1].device
    g_norm = global_norm(grads)
    clip = _f32(hps.grad_clip, dev)
    trigger = g_norm < clip
    grads = tree_map(lambda g: torch.where(trigger, g, (g / g_norm) * clip),
                     grads)
    adam = opt_state.adam
    mu = tree_map(lambda g, m: _f32(1 - B1, dev) * g + _f32(B1, dev) * m,
                  grads, adam.mu)
    nu = tree_map(lambda g, v: _f32(1 - B2, dev) * (g * g)
                  + _f32(B2, dev) * v, grads, adam.nu)
    count = adam.count + 1
    c = _f32(count, dev)
    bc1 = 1 - torch.pow(_f32(B1, dev), c)
    bc2 = 1 - torch.pow(_f32(B2, dev), c)
    step_size = -lr_schedule(hps, opt_state.schedule_count).to(dev)
    eps = _f32(EPS, dev)
    new_params = tree_map(
        lambda p, m, v: p + step_size * ((m / bc1) / (torch.sqrt(v / bc2)
                                                      + eps)),
        params, mu, nu)
    return (new_params,
            OptState(AdamState(count, mu, nu), opt_state.schedule_count + 1),
            g_norm)
