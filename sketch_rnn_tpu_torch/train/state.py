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
What an update derives from them (the step size, the bias corrections)
is computed on the host (:func:`optimizer_scalars`) and handed to the
tensor-only update (:func:`adam_update`) as a vector on the device, which
is what lets K updates run as one captured CUDA graph
(``train/graph.py``).
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


def states_equal(a: TrainState, b: TrainState) -> bool:
    """Whether two states hold the same counts and, leaf by leaf, the same
    paths, dtypes, shapes and values bit for bit (``b``'s leaves compared
    on ``a``'s device)."""
    pa, pb = a.opt_state.adam, b.opt_state.adam
    if (pa.count, a.opt_state.schedule_count, a.step) != (
            pb.count, b.opt_state.schedule_count, b.step):
        return False
    for ta, tb in ((a.params, b.params), (pa.mu, pb.mu), (pa.nu, pb.nu)):
        la, lb = tree_items(ta), tree_items(tb)
        if [p for p, _ in la] != [p for p, _ in lb]:
            return False
        for (_, x), (_, y) in zip(la, lb):
            if not (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y.to(x.device))):
                return False
    return True


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
    # a fill, not a host copy: a captured CUDA graph refuses the latter
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def optimizer_scalars(hps: HParams, count: int, schedule_count: int
                      ) -> torch.Tensor:
    """What one update takes from the host counts (``count``, Adam's, and
    ``schedule_count`` before the update), as a float32 vector on the
    CPU: ``[-lr_schedule(schedule_count), 1 - b1^c, 1 - b2^c]`` at the
    incremented count ``c``. Computed on the host for every update, so an
    update replayed in a CUDA graph and one run eagerly read the same
    values (:func:`adam_update`)."""
    c = torch.tensor(count + 1, dtype=torch.float32)
    return torch.stack([-lr_schedule(hps, schedule_count),
                        1 - torch.pow(torch.tensor(B1, dtype=torch.float32),
                                      c),
                        1 - torch.pow(torch.tensor(B2, dtype=torch.float32),
                                      c)])


@torch.no_grad()
def adam_update(hps: HParams, grads, mu, nu, params, scalars):
    """One ``clip_by_global_norm -> adam(lr_schedule)`` update on tensors
    alone: ``scalars`` is :func:`optimizer_scalars`'s vector on the
    parameters' device. Returns ``(new_params, mu, nu, grad_norm)``;
    nothing is updated in place, and nothing is read from or copied from
    the host, so the update can be captured in a CUDA graph."""
    dev = next(iter(tree_items(params)))[1].device
    g_norm = global_norm(grads)
    clip = _f32(hps.grad_clip, dev)
    trigger = g_norm < clip
    grads = tree_map(lambda g: torch.where(trigger, g, (g / g_norm) * clip),
                     grads)
    # the constants made once an update, not once a leaf
    b1, b2, c1, c2 = (_f32(x, dev) for x in (B1, B2, 1 - B1, 1 - B2))
    mu = tree_map(lambda g, m: c1 * g + b1 * m, grads, mu)
    nu = tree_map(lambda g, v: c2 * (g * g) + b2 * v, grads, nu)
    step_size, bc1, bc2 = scalars.unbind()
    eps = _f32(EPS, dev)
    new_params = tree_map(
        lambda p, m, v: p + step_size * ((m / bc1) / (torch.sqrt(v / bc2)
                                                      + eps)),
        params, mu, nu)
    return new_params, mu, nu, g_norm


def next_opt_state(opt_state: OptState, mu, nu, k: int = 1) -> OptState:
    """The optimizer state after ``k`` updates that left moments ``mu``
    and ``nu``: both counts advanced by ``k``."""
    return OptState(AdamState(opt_state.adam.count + k, mu, nu),
                    opt_state.schedule_count + k)
