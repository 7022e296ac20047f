"""A minimal training loop.

The port of the core of ``sketch_rnn_tpu/train/loop.py::train``: the key
discipline (``root_key, init_key = split(key(seed))``, then step ``s``
trains with ``fold_in(root_key, s)``), one ``next_batch()`` per step and
one train step per batch. It returns the final state and one metrics row
per step. Checkpoints, eval sweeps, prefetch, telemetry, the watchdog
and elastic runs are not ported yet: asking for one raises, naming the
later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.train.state import TrainState, make_train_state
from sketch_rnn_tpu_torch.train.step import check_trainable, make_train_step
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.device import resolve_device, tree_to


def train(hps: HParams, train_loader, seed: int = 0,
          num_steps: Optional[int] = None, params=None, device=None,
          valid_loader=None, workdir: Optional[str] = None,
          profile: bool = False, trace_dir: Optional[str] = None,
          watchdog: bool = False, coordinator=None
          ) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Train for ``num_steps`` (default ``hps.num_steps``) steps from
    ``params``, else from the port's own seeded initialization (drawn
    from ``init_key``; not the JAX package's values), with a fresh
    optimizer state. Returns ``(state, rows)``: each row holds the step
    and the step's metrics as floats, read from the device once, at the
    end."""
    later = {"valid_loader (eval sweeps)": valid_loader is not None,
             "workdir (checkpoints and metric files)": workdir is not None,
             "profile": profile, "trace_dir (telemetry)": trace_dir,
             "watchdog": watchdog,
             "coordinator (elastic runs)": coordinator is not None}
    for what, asked in later.items():
        if asked:
            raise NotImplementedError(
                f"train(): {what} comes with a later slice of the PyTorch "
                f"port")
    check_trainable(hps)
    dev = resolve_device(device)
    num_steps = hps.num_steps if num_steps is None else num_steps
    model = SketchRNN(hps)
    root_key, init_key = prng.split(prng.key(seed), 2).unbind(dim=-2)
    if params is None:
        gen = torch.Generator().manual_seed(int(init_key[1]))
        params = model.init_params(gen, device=dev)
    state = make_train_state(tree_to(params, dev))
    step_fn = make_train_step(model, hps, device=dev)
    history = []
    for _ in range(num_steps):
        step = state.step
        state, metrics = step_fn(state, train_loader.next_batch(),
                                 prng.fold_in(root_key, step))
        history.append((step, metrics))
    rows = []
    if history:
        names = sorted(history[0][1])
        table = torch.stack([torch.stack([m[k].float() for k in names])
                             for _, m in history]).cpu()
        for (step, _), vals in zip(history, table.tolist()):
            rows.append({"step": step, **dict(zip(names, vals))})
    return state, rows
