"""Learning-rate decay and KL-annealing schedules.

The port of ``sketch_rnn_tpu/train/schedules.py``: ``rate**step`` is
computed as ``exp(step * log(rate))`` in float32, as the JAX package
does, so both packages anneal by the same float32 values.
"""

from __future__ import annotations

import torch

from sketch_rnn_tpu_torch.config import HParams


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _exp_decay(step, rate: float) -> torch.Tensor:
    return torch.exp(torch.as_tensor(step, dtype=torch.float32)
                     * torch.log(_f32(rate)))


def lr_schedule(hps: HParams, step) -> torch.Tensor:
    """``(lr0 - lr_min) * decay^step + lr_min`` (float32 scalar)."""
    return (_f32(hps.learning_rate - hps.min_learning_rate)
            * _exp_decay(step, hps.decay_rate) + _f32(hps.min_learning_rate))


def kl_weight_schedule(hps: HParams, step) -> torch.Tensor:
    """Annealed KL weight: rises from ``kl_weight_start`` to ``kl_weight``."""
    return (_f32(hps.kl_weight) - _f32(hps.kl_weight - hps.kl_weight_start)
            * _exp_decay(step, hps.kl_decay_rate))
