"""Stroke-format utilities (host-side numpy).

The port's own copy of ``sketch_rnn_tpu/data/strokes.py`` (the port
imports nothing of the JAX package): ``to_big_strokes``,
``to_normal_strokes``, ``augment_strokes``,
``calculate_normalizing_scale_factor`` and kin, semantics per the
sketch-rnn paper, arXiv:1704.03477 §3.1.

Formats:

- **stroke-3**: ``[N, 3]`` rows of ``(dx, dy, pen_lifted)`` where
  ``pen_lifted`` is 1 on the last point of each pen-down stroke.
- **stroke-5**: ``[N, 5]`` rows of ``(dx, dy, p1, p2, p3)`` one-hot pen
  state: p1 = pen down, p2 = pen up (end of a stroke), p3 = end of sketch.

These run on the host as plain numpy; only padded stroke-5 batches cross
to the device.
"""

from __future__ import annotations

import numpy as np


def to_big_strokes(stroke3: np.ndarray, max_len: int) -> np.ndarray:
    """stroke-3 -> stroke-5, padded to ``max_len`` with end-of-sketch rows.

    The output does NOT include the initial zero row; callers prepend the
    start token ``(0, 0, 1, 0, 0)`` when building model inputs.
    """
    n = len(stroke3)
    if n > max_len:
        raise ValueError(f"sequence of length {n} exceeds max_len {max_len}")
    out = np.zeros((max_len, 5), dtype=np.float32)
    out[:n, 0:2] = stroke3[:, 0:2]
    out[:n, 3] = stroke3[:, 2]          # p2 = pen lifted
    out[:n, 2] = 1.0 - stroke3[:, 2]    # p1 = pen down
    out[n:, 4] = 1.0                    # p3 = end of sketch for the padding
    return out


def to_normal_strokes(big: np.ndarray) -> np.ndarray:
    """stroke-5 -> stroke-3, truncated at the first end-of-sketch row."""
    end = len(big)
    for i in range(len(big)):
        if big[i, 4] > 0.5:
            end = i
            break
    out = np.zeros((end, 3), dtype=np.float32)
    out[:, 0:2] = big[:end, 0:2]
    out[:, 2] = big[:end, 3]
    return out


def calculate_normalizing_scale_factor(stroke3_list) -> float:
    """Std of all (dx, dy) offsets pooled over the training split.

    The reference normalizes every split by the *train* split's offset std
    (SURVEY §3.5); this factor is part of the model contract and must be
    checkpointed (SURVEY §5 'Checkpoint / resume').
    """
    data = np.concatenate([s[:, 0:2].reshape(-1) for s in stroke3_list])
    return float(np.std(data))


def normalize_strokes(stroke3_list, scale_factor: float):
    """Divide offsets by ``scale_factor`` (in place on copies)."""
    out = []
    for s in stroke3_list:
        s = np.array(s, dtype=np.float32)
        s[:, 0:2] /= scale_factor
        out.append(s)
    return out


def random_scale(stroke3: np.ndarray, factor: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Per-axis random scale jitter in [1-factor, 1+factor] (train-time)."""
    x = (rng.random() * 2.0 - 1.0) * factor + 1.0
    y = (rng.random() * 2.0 - 1.0) * factor + 1.0
    out = np.array(stroke3, dtype=np.float32)
    out[:, 0] *= x
    out[:, 1] *= y
    return out


def augment_strokes(stroke3: np.ndarray, prob: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Random point-dropout augmentation.

    With probability ``prob`` a pen-down point is merged into its
    predecessor (offsets summed), thinning dense polylines without changing
    the drawing. Points adjacent to pen-lifts are never dropped.
    """
    if prob <= 0.0:
        return np.array(stroke3, dtype=np.float32)
    result = []
    prev = [0.0, 0.0, 0.0]
    count = 0
    for i in range(len(stroke3)):
        candidate = [float(stroke3[i][0]), float(stroke3[i][1]),
                     int(stroke3[i][2])]
        if candidate[2] == 1 or prev[2] == 1:
            count = 0
        else:
            count += 1
        check = candidate[2] == 0 and prev[2] == 0 and count > 2
        if check and rng.random() < prob and result:
            result[-1][0] += candidate[0]
            result[-1][1] += candidate[1]
        else:
            result.append(candidate)
            prev = candidate
    return np.array(result, dtype=np.float32)


def strokes_to_lines(stroke3: np.ndarray):
    """stroke-3 -> list of polylines [[(x, y), ...], ...] in absolute coords."""
    x, y = 0.0, 0.0
    lines = []
    line = []
    for i in range(len(stroke3)):
        x += float(stroke3[i, 0])
        y += float(stroke3[i, 1])
        line.append((x, y))
        if stroke3[i, 2] >= 1:
            lines.append(line)
            line = []
    if line:
        lines.append(line)
    return lines
