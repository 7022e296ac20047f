"""Stroke-3 corpora into padded stroke-5 training batches (host numpy).

The port of the parts of ``sketch_rnn_tpu/data/loader.py`` a
single-host, unbucketed trainer uses: ``_purify``, ``DataLoader``
(``normalize``, ``random_batch``/``next_batch`` and the numpy assembly
path) and the synthetic QuickDraw-shaped corpus
(``make_synthetic_strokes``, ``synthetic_loader``). Batches are numpy
dicts, bitwise the JAX package's numpy path for the same corpus and
seed: the loader's RNG draws the same values in the same order,
including the per-batch augmentation seed that the JAX package's native
batcher would consume, so the streams stay aligned.

Not ported yet (each raises, naming the later slice): the native C++
batcher, length bucketing (``bucket_edges``, ``next_stack``),
multi-host striping, and the int16 transfer path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.data import strokes as S

_LATER = "comes with a later slice of the PyTorch port"


def _purify(stroke3_list, max_seq_len: int, limit: float = 1000.0,
            source: Optional[str] = None, skip_bad: bool = False):
    """Drop too-long sequences and empty records; clamp absurd offsets to
    ``±limit``. A corrupt record (wrong rank or column count,
    non-numeric) raises one line naming ``source`` and its index, or is
    skipped and counted with ``skip_bad``."""
    out = []
    skipped = 0
    for i, s in enumerate(stroke3_list):
        try:
            if len(s) == 0:
                continue
            s = np.array(s, dtype=np.float32)
            if s.ndim != 2 or s.shape[1] != 3:
                raise ValueError(f"expected an [N, 3] stroke-3 array, "
                                 f"got shape {s.shape}")
        except (ValueError, TypeError) as e:
            where = f"{source or '<in-memory corpus>'} record {i}"
            if not skip_bad:
                raise ValueError(
                    f"corrupt stroke record: {where}: {e}") from None
            skipped += 1
            continue
        if len(s) > max_seq_len:
            continue
        s[:, 0:2] = np.clip(s[:, 0:2], -limit, limit)
        out.append(s)
    if skipped:
        print(f"[data] WARNING: skipped {skipped} corrupt record(s) in "
              f"{source or '<in-memory corpus>'}", flush=True)
    return out


def pad_batch(seqs: Sequence[np.ndarray], max_len: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``strokes [B, max_len+1, 5]`` with the start token ``(0, 0, 1, 0,
    0)`` at t=0 and ``seq_len [B]`` int32."""
    out = np.zeros((len(seqs), max_len + 1, 5), dtype=np.float32)
    lens = np.empty((len(seqs),), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s, np.float32)
        out[i, 1:, :] = S.to_big_strokes(s, max_len)
        out[i, 0, :] = [0, 0, 1, 0, 0]
        lens[i] = len(s)
    return out, lens


class DataLoader:
    """Pads, normalizes, augments and batches stroke-3 sequences.

    The loader adopts float32 input arrays without copying, and
    ``normalize`` scales them in place. ``random_batch``/``next_batch``
    return ``{"strokes": [B, max_seq_len + 1, 5] float32, "seq_len": [B]
    int32, "labels": [B] int32}``.
    """

    def __init__(self, stroke3_list: Sequence[np.ndarray], hps: HParams,
                 labels: Optional[np.ndarray] = None,
                 augment: bool = False, seed: int = 0):
        if hps.bucket_edges:
            raise NotImplementedError(
                f"bucket_edges={hps.bucket_edges}: length-bucketed "
                f"batching {_LATER}; train with bucket_edges=()")
        self.hps = hps
        self.scale_factor = 1.0
        self.strokes: List[np.ndarray] = [np.asarray(s, np.float32)
                                          for s in stroke3_list]
        if labels is None:
            labels = np.zeros((len(self.strokes),), dtype=np.int32)
        self.labels = np.asarray(labels, dtype=np.int32)
        if len(self.labels) != len(self.strokes):
            raise ValueError(f"{len(self.labels)} labels for "
                             f"{len(self.strokes)} sequences")
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.strokes)

    def normalize(self, scale_factor: float) -> None:
        self.scale_factor = float(scale_factor)
        for s in self.strokes:
            s[:, 0:2] /= scale_factor

    def _assemble(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        raw = [self.strokes[i] for i in idx]
        # one augmentation seed per batch: the JAX package hands it to its
        # native batcher; drawing it here too keeps the numpy RNG stream
        # aligned with the JAX package's numpy path
        if self.augment:
            self.rng.integers(0, 2 ** 63)
            raw = [S.augment_strokes(
                S.random_scale(s, self.hps.random_scale_factor, self.rng),
                self.hps.augment_stroke_prob, self.rng) for s in raw]
        strokes, seq_len = pad_batch(raw, self.hps.max_seq_len)
        return {"strokes": strokes, "seq_len": seq_len,
                "labels": self.labels[idx]}

    def random_batch(self, int16_scale: Optional[float] = None
                     ) -> Dict[str, np.ndarray]:
        if int16_scale is not None:
            raise NotImplementedError(
                f"the int16 transfer path {_LATER}; train with "
                f"transfer_dtype=float32")
        b = self.hps.batch_size
        idx = self.rng.choice(len(self.strokes), b,
                              replace=len(self.strokes) < b)
        return self._assemble(idx)

    def next_batch(self, int16_scale: Optional[float] = None
                   ) -> Dict[str, np.ndarray]:
        """The next training batch: without buckets, exactly
        :meth:`random_batch`."""
        return self.random_batch(int16_scale)

    def next_stack(self, k_max: int, int16_scale: Optional[float] = None):
        raise NotImplementedError(
            f"stacked batches (steps_per_call > 1) {_LATER}")


# -- synthetic corpus ------------------------------------------------------


def make_synthetic_strokes(num: int, num_classes: int = 1,
                           min_len: int = 24, max_len: int = 96,
                           seed: int = 0, fixed_class: Optional[int] = None,
                           integer_grid: Optional[float] = None,
                           ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Deterministic synthetic sketch corpus: each class a parametric
    figure (loops or zigzags with class-dependent frequency), 1-3 pen
    strokes with noise. ``integer_grid`` snaps absolute coordinates to
    that integer lattice before differencing (QuickDraw's integer
    deltas). Returns ``(stroke3_list, labels)``; the same values as the
    JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    max_len = max(2, max_len)
    min_len = max(2, min(min_len, max_len))
    out: List[np.ndarray] = []
    if fixed_class is not None:
        labels = np.full((num,), fixed_class, dtype=np.int32)
    else:
        labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    for i in range(num):
        c = int(labels[i])
        n = int(rng.integers(min_len, max_len + 1))
        t = np.linspace(0.0, 2.0 * np.pi, n)
        freq = 1.0 + c % 3
        radius = 1.0 + 0.5 * ((c // 3) % 3)
        phase = rng.random() * 2 * np.pi
        if c % 2 == 0:  # loopy figure
            x = radius * np.cos(freq * t + phase)
            y = radius * np.sin(t + phase) * (0.5 + 0.5 * (c % 5) / 4)
        else:           # zigzag figure
            x = t / np.pi - 1.0
            y = radius * np.sign(np.sin(freq * t + phase)) * (t / (2 * np.pi))
        x = x + rng.normal(0, 0.02, n)
        y = y + rng.normal(0, 0.02, n)
        if integer_grid is not None:
            x = np.rint(x * integer_grid)
            y = np.rint(y * integer_grid)
        dx = np.diff(x, prepend=x[0]).astype(np.float32)
        dy = np.diff(y, prepend=y[0]).astype(np.float32)
        pen = np.zeros(n, dtype=np.float32)
        lift_pool = np.arange(4, n - 2)
        n_strokes = int(rng.integers(1, 2 + min(2, len(lift_pool))))
        lifts = rng.choice(lift_pool, size=n_strokes - 1,
                           replace=False) if n_strokes > 1 else []
        for j in lifts:
            pen[j] = 1.0
        pen[-1] = 1.0
        out.append(np.stack([dx, dy, pen], axis=1))
    return out, labels


def synthetic_loader(hps: HParams, num: int, seed: int = 0,
                     augment: bool = False,
                     scale_factor: Optional[float] = None,
                     host_id: int = 0, num_hosts: int = 1,
                     integer_grid: Optional[float] = None,
                     ) -> Tuple[DataLoader, float]:
    """One synthetic-corpus loader sized to ``hps``: ``max(num_classes,
    1)`` figure classes, lengths clamped to fit ``max_seq_len``, offsets
    normalized by the corpus's own scale factor unless ``scale_factor``
    is given. Returns ``(loader, scale_factor)``."""
    if num_hosts != 1 or host_id != 0:
        raise NotImplementedError(
            f"multi-host striping (num_hosts={num_hosts}) {_LATER}")
    seqs, labels = make_synthetic_strokes(
        num, num_classes=max(hps.num_classes, 1),
        max_len=min(96, hps.max_seq_len - 2), seed=seed,
        integer_grid=integer_grid)
    if scale_factor is None:
        scale_factor = S.calculate_normalizing_scale_factor(seqs)
    loader = DataLoader(seqs, hps, labels=labels, augment=augment,
                        seed=seed)
    loader.normalize(scale_factor)
    return loader, scale_factor
