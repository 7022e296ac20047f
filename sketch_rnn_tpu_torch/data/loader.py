"""Stroke-3 corpora into padded stroke-5 training batches (host numpy).

The port of the parts of ``sketch_rnn_tpu/data/loader.py`` a
single-host trainer uses: ``_purify``, ``DataLoader``
(``normalize``, ``random_batch``/``next_batch``, ``fast_forward``, the
eval sweep's ``num_eval_batches``/``get_batch`` and the numpy assembly
path), ``load_dataset`` over a directory of QuickDraw-shaped ``.npz``
files, and the synthetic corpus (``make_synthetic_strokes``,
``synthetic_loader``, ``write_synthetic_npz``). Batches are numpy
dicts, bitwise the JAX package's for the same corpus and seed.

Every batch is assembled in one call into the native C++ batcher
(``data/native_batcher.py``), as the JAX loader assembles it when its
library builds: unaugmented through ``assemble_batch``; augmented (the
train split) through ``assemble_batch_aug``, whose scale jitter and point
dropout draw from the library's own stream, keyed by one seed the
loader's RNG draws per batch. The numpy path (numpy augmentation from
the loader's RNG, ``pad_batch_numpy``) is taken only when the caller
sets ``SKETCH_RNN_TPU_TORCH_NO_NATIVE=1``; it is then bitwise the JAX
package's numpy path (its native batcher switched off), which draws the
same per-batch seed first, so the two paths' streams stay aligned up to
the augmentation. Unaugmented, both paths give the same bits.

``int16_scale`` (the int16 transfer path, ``data/prefetch.py``)
quantizes a batch's offsets back to integer data units, in the same
native pass (``assemble_batch_aug_i16``) or after the numpy assembly
(:func:`quantize_int16`), with the same rounding, and adds the
``"transfer_scale"`` leaf.

Length-bucketed execution (``hps.bucket_edges``) is the JAX loader's,
bit for bit: the seeded epoch plan (``_plan_bucket_epoch``: batches
padded only to their bucket edge, weighted wrap-filled tail batches,
the run-aware windowed shuffle), the bucketed ``next_batch`` stream,
``seek_epoch``, the bucket-run scheduler's ``next_stack``, the eval
batches at their bucket's pad (``eval_pad_len``, ``get_batch``), the
plan's part of ``plan_fingerprint``, and the padding ledger
(``utils/profiling.py``) that every assembled batch is recorded in.

Host striping (``host_id``/``num_hosts`` of ``load_dataset`` and
``synthetic_loader``) is the JAX package's, bit for bit: every split is
striped ``seqs[host_id::num_hosts]``, each stripe's RNG seeded ``seed +
7919 * host_id``, the scale factor taken from the whole train split, and
the eval sweep's batch count derived from the corpus before striping, so
every rank makes the same number of eval calls (each holds collectives).
With ``parallel/multihost.local_batch_hps`` each stripe assembles its
rank's share of the global batch. Bucketed plans on a striped loader
raise, as in the JAX package: each rank would plan its own geometries.

Not ported yet (it raises, naming the later slice): the coordinated
global plan (``coordinated``, ``emit_global``, the elastic runtime's;
ROADMAP queue 1 item 7d).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.data import native_batcher as NB
from sketch_rnn_tpu_torch.data import strokes as S
from sketch_rnn_tpu_torch.utils.profiling import PaddingLedger

_LATER = "comes with a later slice of the PyTorch port"
_COORDINATED = (f"the coordinated global plan {_LATER} (ROADMAP queue 1 "
                f"item 7d, the elastic runtime)")


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


def quantize_int16(strokes: np.ndarray, scale: float) -> np.ndarray:
    """A float32 stroke-5 batch as int16: the offsets
    ``clip(rint(x * scale), -32767, 32767)`` (``np.rint`` rounds half to
    even), the pen bits copied as 0/1."""
    q = np.empty(strokes.shape, np.int16)
    np.clip(np.rint(strokes[..., :2] * scale), -32767, 32767,
            out=q[..., :2], casting="unsafe")
    q[..., 2:] = strokes[..., 2:]
    return q


class DataLoader:
    """Pads, normalizes, augments and batches stroke-3 sequences.

    The loader adopts float32 input arrays without copying, and
    ``normalize`` scales them in place. ``random_batch``/``next_batch``
    return ``{"strokes": [B, max_seq_len + 1, 5] float32, "seq_len": [B]
    int32, "labels": [B] int32}``.

    Length-bucketed execution (``hps.bucket_edges``): :meth:`next_batch`
    feeds training from a seeded epoch plan, each batch padded only to
    its bucket edge ``Tb`` (strokes ``[B, Tb + 1, 5]``), every example
    covered once an epoch; :meth:`get_batch` pads eval batches to
    :meth:`eval_pad_len`. The plan orders its batches into geometry runs
    (consecutive batches of one ``(Tb, weighted?)``, at most
    ``hps.bucket_run_len`` long) and :meth:`next_stack` pops up to K of one
    run stacked ``[k, ...]``: the same micro-batches, in the same order and
    with the same RNG draws, as :meth:`next_batch`. Without buckets
    ``next_batch`` is exactly :meth:`random_batch`. Every assembled batch
    is recorded in ``padding_ledger``.

    A stripe of ``num_hosts`` (``host_id``'s rows of a corpus of
    ``global_size``) counts its eval batches from the corpus before
    striping, as the JAX loader does; it refuses ``bucket_edges``.
    """

    def __init__(self, stroke3_list: Sequence[np.ndarray], hps: HParams,
                 labels: Optional[np.ndarray] = None,
                 augment: bool = False, seed: int = 0,
                 global_size: Optional[int] = None, num_hosts: int = 1,
                 host_id: int = 0):
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
        self.seed = seed
        self.num_hosts, self.host_id = num_hosts, host_id
        # a stripe counts its eval batches from the corpus before striping
        self._global_size = global_size if num_hosts > 1 else None
        if hps.bucket_edges and num_hosts > 1:
            raise RuntimeError(
                f"bucket_edges on a host-striped loader (num_hosts="
                f"{num_hosts}) would launch mismatched per-host batch "
                f"geometries; that needs {_COORDINATED}")
        # the effective edges end at max_seq_len (the terminal bucket), so
        # every admitted sequence has a bucket; () is bucketing off
        edges = tuple(hps.bucket_edges)
        if edges and edges[-1] < hps.max_seq_len:
            edges = edges + (hps.max_seq_len,)
        self.bucket_edges: Tuple[int, ...] = edges
        self._lengths = np.array([len(s) for s in self.strokes], np.int32)
        self._bucket_epoch = 0
        self._bucket_queue: List[tuple] = []
        self.padding_ledger = PaddingLedger(edges or (hps.max_seq_len,))

    def __len__(self) -> int:
        return len(self.strokes)

    def normalize(self, scale_factor: float) -> None:
        self.scale_factor = float(scale_factor)
        for s in self.strokes:
            s[:, 0:2] /= scale_factor

    def _assemble(self, idx: np.ndarray,
                  int16_scale: Optional[float] = None,
                  pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The batch of corpus rows ``idx``, padded to ``pad_to`` (a bucket
        edge; every row fits, since rows are binned by raw length and
        augmentation only shortens a sequence) or to ``max_seq_len``, in
        one native call (the numpy path when asked for: the module
        docstring)."""
        if int16_scale is not None and not int16_scale > 0:
            raise ValueError(
                f"int16_scale must be positive, got {int16_scale}")
        pad = self.hps.max_seq_len if pad_to is None else int(pad_to)
        raw = [self.strokes[i] for i in idx]
        # one augmentation seed per batch, drawn on either path, so the
        # loader's RNG stream does not depend on the path
        aug_seed = int(self.rng.integers(0, 2 ** 63)) if self.augment else 0
        scale = self.hps.random_scale_factor if self.augment else 0.0
        drop = self.hps.augment_stroke_prob if self.augment else 0.0
        if NB.numpy_requested():
            if self.augment:
                raw = [S.augment_strokes(S.random_scale(s, scale, self.rng),
                                         drop, self.rng) for s in raw]
            strokes, seq_len = NB.pad_batch_numpy(raw, pad)
            if int16_scale is not None:
                strokes = quantize_int16(strokes, int16_scale)
        elif int16_scale is not None:
            strokes, seq_len = NB.assemble_batch_aug_i16(
                raw, pad, scale, drop, seed=aug_seed,
                quant=float(int16_scale))
        elif self.augment:
            strokes, seq_len = NB.assemble_batch_aug(raw, pad, scale, drop,
                                                     seed=aug_seed)
        else:
            strokes, seq_len = NB.assemble_batch(raw, pad)
        self.padding_ledger.record(pad, len(raw), int(seq_len.sum()))
        batch = {"strokes": strokes, "seq_len": seq_len,
                 "labels": self.labels[idx]}
        if int16_scale is not None:
            batch["transfer_scale"] = np.full((len(raw),), int16_scale,
                                              np.float32)
        return batch

    def random_batch(self, int16_scale: Optional[float] = None
                     ) -> Dict[str, np.ndarray]:
        """A batch of ``batch_size`` examples drawn with replacement only
        when the corpus is smaller. ``int16_scale``: strokes as int16 data
        units (:func:`quantize_int16`) with a ``"transfer_scale"`` ``[B]``
        float32 leaf."""
        b = self.hps.batch_size
        idx = self.rng.choice(len(self.strokes), b,
                              replace=len(self.strokes) < b)
        return self._assemble(idx, int16_scale)

    def filter_by_label(self, label: int) -> "DataLoader":
        """A new loader over this one's class-``label`` examples only, for
        per-class inspection on one host: it shares the (normalized)
        stroke arrays, so do not ``normalize`` it, and it does not
        augment. A striped loader refuses, as the JAX package's does: the
        per-class count over all ranks is not known locally, so the ranks
        would make different numbers of eval calls (use
        ``train.loop.evaluate_per_class``)."""
        if self.num_hosts > 1:
            raise RuntimeError(
                f"filter_by_label on a host-striped loader "
                f"(num_hosts={self.num_hosts}) would deadlock the SPMD "
                f"eval sweep (the per-class GLOBAL count is not a batch "
                f"multiple on every host, coordinated or not); use "
                f"train.loop.evaluate_per_class instead")
        sel = np.flatnonzero(self.labels == label)
        return DataLoader([self.strokes[i] for i in sel], self.hps,
                          labels=self.labels[sel], augment=False)

    def fast_forward(self, n_batches: int) -> None:
        """Draw and discard ``n_batches`` training batches through
        :meth:`next_batch` (epoch refills included), so a fresh loader of
        a run resumed at step ``n`` feeds the batches the uninterrupted
        run drew from step ``n`` on. The padding ledger's window is reset
        afterwards, so the discarded batches do not count in the resumed
        run's first ``padded_frac``."""
        if n_batches < 0:
            raise ValueError(f"n_batches must be >= 0, got {n_batches}")
        for _ in range(n_batches):
            self.next_batch()
        if n_batches:
            self.padding_ledger.window()

    def plan_fingerprint(self, epoch: Optional[int] = None) -> str:
        """The JAX package's digest of the schedule: the batch size, the
        bucket edges, the corpus content (labels and every normalized
        stroke's bytes) and, under bucketed execution, epoch ``epoch``'s
        ``(Tb, idx, weights)`` plan (the current epoch by default)."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        h.update(f"{self.seed}:{self.hps.batch_size}:{self.bucket_edges}:"
                 f"{len(self.strokes)}:{self.augment}".encode())
        h.update(np.ascontiguousarray(self.labels).tobytes())
        for s in self.strokes:
            h.update(np.ascontiguousarray(s).tobytes())
        if self.bucket_edges:
            ep = self._bucket_epoch if epoch is None else int(epoch)
            for tb, idx, w in self._plan_bucket_epoch(ep):
                h.update(np.int64(tb).tobytes())
                h.update(np.ascontiguousarray(idx, np.int64).tobytes())
                h.update(b"-" if w is None
                         else np.ascontiguousarray(w, np.float32).tobytes())
        return h.hexdigest()

    # -- length-bucketed batching --------------------------------------------

    def bucket_edge_of(self, length: int) -> int:
        """The smallest bucket edge that fits a sequence of ``length``
        steps (``max_seq_len`` when bucketing is off)."""
        if not self.bucket_edges:
            return self.hps.max_seq_len
        e = int(np.searchsorted(np.asarray(self.bucket_edges), length))
        if e >= len(self.bucket_edges):
            raise ValueError(
                f"sequence length {length} exceeds the terminal bucket "
                f"edge {self.bucket_edges[-1]} (= max_seq_len); the "
                f"corpus was not filtered to max_seq_len")
        return self.bucket_edges[e]

    def _plan_bucket_epoch(self, epoch: int) -> List[tuple]:
        """Epoch ``epoch``'s plan: ``[(tb, idx [B], weights [B] or
        None)]``, a function of ``(seed, epoch)`` alone (its own
        generator, not the augmentation RNG). A seeded permutation is
        binned by raw length, each bucket cut into full batches, and the
        buckets' tails merged in order into the last batches (padded to
        their longest member's edge); the last of those wraps round to
        its own first rows, which weigh 0, so every example weighs 1
        exactly once an epoch. The batch order then goes through the
        windowed shuffle (``bucket_shuffle_window``); with
        ``bucket_run_len > 0`` it shuffles geometry runs of at most that
        many batches as units, so the K-step scheduler finds them
        together."""
        b = self.hps.batch_size
        rng = np.random.default_rng([self.seed & 0x7FFFFFFF, 9176, epoch])
        perm = rng.permutation(len(self.strokes))
        bins: Dict[int, List[int]] = {e: [] for e in self.bucket_edges}
        for i in perm:
            bins[self.bucket_edge_of(int(self._lengths[i]))].append(int(i))
        batches: List[tuple] = []
        tails: List[Tuple[int, int]] = []
        for e in self.bucket_edges:
            arr = bins[e]
            for lo in range(0, len(arr) - len(arr) % b, b):
                batches.append((e, np.array(arr[lo:lo + b], np.int64),
                                None))
            tails.extend((e, i) for i in arr[len(arr) - len(arr) % b:])
        for lo in range(0, len(tails), b):
            chunk = tails[lo:lo + b]
            tb = max(e for e, _ in chunk)
            idx = np.array([i for _, i in chunk], np.int64)
            w = None
            if len(idx) < b:
                w = np.zeros((b,), np.float32)
                w[:len(idx)] = 1.0
                idx = idx[np.arange(b) % len(idx)]
            batches.append((tb, idx, w))
        if self.hps.bucket_run_len > 0:
            runs: List[List[tuple]] = []
            for bt in batches:
                g = (bt[0], bt[2] is None)
                if (runs and (runs[-1][0][0], runs[-1][0][2] is None) == g
                        and len(runs[-1]) < self.hps.bucket_run_len):
                    runs[-1].append(bt)
                else:
                    runs.append([bt])
            shuffled = _windowed_shuffle(runs,
                                         self.hps.bucket_shuffle_window,
                                         rng)
            return [bt for run in shuffled for bt in run]
        return _windowed_shuffle(batches, self.hps.bucket_shuffle_window,
                                 rng)

    @staticmethod
    def _count_geometry_runs(plan: List[tuple]) -> int:
        """Maximal consecutive same-geometry stretches of a plan (a run
        ends wherever ``(Tb, weighted?)`` changes)."""
        runs, prev = 0, None
        for tb, _, w in plan:
            g = (tb, w is None)
            if g != prev:
                runs += 1
                prev = g
        return runs

    def _refill_bucket_queue(self) -> None:
        if not self.strokes:
            raise ValueError("bucketed next_batch on an empty corpus")
        plan = self._plan_bucket_epoch(self._bucket_epoch)
        self._bucket_epoch += 1
        self.padding_ledger.note_epoch_plan(
            self._count_geometry_runs(plan), len(plan))
        self._bucket_queue = plan

    def next_batch(self, int16_scale: Optional[float] = None
                   ) -> Dict[str, np.ndarray]:
        """The next training batch: the bucketed epoch stream when
        ``hps.bucket_edges`` is set (a wrap-filled tail batch carries its
        ``"weights"``), else exactly :meth:`random_batch`."""
        if not self.bucket_edges:
            return self.random_batch(int16_scale)
        if not self._bucket_queue:
            self._refill_bucket_queue()
        tb, idx, w = self._bucket_queue.pop(0)
        batch = self._assemble(idx, int16_scale, pad_to=tb)
        if w is not None:
            batch["weights"] = w
        return batch

    def seek_epoch(self, epoch: int) -> None:
        """Rewind the bucketed stream to the start of ``epoch``'s plan
        (the queue refills at the next draw). Bucketed loaders only."""
        if not self.bucket_edges:
            raise ValueError("seek_epoch requires bucketed execution "
                             "(bucket_edges)")
        self._bucket_queue = []
        self._bucket_epoch = int(epoch)

    def next_stack(self, k_max: int, int16_scale: Optional[float] = None
                   ) -> Dict[str, np.ndarray]:
        """The bucket-run scheduler's feed: up to ``k_max`` consecutive
        batches of the current geometry run (one ``(Tb, weighted?)``),
        stacked ``[k, ...]`` with ``1 <= k <= k_max``; a stack never
        crosses an epoch's end. Successive stacks' micro-batches are the
        :meth:`next_batch` stream of an identically seeded loader."""
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        if not self.bucket_edges:
            raise ValueError(
                "next_stack is the bucketed scheduler's entry point; "
                "with bucket_edges unset use next_batch/random_batch "
                "(fixed-T stacks are plain np.stack over K batches)")
        if not self._bucket_queue:
            self._refill_bucket_queue()
        tb0, _, w0 = self._bucket_queue[0]
        k = 1
        while (k < k_max and k < len(self._bucket_queue)
               and self._bucket_queue[k][0] == tb0
               and (self._bucket_queue[k][2] is None) == (w0 is None)):
            k += 1
        parts = [self.next_batch(int16_scale) for _ in range(k)]
        return {name: np.stack([p[name] for p in parts])
                for name in parts[0]}

    # -- the eval sweep ------------------------------------------------------

    @property
    def num_eval_batches(self) -> int:
        """Batches for a full eval sweep, ``ceil(len / batch_size)`` (of a
        stripe: of the longest stripe's length, the same on every rank):
        the last wrap round to the corpus start so every batch keeps the
        full shape. Zero for an empty split, or when some stripe is
        empty."""
        if self._global_size is None:
            common = longest = len(self.strokes)
        else:
            # the common floor says whether every stripe has rows, the
            # ceiling is the longest stripe
            common = self._global_size // self.num_hosts
            longest = -(-self._global_size // self.num_hosts)
        if common == 0:
            return 0
        b = self.hps.batch_size
        return (longest + b - 1) // b

    def eval_pad_len(self, batch_index: int) -> int:
        """The pad length of eval batch ``batch_index``: the bucket edge
        of its longest row under bucketed execution, else
        ``max_seq_len``. The eval sweep breaks its K-batch runs where it
        changes."""
        if not self.bucket_edges:
            return self.hps.max_seq_len
        idx = self._eval_indices(batch_index)
        return self.bucket_edge_of(int(self._lengths[idx].max()))

    def _eval_indices(self, batch_index: int) -> np.ndarray:
        if not 0 <= batch_index < self.num_eval_batches:
            raise IndexError(f"batch {batch_index} of "
                             f"{self.num_eval_batches}")
        lo = batch_index * self.hps.batch_size
        return np.arange(lo, lo + self.hps.batch_size) % len(self.strokes)

    def get_batch(self, batch_index: int) -> Dict[str, np.ndarray]:
        """Deterministic eval batch ``batch_index`` with a ``"weights"``
        [B] vector: 1 on a row's first occurrence, 0 on the rows that wrap
        around from the corpus start, so weighted eval metrics are exact
        means over the split. Padded to :meth:`eval_pad_len`."""
        lo = batch_index * self.hps.batch_size
        linear = np.arange(lo, lo + self.hps.batch_size)
        idx = self._eval_indices(batch_index)
        pad = self.eval_pad_len(batch_index) if self.bucket_edges else None
        batch = self._assemble(idx, pad_to=pad)
        batch["weights"] = (linear < len(self.strokes)).astype(np.float32)
        return batch


def _windowed_shuffle(items: List, window: int,
                      rng: np.random.Generator) -> List:
    """The JAX package's windowed shuffle (tf.data's): emit a uniform draw
    from a sliding buffer of ``window`` items; a window of at least
    ``len(items)`` is a full shuffle."""
    if len(items) <= 1:
        return list(items)
    out: List = []
    buf: List = []
    for it in items:
        buf.append(it)
        if len(buf) >= max(1, window):
            out.append(buf.pop(int(rng.integers(len(buf)))))
    while buf:
        out.append(buf.pop(int(rng.integers(len(buf)))))
    return out


# -- host striping ---------------------------------------------------------


def _stripe(seqs, labels, host_id: int, num_hosts: int):
    """Host ``host_id``'s disjoint slice of a corpus, every
    ``num_hosts``-th example (the JAX package's ``_stripe``)."""
    if num_hosts <= 1:
        return seqs, labels
    return seqs[host_id::num_hosts], labels[host_id::num_hosts]


def _host_seed(seed: int, host_id: int) -> int:
    """A stripe's loader seed: decorrelated per host."""
    return seed + 7919 * host_id


def _refuse_coordinated(hps: HParams, num_hosts: int,
                        coordinated: Optional[bool],
                        emit_global: bool) -> None:
    """The coordinated plan, asked for or picked as the JAX package
    picks it (``coordinated=None`` with buckets on a striped corpus),
    raises: it comes with the elastic runtime."""
    auto = num_hosts > 1 and bool(hps.bucket_edges)
    if (auto if coordinated is None else coordinated) or emit_global:
        raise NotImplementedError(
            f"{_COORDINATED} (coordinated={coordinated}, emit_global="
            f"{emit_global}, num_hosts={num_hosts}, bucket_edges="
            f"{tuple(hps.bucket_edges)})")


# -- dataset files ---------------------------------------------------------

_SEEDS = {"train": 1, "valid": 2, "test": 3}   # fixed: runs reproduce


def load_dataset(hps: HParams, data_dir: Optional[str] = None,
                 host_id: int = 0, num_hosts: int = 1,
                 scale_factor: Optional[float] = None,
                 skip_bad_records: bool = False,
                 coordinated: Optional[bool] = None,
                 emit_global: bool = False,
                 ) -> Tuple[DataLoader, DataLoader, DataLoader, float]:
    """Read the ``hps.data_set`` ``.npz`` files of ``data_dir`` (default
    ``hps.data_dir``) into train/valid/test loaders; a file's index in
    ``hps.data_set`` is its examples' class label. The train split
    augments; every split is normalized by the full train split's scale
    factor, or by ``scale_factor`` (a checkpoint's, which is part of the
    model contract). A missing or unreadable file, a missing or damaged
    split array, a corrupt record and an empty split each fail with the
    JAX package's one line; ``skip_bad_records`` skips corrupt records
    instead. The files' object arrays are pickled, as QuickDraw's are:
    read only files you trust. ``host_id``/``num_hosts`` stripe every
    split (the module docstring); ``hps.batch_size`` is then the
    stripe's. Returns ``(train, valid, test, scale_factor)``."""
    _refuse_coordinated(hps, num_hosts, coordinated, emit_global)
    data_dir = data_dir or hps.data_dir
    splits = {"train": ([], []), "valid": ([], []), "test": ([], [])}
    for label, name in enumerate(hps.data_set):
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; QuickDraw .npz files are required "
                f"(or use make_synthetic_strokes for a synthetic corpus)")
        try:
            npz = np.load(path, allow_pickle=True, encoding="latin1")
        except Exception as e:  # noqa: BLE001 — np.load's many errors
            raise RuntimeError(
                f"{path}: unreadable .npz ({type(e).__name__}: {e}) — "
                f"corrupt or truncated download?") from None
        with npz:
            for split in splits:
                try:
                    arr = list(npz[split])
                except KeyError:
                    raise RuntimeError(
                        f"{path}: no {split!r} array — not a sketch-rnn "
                        f".npz (needs train/valid/test)") from None
                except Exception as e:  # noqa: BLE001
                    raise RuntimeError(
                        f"{path}: corrupt {split!r} array "
                        f"({type(e).__name__}: {e}) — truncated or "
                        f"damaged .npz member") from None
                seqs = _purify(arr, hps.max_seq_len,
                               source=f"{path}[{split}]",
                               skip_bad=skip_bad_records)
                splits[split][0].extend(seqs)
                splits[split][1].extend([label] * len(seqs))

    def build(split: str, augment: bool) -> DataLoader:
        seqs, labels = splits[split]
        if not seqs:
            raise ValueError(
                f"{split} split is empty after filtering to "
                f"max_seq_len={hps.max_seq_len}; raise max_seq_len or check "
                f"the data files {hps.data_set}")
        # every split is striped: train for data parallelism, valid/test
        # so each global eval batch holds distinct rows
        global_size = len(seqs)
        seqs, labels = _stripe(seqs, labels, host_id, num_hosts)
        return DataLoader(seqs, hps, labels=np.array(labels, np.int32),
                          augment=augment,
                          seed=_host_seed(_SEEDS[split], host_id),
                          global_size=global_size, num_hosts=num_hosts,
                          host_id=host_id)

    train = build("train", augment=True)
    # from the whole train split: every rank normalizes alike
    scale = (scale_factor if scale_factor is not None
             else S.calculate_normalizing_scale_factor(splits["train"][0]))
    valid = build("valid", augment=False)
    test = build("test", augment=False)
    for dl in (train, valid, test):
        dl.normalize(scale)
    return train, valid, test, scale


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
                     coordinated: Optional[bool] = None,
                     emit_global: bool = False,
                     ) -> Tuple[DataLoader, float]:
    """One synthetic-corpus loader sized to ``hps``: ``max(num_classes,
    1)`` figure classes, lengths clamped to fit ``max_seq_len``, offsets
    normalized by the corpus's own scale factor (of the whole corpus,
    before striping) unless ``scale_factor`` is given;
    ``host_id``/``num_hosts`` stripe it as :func:`load_dataset` does.
    Returns ``(loader, scale_factor)``."""
    _refuse_coordinated(hps, num_hosts, coordinated, emit_global)
    seqs, labels = make_synthetic_strokes(
        num, num_classes=max(hps.num_classes, 1),
        max_len=min(96, hps.max_seq_len - 2), seed=seed,
        integer_grid=integer_grid)
    if scale_factor is None:
        scale_factor = S.calculate_normalizing_scale_factor(seqs)
    global_size = len(seqs)
    seqs, labels = _stripe(seqs, labels, host_id, num_hosts)
    loader = DataLoader(seqs, hps, labels=labels, augment=augment,
                        seed=_host_seed(seed, host_id),
                        global_size=global_size, num_hosts=num_hosts,
                        host_id=host_id)
    loader.normalize(scale_factor)
    return loader, scale_factor


def write_synthetic_npz(path: str, num_train: int = 200, num_valid: int = 50,
                        num_test: int = 50, class_id: int = 0,
                        seed: int = 0, **kw) -> None:
    """Write a synthetic corpus as a QuickDraw-shaped single-class
    ``.npz`` file (object arrays ``train``/``valid``/``test`` of stroke-3
    sequences, the splits drawn from seeds ``seed``, ``seed + 1`` and
    ``seed + 2``); ``class_id`` picks the figure family and ``kw`` goes
    to :func:`make_synthetic_strokes`. The same arrays as the JAX
    package's writer for the same arguments."""
    sets = {}
    for split, n, s in (("train", num_train, seed),
                        ("valid", num_valid, seed + 1),
                        ("test", num_test, seed + 2)):
        seqs, _ = make_synthetic_strokes(n, fixed_class=class_id, seed=s,
                                         **kw)
        sets[split] = np.array(seqs, dtype=object)
    np.savez_compressed(path, **sets)
