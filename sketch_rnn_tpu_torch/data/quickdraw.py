"""QuickDraw raw ``.ndjson`` -> stroke-3 conversion (dataset creation).

The port of ``sketch_rnn_tpu/data/quickdraw.py``, bit for bit its arrays
and files. The sketch-rnn training sets are per-category ``.npz`` files
of stroke-3 int16 sequences; QuickDraw comes as ``.ndjson`` (one JSON
drawing per line, each stroke ``[[x...], [y...]]``). The canonical
sketch-rnn dataset was made from the raw drawings by (1)
Ramer-Douglas-Peucker simplification at epsilon=2.0 after scaling the
drawing into the 0-255 box and (2) delta encoding with pen-lift bits;
this module does the same, so users can build training sets for
categories, or collections of their own, that have no prebuilt ``.npz``
(the "Simplified Drawing" files have step (1) applied already: pass
``epsilon=0`` for those).

Plain numpy and ``json``; nothing is downloaded. The ``records_skipped``
telemetry counter of a skipped line comes with telemetry (ROADMAP queue
1 item 7c); the warning line on stderr is here.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Iterable, List, Optional, Sequence

import numpy as np


def rdp(points: np.ndarray, epsilon: float) -> np.ndarray:
    """Ramer-Douglas-Peucker polyline simplification.

    ``points``: ``[N, 2]`` float array. Returns the simplified ``[M, 2]``
    subsequence (endpoints always kept). Iterative (explicit stack), so
    pathological polylines cannot hit Python's recursion limit.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    if n <= 2 or epsilon <= 0:
        return np.asarray(points)
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi <= lo + 1:
            continue
        seg = pts[hi] - pts[lo]
        mid = pts[lo + 1:hi]
        rel = mid - pts[lo]
        seg_len = np.hypot(*seg)
        if seg_len == 0.0:
            # degenerate chord: fall back to distance from the point
            d = np.hypot(rel[:, 0], rel[:, 1])
        else:
            # perpendicular distance to the chord (2-D cross product;
            # np.cross on 2-D vectors is deprecated in numpy 2)
            d = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / seg_len
        i = int(np.argmax(d))
        if d[i] > epsilon:
            split = lo + 1 + i
            keep[split] = True
            stack.append((lo, split))
            stack.append((split, hi))
    return np.asarray(points)[keep]


def _align_to_box(strokes: List[np.ndarray], box: float = 255.0
                  ) -> List[np.ndarray]:
    """Translate the drawing to the origin and uniformly scale its larger
    dimension to ``box`` — the canonical QuickDraw normalization applied
    BEFORE RDP, which is what makes epsilon=2.0 resolution-independent
    (raw captures come in arbitrary device coordinates)."""
    allpts = np.concatenate(strokes, axis=0)
    lo = allpts.min(axis=0)
    span = float((allpts - lo).max())
    scale = box / span if span > 0 else 1.0
    return [(s - lo) * scale for s in strokes]


def drawing_to_stroke3(drawing: Sequence[Sequence[Sequence[float]]],
                       epsilon: float = 2.0,
                       max_points: Optional[int] = None,
                       quantize: bool = False) -> np.ndarray:
    """One ndjson ``drawing`` (list of ``[[xs], [ys]]`` strokes) ->
    stroke-3 ``[N, 3]`` float32 (dx, dy, pen_lift).

    Matches the canonical preprocessing: align the drawing to the origin
    and uniformly scale it into the 0-255 box, then per-stroke RDP at
    ``epsilon`` (2.0, resolution-independent thanks to the scaling; 0
    skips BOTH steps for pre-simplified files, which are already in the
    0-255 box), delta encoding from the first point, ``pen_lift=1`` on
    each stroke's last point. ``max_points`` truncates (the loader's
    ``max_seq_len`` filter would otherwise drop very long drawings
    entirely). ``quantize=True`` rounds the ABSOLUTE coordinates to
    integers before diffing, so deltas are exact integer differences
    (the canonical int16 layout) with no cumulative rounding drift —
    rounding per-point deltas instead would random-walk the
    reconstructed positions by several pixels over a long sketch.
    """
    raw_strokes: List[np.ndarray] = []
    for stroke in drawing:
        xy = np.stack([np.asarray(stroke[0], np.float64),
                       np.asarray(stroke[1], np.float64)], axis=1)
        if len(xy):
            raw_strokes.append(xy)
    if not raw_strokes:
        return np.zeros((0, 3), np.float32)
    if epsilon > 0:
        raw_strokes = _align_to_box(raw_strokes)
    pts: List[np.ndarray] = []
    pens: List[np.ndarray] = []
    for xy in raw_strokes:
        xy = rdp(xy, epsilon)
        pen = np.zeros(len(xy))
        pen[-1] = 1.0
        pts.append(xy)
        pens.append(pen)
    xy = np.concatenate(pts, axis=0)
    if quantize:
        xy = np.round(xy)
    pen = np.concatenate(pens, axis=0)
    deltas = np.diff(xy, axis=0, prepend=xy[:1])
    out = np.concatenate([deltas, pen[:, None]], axis=1).astype(np.float32)
    # the first row's delta is 0,0 by construction; the canonical data
    # starts at the first real movement, so drop a leading no-op point
    # unless it also lifts the pen
    if len(out) > 1 and out[0, 0] == 0 and out[0, 1] == 0 and out[0, 2] == 0:
        out = out[1:]
    if max_points is not None:
        out = out[:max_points]
        if len(out):
            out[-1, 2] = 1.0
    return out


def iter_ndjson(lines: Iterable[str],
                recognized_only: bool = True,
                source: str = "<ndjson>",
                skip_bad: bool = False):
    """Yield ``(word, stroke3-ready drawing)`` from ndjson lines.

    ``recognized_only`` keeps only drawings the QuickDraw classifier
    recognized (the canonical datasets do the same).

    A corrupt line (torn JSON from a truncated download, or a record
    without a ``drawing``) fails with ONE line naming ``source`` and the
    line number; ``skip_bad`` skips such lines instead and warns once on
    stderr with their count.
    """
    skipped = 0
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
            drawing = rec["drawing"]
        except (ValueError, KeyError, TypeError) as e:
            if not skip_bad:
                raise ValueError(
                    f"corrupt ndjson record: {source} line {lineno}: "
                    f"{type(e).__name__}: {e}") from None
            skipped += 1
            continue
        if recognized_only and not rec.get("recognized", True):
            continue
        yield rec.get("word", ""), drawing
    if skipped:
        print(f"[data] WARNING: skipped {skipped} corrupt ndjson "
              f"line(s) in {source} (skip_bad)", file=sys.stderr,
              flush=True)


def stream_stroke3(path: str,
                   epsilon: float = 2.0,
                   max_points: Optional[int] = 250,
                   recognized_only: bool = True,
                   skip_bad: bool = False,
                   limit: Optional[int] = None,
                   min_points: int = 2):
    """Stream one category ``.ndjson`` file as stroke-3 arrays.

    The streaming half of :func:`convert_ndjson`: yields
    each drawing's canonical-preprocessed stroke-3 ``[N, 3]`` float32
    array (integer-valued deltas — the same ``quantize=True`` pipeline
    the ``.npz`` conversion writes) WITHOUT materializing the corpus,
    so the full 345-category QuickDraw set can feed a serving fleet's
    prefix corpus or the native batcher one drawing at a time.
    Drawings shorter than ``min_points`` after simplification are
    dropped, exactly like the converter.
    """
    count = 0
    with open(path) as f:
        for _, drawing in iter_ndjson(f, recognized_only=recognized_only,
                                      source=path, skip_bad=skip_bad):
            s3 = drawing_to_stroke3(drawing, epsilon=epsilon,
                                    max_points=max_points,
                                    quantize=True)
            if len(s3) < min_points:
                continue
            yield s3
            count += 1
            if limit is not None and count >= limit:
                return


def stream_categories(data_dir: str, categories: Sequence[str],
                      interleave: bool = True, **kw):
    """Stream ``(label, stroke3)`` pairs from per-category ``.ndjson``
    files under ``data_dir``.

    ``categories`` name the files (``.ndjson`` appended when missing);
    the label is the category's index, matching ``load_dataset``'s
    file-order labeling. ``interleave=True`` (default) round-robins
    one drawing per category so a downstream batch window mixes
    classes the way a pooled corpus would; ``False`` streams each file
    to exhaustion in order. ``**kw`` passes through to
    :func:`stream_stroke3` (epsilon / max_points / limit / skip_bad).
    """
    paths = [os.path.join(
        data_dir, c if c.endswith(".ndjson") else c + ".ndjson")
        for c in categories]
    streams = [stream_stroke3(p, **kw) for p in paths]
    if not interleave:
        for label, stream in enumerate(streams):
            for s3 in stream:
                yield label, s3
        return
    live = list(range(len(streams)))
    while live:
        done = []
        for label in live:
            try:
                yield label, next(streams[label])
            except StopIteration:
                done.append(label)
        for label in done:
            live.remove(label)


def convert_ndjson(in_path: str, out_path: str,
                   epsilon: float = 2.0,
                   max_points: int = 250,
                   num_valid: int = 2500,
                   num_test: int = 2500,
                   limit: Optional[int] = None,
                   seed: int = 0,
                   skip_bad: bool = False) -> dict:
    """Convert one category ``.ndjson`` file to a sketch-rnn ``.npz``.

    Writes ``train``/``valid``/``test`` object arrays of int16 stroke-3
    sequences (the exact layout ``data.loader.load_dataset`` reads and
    the prebuilt sketch-rnn files use). Returns split sizes.
    ``skip_bad`` skips corrupt lines (counted) instead of failing on
    the first one — see :func:`iter_ndjson`.
    """
    # one pipeline: the converter is the streaming reader materialized,
    # so the two cannot drift
    seqs: List[np.ndarray] = [
        s3.astype(np.int16)
        for s3 in stream_stroke3(in_path, epsilon=epsilon,
                                 max_points=max_points,
                                 skip_bad=skip_bad, limit=limit)]
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(seqs))
    seqs = [seqs[i] for i in order]
    n_eval = num_valid + num_test
    if len(seqs) <= n_eval:
        raise ValueError(
            f"{in_path}: only {len(seqs)} usable drawings, need more than "
            f"num_valid+num_test={n_eval}")
    splits = {
        "valid": seqs[:num_valid],
        "test": seqs[num_valid:n_eval],
        "train": seqs[n_eval:],
    }
    def obj_array(v):
        # np.array(v, dtype=object) would build a 3-D object array when
        # every sequence happens to share a length (e.g. max_points
        # truncation) — the canonical layout is a 1-D object array of
        # int16 [N, 3] arrays
        out = np.empty(len(v), dtype=object)
        out[:] = v
        return out

    np.savez_compressed(
        out_path, **{k: obj_array(v) for k, v in splits.items()})
    return {k: len(v) for k, v in splits.items()}
