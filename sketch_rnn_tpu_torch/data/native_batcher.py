"""ctypes binding for the native C++ batch assembler (``native/batcher.cc``).

The port of ``sketch_rnn_tpu/data/native_batcher.py``. ``g++`` builds the
library at first use (``-O3 -shared -fPIC -pthread``) into
``build/native/`` at the repository root (listed in ``.gitignore``),
named by the hash of its source and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is. A build writes to a
per-process temp name and ``os.replace``-s it into place, so concurrent
builders (xdist workers, torchrun ranks) cannot corrupt each other's
output. The loaded library must report ABI version :data:`ABI_VERSION`.

There is no silent fallback: a failed build (its compiler's text in the
error), a failed load or a wrong ABI raises, and so does an overlong row
or a non-zero return code. The loader and :func:`stream_batches` take the
numpy path (:func:`pad_batch_numpy` and numpy augmentation) only when
the caller asks for it by setting ``SKETCH_RNN_TPU_TORCH_NO_NATIVE=1``
(:data:`NO_NATIVE_ENV`, read at each call, so a test can flip it).

Each assembler, :func:`pad_batch_numpy` included, counts its calls
(:func:`call_counts`, :func:`reset_call_counts`), as the kernel wrappers
count launches, so a run can show which path assembled its batches.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from sketch_rnn_tpu_torch.data import strokes as S

ABI_VERSION = 4
SRC = Path(__file__).resolve().parent / "native" / "batcher.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
NO_NATIVE_ENV = "SKETCH_RNN_TPU_TORCH_NO_NATIVE"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_counts: Dict[str, int] = dict.fromkeys(
    ("assemble_batch", "assemble_batch_aug", "assemble_batch_aug_i16",
     "pad_batch_numpy"), 0)

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)
_I, _F, _U64 = ctypes.c_int32, ctypes.c_float, ctypes.c_uint64
_SIGNATURES = {
    "assemble_batch": [_FP, _IP, _I, _I, _FP],
    "assemble_batch_aug": [_FP, _IP, _I, _I, _F, _F, _U64, _I, _FP, _IP],
    "assemble_batch_aug_i16": [_FP, _IP, _I, _I, _F, _F, _U64, _I, _F,
                               ctypes.POINTER(ctypes.c_int16), _IP],
}


def numpy_requested() -> bool:
    """Whether the caller asked for the numpy path
    (``SKETCH_RNN_TPU_TORCH_NO_NATIVE=1``)."""
    return os.environ.get(NO_NATIVE_ENV) == "1"


def lib_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"batcher-v{ABI_VERSION}-{digest[:16]}.so"


def build() -> Path:
    """Build the library if it is not built yet; returns its path. A
    failed build raises with the compiler's output."""
    dest = lib_path()
    if dest.exists():
        return dest
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=f".{os.getpid()}.so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, str(SRC)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(
            f"the native batcher's build ({' '.join(cmd)}) could not run: "
            f"{e}. Set {NO_NATIVE_ENV}=1 to assemble batches in numpy "
            f"instead") from None
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"the native batcher's build failed (exit {out.returncode}): "
            f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")
    os.replace(tmp, dest)
    return dest


def load() -> ctypes.CDLL:
    """The bound library, built first if needed; raises if it cannot be
    built or loaded, or reports another ABI version."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        lib = ctypes.CDLL(str(path))
        lib.batcher_abi_version.restype = ctypes.c_int
        abi = lib.batcher_abi_version()
        if abi != ABI_VERSION:
            raise RuntimeError(f"{path} reports ABI version {abi}, this "
                               f"binding needs {ABI_VERSION}")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Whether batches assemble natively: False only when the caller
    asked for the numpy path; otherwise the library is built and loaded
    (raising if it cannot be)."""
    if numpy_requested():
        return False
    load()
    return True


def call_counts() -> Dict[str, int]:
    """Calls of each assembler since the last :func:`reset_call_counts`."""
    with _lock:
        return dict(_counts)


def reset_call_counts() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0


def _count(name: str) -> None:
    with _lock:
        _counts[name] += 1


def _flatten(seqs: Sequence[np.ndarray], max_len: int):
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    for n in lens:
        if n > max_len:
            raise ValueError(
                f"sequence of length {n} exceeds max_len {max_len}")
    if len(seqs):
        flat = np.ascontiguousarray(np.concatenate(
            [np.asarray(s, np.float32) for s in seqs], axis=0))
    else:
        flat = np.zeros((0, 3), np.float32)
    return lens, flat


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native {name} returned {rc}")


def assemble_batch(seqs: Sequence[np.ndarray], max_len: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad and stroke-5-convert a batch natively (no augmentation):
    ``(strokes [n, max_len + 1, 5] float32, seq_len [n] int32)``, the
    start token at t=0; bit for bit :func:`pad_batch_numpy`."""
    lib = load()
    lens, flat = _flatten(seqs, max_len)
    out = np.empty((len(lens), max_len + 1, 5), dtype=np.float32)
    _count("assemble_batch")
    _check(lib.assemble_batch(flat.ctypes.data_as(_FP),
                              lens.ctypes.data_as(_IP), len(lens),
                              int(max_len), out.ctypes.data_as(_FP)),
           "assemble_batch")
    return out, lens


def pad_batch_numpy(seqs: Sequence[np.ndarray], max_len: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The stroke-5 batch layout in numpy: ``strokes [B, max_len + 1, 5]``
    with the start token ``(0, 0, 1, 0, 0)`` at t=0 and ``seq_len [B]``
    int32. The one implementation behind the loader's numpy path,
    :func:`stream_batches`' numpy path and the serve endpoints'
    ``pad_prefixes``, bit for bit :func:`assemble_batch`."""
    _count("pad_batch_numpy")
    out = np.zeros((len(seqs), max_len + 1, 5), dtype=np.float32)
    lens = np.empty((len(seqs),), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s, np.float32)
        out[i, 1:, :] = S.to_big_strokes(s, max_len)
        out[i, 0, :] = [0, 0, 1, 0, 0]
        lens[i] = len(s)
    return out, lens


def stream_batches(seq_iter: Iterable, batch_size: int, max_len: int,
                   drop_last: bool = False):
    """Stroke-5 batches straight from a stroke-3 stream (e.g.
    ``data/quickdraw.stream_categories``), with no corpus in memory.

    ``seq_iter`` yields stroke-3 arrays or ``(label, stroke3)`` pairs;
    sequences longer than ``max_len``, and empty ones, are dropped (the
    loader's filter). Yields ``{"strokes": [B, max_len + 1, 5] float32,
    "seq_len": [B], "labels": [B] int32}``, assembled natively (numpy
    when asked for, :data:`NO_NATIVE_ENV`); a trailing partial batch
    comes at its true size unless ``drop_last``. The ``records_skipped``
    telemetry counter comes with telemetry (ROADMAP queue 1 item 7c)."""
    if batch_size < 1 or max_len < 1:
        raise ValueError(f"batch_size and max_len must be >= 1, got "
                         f"{batch_size}/{max_len}")

    def flush(buf_seqs, buf_labels):
        assemble = (pad_batch_numpy if numpy_requested()
                    else assemble_batch)
        strokes, lens = assemble(buf_seqs, max_len)
        return {"strokes": strokes, "seq_len": lens,
                "labels": np.asarray(buf_labels, np.int32)}

    buf_seqs: List[np.ndarray] = []
    buf_labels: List[int] = []
    for item in seq_iter:
        label, s3 = item if isinstance(item, tuple) else (0, item)
        s3 = np.asarray(s3, np.float32)
        if len(s3) > max_len or len(s3) == 0:
            continue
        buf_seqs.append(s3)
        buf_labels.append(int(label))
        if len(buf_seqs) == batch_size:
            yield flush(buf_seqs, buf_labels)
            buf_seqs, buf_labels = [], []
    if buf_seqs and not drop_last:
        yield flush(buf_seqs, buf_labels)


def assemble_batch_aug(seqs: Sequence[np.ndarray], max_len: int,
                       scale_factor: float, drop_prob: float, seed: int,
                       n_threads: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Augment, pad and stroke-5-convert a batch natively (the train
    path): per-sequence scale jitter (``scale_factor``) and point dropout
    (``drop_prob``), each sequence drawing from its own counter-based
    stream keyed by ``(seed, index)``, so the result is the same for any
    ``n_threads`` (0 = hardware concurrency). Returns ``(strokes,
    seq_len)`` with the lengths after augmentation."""
    lib = load()
    lens, flat = _flatten(seqs, max_len)
    out = np.empty((len(lens), max_len + 1, 5), dtype=np.float32)
    out_lens = np.empty((len(lens),), dtype=np.int32)
    _count("assemble_batch_aug")
    _check(lib.assemble_batch_aug(
        flat.ctypes.data_as(_FP), lens.ctypes.data_as(_IP), len(lens),
        int(max_len), float(scale_factor), float(drop_prob),
        int(seed) & (2 ** 64 - 1), int(n_threads),
        out.ctypes.data_as(_FP), out_lens.ctypes.data_as(_IP)),
        "assemble_batch_aug")
    return out, out_lens


def assemble_batch_aug_i16(seqs: Sequence[np.ndarray], max_len: int,
                           scale_factor: float, drop_prob: float,
                           seed: int, quant: float, n_threads: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`assemble_batch_aug` with the offsets quantized to int16 data
    units in the same native pass: ``offset * quant`` rounded half to
    even (as ``np.rint``) and clipped to ``±32767``, the pen columns 0/1.
    ``scale_factor=0`` and ``drop_prob=0`` is the unaugmented path.
    ``quant`` must be positive."""
    if not quant > 0:
        raise ValueError(f"quant must be positive, got {quant}")
    lib = load()
    lens, flat = _flatten(seqs, max_len)
    out = np.empty((len(lens), max_len + 1, 5), dtype=np.int16)
    out_lens = np.empty((len(lens),), dtype=np.int32)
    _count("assemble_batch_aug_i16")
    _check(lib.assemble_batch_aug_i16(
        flat.ctypes.data_as(_FP), lens.ctypes.data_as(_IP), len(lens),
        int(max_len), float(scale_factor), float(drop_prob),
        int(seed) & (2 ** 64 - 1), int(n_threads), float(quant),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out_lens.ctypes.data_as(_IP)), "assemble_batch_aug_i16")
    return out, out_lens
