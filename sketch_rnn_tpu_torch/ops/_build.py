"""Build the port's CUDA kernels and bind them with ctypes.

Each source under ``sketch_rnn_tpu_torch/csrc/`` has a plain C interface
(no PyTorch headers), so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (listed
in ``.gitignore``), named by the hash of its source and flags, so a
changed source is rebuilt at first use and an unchanged one is loaded
as it is (the shared headers ``csrc/*.cuh`` count as part of every
source). :func:`build_all` starts one ``nvcc`` per source, all at
once. ``nvcc`` is looked up in ``$CUDA_HOME/bin``, then
``/usr/local/cuda/bin``, then ``PATH``; a missing compiler is an error.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_WG = [_I, _I, _P]      # the weight pass's plan: slices, kslice, scratch
_PS = [_I] * 5          # the probe loop's plan: slices, tiles, chunk,
                        # windows, shared memory
# the HyperLSTM backward: its operands, the loop's plan (units, split,
# slices, tiles, windows, parts, shared memory), its scratch (streams,
# work, partials and their floats), its outputs
_HB = ([_P] * 35 + [_I] * 8 + [_F] * 3 + [_I] * 7 + [_P] * 3 + [_I]
       + [_P] * 20)

# argtypes of every C entry point, by library
SIGNATURES = {
    "decode": {
        # the persistent loop: its plan (slices, tiles, windows, shared
        # memory) and its scratch before the outputs
        "srt_decode_chunk": [_P] * 19 + [_I] * 7 + [_F] + [_I] * 4
        + [_P] * 7,
        "srt_replay_chunk": [_P] * 12 + [_I] * 5 + [_F] + [_I] * 4
        + [_P] * 4,
        "srt_decode_chunk_rowblock": [_P] * 19 + [_I] * 7 + [_F] + [_P] * 6,
        "srt_replay_chunk_rowblock": [_P] * 12 + [_I] * 5 + [_F] + [_P] * 3,
    },
    "fused_rnn": {
        "srt_lstm_fwd": [_P] * 9 + [_I] * 6 + [_F] * 3 + [_P] * 6,
        "srt_lstm_fwd_rowblock": [_P] * 9 + [_I] * 6 + [_F] * 3 + [_P] * 6,
        "srt_lstm_bwd": [_P] * 13 + [_I] * 6 + [_F] * 3 + [_P] * 8 + _WG
        + [_P],
        "srt_lstm_bwd_stage": [_I] + [_P] * 13 + [_I] * 6 + [_F] * 3
        + [_P] * 8 + _WG + [_P],
        "srt_lstm_bwd_rowblock": [_P] * 13 + [_I] * 6 + [_F] * 3 + [_P] * 8
        + _WG + [_P],
        "srt_ln_lstm_fwd": [_P] * 12 + [_I] * 6 + [_F] * 3 + [_P] * 7,
        "srt_ln_lstm_fwd_rowblock": [_P] * 12 + [_I] * 6 + [_F] * 3
        + [_P] * 7,
        "srt_ln_lstm_bwd": [_P] * 16 + [_I] * 6 + [_F] * 3 + [_P] * 10
        + _WG + [_P],
        "srt_ln_lstm_bwd_stage": [_I] + [_P] * 16 + [_I] * 6 + [_F] * 3
        + [_P] * 10 + _WG + [_P],
        "srt_ln_lstm_bwd_rowblock": [_P] * 16 + [_I] * 6 + [_F] * 3
        + [_P] * 10 + _WG + [_P],
        "srt_weight_grad": [_I] + [_P] * 4 + [_I] * 7 + _WG + [_P] * 4,
    },
    "lstm_seq": {       # its loops are lstm_loops.cuh's, shared with
                        # fused_rnn.cu (hashed with every source)
        "srt_lstm_seq_fwd": [_P] * 5 + [_I] * 3 + [_F] + [_P] * 7,
        "srt_lstm_seq_fwd_rowblock": [_P] * 5 + [_I] * 3 + [_F] + [_P] * 7,
        "srt_lstm_seq_bwd": [_P] * 9 + [_I] * 3 + [_P] * 4 + _WG + [_P],
        "srt_lstm_seq_bwd_stage": [_I] + [_P] * 9 + [_I] * 3 + [_P] * 4
        + _WG + [_P],
        "srt_lstm_seq_bwd_rowblock": [_P] * 9 + [_I] * 3 + [_P] * 4 + _WG
        + [_P],
    },
    "probe_seq": {
        "srt_dual_seq_fwd": [_P] * 8 + [_I] * 5 + [_F] + _PS + [_P] * 6,
        "srt_seq_fwd": [_P] * 4 + [_I] * 5 + [_F] + _PS + [_P] * 4,
        "srt_dual_seq_fwd_rowblock": [_P] * 8 + [_I] * 6 + [_F] + [_P] * 5,
        "srt_seq_fwd_rowblock": [_P] * 4 + [_I] * 6 + [_F] + [_P] * 3,
    },
    "probe_ln": {       # its loops are ln_lstm.cuh's, shared with
                        # fused_rnn.cu: the arm, the operands, the
                        # scratch, then the forced windows (0: the plan's)
        "srt_ln_probe_fwd": [_I] + [_P] * 11 + [_I] * 6 + [_F] * 3
        + [_P] * 6 + [_I, _P],
        "srt_ln_probe_bwd": [_I] + [_P] * 15 + [_I] * 6 + [_F] * 3
        + [_P] * 10 + _WG + [_I, _P],
        "srt_ln_probe_fwd_rowblock": [_I] + [_P] * 11 + [_I] * 6 + [_F] * 3
        + [_P] * 5,
        "srt_ln_probe_bwd_rowblock": [_I] + [_P] * 15 + [_I] * 6 + [_F] * 3
        + [_P] * 9 + _WG + [_P],
    },
    "fused_hyper": {
        "srt_hyper_fwd": [_P] * 28 + [_I] * 8 + [_F] * 3 + [_I] * 8
        + [_P] * 11,
        "srt_hyper_fwd_rowblock": [_P] * 28 + [_I] * 8 + [_F] * 3 + [_P] * 9,
        "srt_hyper_bwd": _HB,
        "srt_hyper_bwd_stage": [_I] + _HB,
        "srt_hyper_bwd_rowblock": [_P] * 35 + [_I] * 8 + [_F] * 3
        + [_P] * 30,
    },
}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from "
            "sketch_rnn_tpu_torch/csrc at first use and need the CUDA "
            "toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):      # shared by the sources
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> None:
    """Build every named source that is not built yet (default: all of
    ``SIGNATURES``), one nvcc process each, started together. Each
    library is written to a temp file and renamed into place."""
    names = list(SIGNATURES) if names is None else names
    with _lock:
        missing = [n for n in names if not _lib_path(n).exists()]
        if not missing:
            return
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started = []
        for n in missing:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
            started.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for n, tmp, proc in started:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed for csrc/{n}.cu (exit "
                              f"{proc.returncode}):\n{log}")
            else:
                os.replace(tmp, _lib_path(n))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.srt_error_string.argtypes = [ctypes.c_int]
            lib.srt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib.srt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
