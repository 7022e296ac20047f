"""Build the port's CUDA kernels and bind them with ctypes.

Each source under ``sketch_rnn_tpu_torch/csrc/`` has a plain C interface
(no PyTorch headers), so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (listed
in ``.gitignore``), named by the hash of its source and flags, so a
changed source is rebuilt at first use and an unchanged one is loaded
as it is. :func:`build_all` starts one ``nvcc`` per source, all at
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

# argtypes of every C entry point, by library
SIGNATURES = {
    "decode": {
        "srt_decode_chunk": [_P] * 19 + [_I] * 6 + [_F] + [_P] * 6,
        "srt_replay_chunk": [_P] * 12 + [_I] * 4 + [_F] + [_P] * 3,
    },
    "fused_rnn": {
        "srt_lstm_seq_fwd": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P] * 3,
        "srt_lstm_seq_bwd": [_P] * 10 + [_I] * 4 + [_F] * 3 + [_P] * 5,
        "srt_ln_lstm_fwd": [_P] * 12 + [_I] * 4 + [_F] * 3 + [_P] * 5,
        "srt_ln_lstm_bwd": [_P] * 16 + [_I] * 4 + [_F] * 3 + [_P] * 10,
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
