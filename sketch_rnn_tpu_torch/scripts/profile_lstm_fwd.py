"""Where the time of the LSTM forward's cooperative loop goes.

``srt_lstm_fwd`` (``csrc/fused_rnn.cu``; its ``lstm_fwd_loop_kernel``
lives in ``csrc/lstm_loops.cuh``, shared with ``csrc/lstm_seq.cu``) runs
T serial steps, each a grid barrier, an exchange of h through L2 and a
product from resident weights. This script builds ``fused_rnn.cu`` a
second time, the header spliced in with ``clock64()`` marks in that
kernel (inserted at the source
lines of ``MARKS``; thread 0 of every block sums the cycles between
marks) and, with ``--rows``, with the rows per thread forced, and runs
each build's ``srt_lstm_fwd`` at the training shapes: B=100, T=250, D=5,
seeded inputs, dropout seeded at keep 0.9; the encoder's H=256
sequence-only form and the decoder's H=512 with ``x_bias`` and the final
carry; float32 and bfloat16 weights and residuals. Per shape, dtype and
build it prints one JSON line: whether every output is bitwise the
row-block design's (``srt_lstm_fwd_rowblock``), the production entry's
and the build's ms by CUDA events, and the cycles per step by phase
(means over blocks):

- ``fetch``: x, x_bias and the mask asked for, the h copies started;
- ``x_part``: x @ wx + b while the copies are in flight;
- ``part_wait``: waiting for each quarter of k of h;
- ``product``: the h @ wh chains;
- ``gate``: the gate block and the stores;
- ``tail_sync`` and ``grid_sync``: the block and grid barriers.

The marks themselves cost a few cycles each (the instrumented build's
ms sits beside the production entry's). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.profile_lstm_fwd [--rows 2 4]

It builds into ``build/kernels/`` and appends to no file.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from sketch_rnn_tpu_torch.ops import _build
from sketch_rnn_tpu_torch.ops import cuda_fused as CF

PHASES = ("fetch", "x_part", "part_wait", "product", "gate", "tail_sync",
          "grid_sync")
MAX_BLOCKS = 1024
# (source line, where the mark goes, phase the cycles since the last mark
# are booked to); each line appears once in csrc/lstm_loops.cuh
MARKS = (
    ("                      kp);\n", "after", "fetch"),
    ("      // h @ wh: one in-order fmaf chain over k per output, part by "
     "part\n", "before", "x_part"),
    ("        cp_async_wait(kParts - 1 - part);\n", "before", "product"),
    ("        __syncthreads();  // this part of k of every row is in s_h\n",
     "after", "part_wait"),
    ("      if (busy) {\n        // the gate block of every row", "before",
     "product"),
    ("      __syncthreads();  // all reads of s_h and s_c done: next chunk\n",
     "before", "gate"),
    ("      __syncthreads();  // all reads of s_h and s_c done: next chunk\n",
     "after", "tail_sync"),
    ("    grid.sync();  // hx[t & 1] complete across the grid\n", "after",
     "grid_sync"),
)
KERNEL = ("template <typename W, typename R, int ROWS, typename X>\n"
          "__global__")
HEADER = '#include "lstm_loops.cuh"\n'    # spliced into fused_rnn.cu
START = ("  __syncthreads();  // the resident state, before the first x part "
         "reads it\n")
END = "  if (a.cT != nullptr && a.T == 0) {"
ROWS_RULE = "  g.rows = sizeof(W) == 4 && nb_max > 4 * kRowLanes ? 4 : 2;\n"
SHAPES = ((256, False), (512, True))     # (H, x_bias and final carry)
T, B, D, KEEP = 250, 100, 5, 0.9


def _insert(src, line, text, before):
    if src.count(line) != 1:
        raise ValueError(f"csrc/lstm_loops.cuh changed: {line.strip()!r} "
                         f"is not one line of the forward kernel; update "
                         f"MARKS")
    return src.replace(line, text + line if before else line + text)


def instrumented_source(rows=None):
    """``csrc/fused_rnn.cu`` with ``csrc/lstm_loops.cuh`` spliced in,
    the marks in its forward loop (and ``rows`` per thread forced when
    given), plus ``srt_fwd_profile`` to read the sums."""
    src = (_build.CSRC / "lstm_loops.cuh").read_text()
    src = _insert(src, KERNEL, f"__device__ unsigned long long "
                  f"g_prof[{MAX_BLOCKS * 8}];\n", True)
    src = _insert(src, START,
                  "  long long prof_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                  "  long long tick_ = clock64();\n"
                  "  auto mark_ = [&](int q) {\n"
                  "    if (tid != 0) return;\n"
                  "    const long long now = clock64();\n"
                  "    prof_[q] += now - tick_;\n"
                  "    tick_ = now;\n"
                  "  };\n", False)
    for line, where, phase in MARKS:
        src = _insert(src, line, f"      mark_({PHASES.index(phase)});\n",
                      where == "before")
    src = _insert(src, END, "  if (tid == 0 && blockIdx.x < "
                  f"{MAX_BLOCKS})\n    for (int q = 0; q < 8; ++q) "
                  "g_prof[blockIdx.x * 8 + q] = prof_[q];\n", True)
    if rows is not None:
        src = _insert(src, ROWS_RULE, f"  g.rows = {int(rows)};\n", False)
        src = src.replace(ROWS_RULE, "")
    fused = (_build.CSRC / "fused_rnn.cu").read_text()
    if fused.count(HEADER) != 1:
        raise ValueError("csrc/fused_rnn.cu no longer includes "
                         "lstm_loops.cuh once; update HEADER")
    src = fused.replace(HEADER, src)
    return src + ('\nextern "C" int srt_fwd_profile(unsigned long long* out, '
                  'int n) {\n  return (int)cudaMemcpyFromSymbol(out, g_prof, '
                  'n * sizeof(unsigned long long));\n}\n')


def build(variants):
    """One nvcc per variant (``None``: the production rows rule), started
    together; returns ``{variant: CDLL}``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        src = instrumented_source(v)
        tag = hashlib.sha256(src.encode()).hexdigest()[:16]
        cu = _build.BUILD_DIR / f"fwd_profile-{tag}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(src)
        procs[v] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the profile build "
                               f"(rows {v}):\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.srt_lstm_fwd.argtypes = _build.SIGNATURES["fused_rnn"][
            "srt_lstm_fwd"]
        lib.srt_lstm_fwd.restype = ctypes.c_int
        lib.srt_fwd_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[v] = lib
    return libs


def inputs(h, full, wdt, seed=0):
    """The forward's inputs at (B, T, D, h), then its arguments, outputs
    and scratch: ``(tensors, args, outs, hx)``. The caller keeps
    ``tensors`` and ``hx`` alive while ``args`` (their addresses) is in
    use."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).cuda()
    zero = torch.zeros((B, h), device="cuda")
    x = dict(xs=r(T, B, D), wx=r(D, 4 * h, sc=0.3).to(wdt), b=r(4 * h, sc=0.1),
             wh=r(h, 4 * h, sc=h ** -0.5).to(wdt),
             c0=r(B, h, sc=0.3) if full else zero,
             h0=r(B, h, sc=0.3) if full else zero,
             seed=torch.tensor(77, dtype=torch.int32, device="cuda"),
             x_bias=r(B, 4 * h, sc=0.3) if full else None)
    args, outs, hx = CF._lstm_fwd_args(
        x["xs"], x["wx"], x["b"], x["wh"], x["c0"], x["h0"], 1.0, None,
        x["seed"], KEEP, x["x_bias"], None if wdt == torch.float32 else wdt,
        full)
    return x, args, outs, hx


def _ms(fn, reps=5):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(variants=(None,)):
    """Yield one record per (H, dtype, build)."""
    from sketch_rnn_tpu_torch.utils.device import resolve_device

    resolve_device()      # a card, or an error
    lib = _build.load("fused_rnn")
    libs = build(variants)
    for h, full in SHAPES:
        for wdt in (torch.float32, torch.bfloat16):
            tensors, args, outs, hx = inputs(h, full, wdt)
            snap = lambda: [o.clone() for o in outs if o is not None]
            _build.check(lib, lib.srt_lstm_fwd_rowblock(*args), "rowblock")
            want = snap()
            prod_ms = _ms(lambda: lib.srt_lstm_fwd(*args))
            for v, plib in libs.items():
                for o in outs:
                    if o is not None:
                        o.fill_(7.0)
                _build.check(lib, plib.srt_lstm_fwd(*args), "profile build")
                torch.cuda.synchronize()
                bitwise = all(torch.equal(a, b)
                              for a, b in zip(snap(), want))
                ms = _ms(lambda: plib.srt_lstm_fwd(*args), 1)
                buf = np.zeros(MAX_BLOCKS * 8, dtype=np.uint64)
                _build.check(lib, plib.srt_fwd_profile(buf.ctypes.data,
                                                        buf.size), "read")
                blocks = (h + 15) // 16 * (torch.cuda.get_device_properties(
                    0).multi_processor_count // ((h + 15) // 16))
                cyc = buf.reshape(MAX_BLOCKS, 8)[:blocks].astype(float) / T
                yield {"H": h, "B": B, "T": T, "full": full,
                       "dtype": str(wdt).split(".")[1],
                       "rows": "rule" if v is None else v,
                       "bitwise_rowblock": bitwise, "entry_ms": prod_ms,
                       "instrumented_ms": ms,
                       "cycles_per_step": {p: float(cyc[:, i].mean())
                                           for i, p in enumerate(PHASES)},
                       "cycles_per_step_sum": float(cyc.sum(1).mean()),
                       "device": torch.cuda.get_device_name(0)}
            del tensors, args, outs, hx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="*", choices=(2, 4),
                    default=[], help="also build with rows per thread forced")
    a = ap.parse_args(argv)
    for rec in run((None, *a.rows)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
