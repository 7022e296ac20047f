"""Where the time of the probe loop goes.

``srt_dual_seq_fwd`` and ``srt_seq_fwd`` (``csrc/probe_seq.cu``,
``probe_loop_kernel``) run T serial steps; each passes over the block's
batch tile in chunks of h rows (staged by cp.async, multiplied on the
tensor cores, then the gate blocks) and ends in a grid barrier. This
script builds the source a second time with ``clock64()`` marks in that
kernel (inserted at the source lines of ``MARKS``; thread 0 of every
block sums the cycles between marks) and runs the build's entries at the
probes' shape (T=250, B=4096, H=256, D=5, bfloat16, the probes' seeded
inputs): the dual forward and one direction at both gate forms. Per case
it prints one JSON line: whether the outputs are bitwise the production
entry's, both builds' ms by CUDA events, and the cycles per step by
phase (means over blocks):

- ``wait``: the chunk's h copies and the block barrier before the product;
- ``issue``: the next chunk's copies started;
- ``product``: the ``mma.sync`` loop over k;
- ``gate``: the shuffles, the x part and the gate blocks, staged, and the
  next chunk's x asked for;
- ``staged``: the block barrier after them;
- ``stores``: hs, cs and the exchange written;
- ``grid_sync``: the grid barrier.

The marks cost a few cycles each (the instrumented build's ms sits beside
the production entry's). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.profile_probe_seq

It builds into ``build/kernels/`` and appends to no file.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from sketch_rnn_tpu_torch.ops import _build
from sketch_rnn_tpu_torch.scripts import _probe
from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as PB
from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as PD

PHASES = ("wait", "issue", "product", "gate", "staged", "stores",
          "grid_sync")
MAX_BLOCKS = 1024
# (source line, where the marks go, the phases whose cycles since the last
# mark they book); each line appears once in probe_loop_kernel
MARKS = (
    ("      __syncthreads();  // chunk c in its buffer; the staging area "
     "free\n", (), ("wait",)),
    ("      if (t > 0 && c + 1 < nchunks) load_chunk(rc0 + chunk, buf ^ 1);"
     "\n", (), ("issue",)),
    ("        // the epilogue of every (row, unit) of the warp's tile: the\n",
     ("product",), ()),
    ("      __syncthreads();  // the chunk's outputs staged\n", ("gate",),
     ("staged",)),
    ("    if (t + 1 < a.T) grid.sync();  // hx[t & 1] complete across the "
     "grid\n", ("stores",), ("grid_sync",)),
)
KERNEL = ("template <int DIRS, int GATES, typename R>\n__global__ void "
          "__launch_bounds__(kPsThreads)\nprobe_loop_kernel")
START = ("  __syncthreads();  // the resident state, before the first step "
         "reads it\n")
END = "  }\n}\n\n// A probe loop's plan"
T, B, H, D = 250, 4096, 256, 5


def _insert(src, line, before, after):
    if src.count(line) != 1:
        raise ValueError(f"csrc/probe_seq.cu changed: {line.strip()!r} is "
                         f"not one line of the probe loop; update MARKS")
    return src.replace(line, before + line + after)


def instrumented_source():
    """``csrc/probe_seq.cu`` with the marks, plus ``srt_probe_profile`` to
    read the sums."""
    src = (_build.CSRC / "probe_seq.cu").read_text()
    src = _insert(src, KERNEL, f"__device__ unsigned long long "
                  f"g_prof[{MAX_BLOCKS * 8}];\n", "")
    src = _insert(src, START, "",
                  "  long long prof_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                  "  long long tick_ = clock64();\n"
                  "  auto mark_ = [&](int q) {\n"
                  "    if (tid != 0) return;\n"
                  "    const long long now = clock64();\n"
                  "    prof_[q] += now - tick_;\n"
                  "    tick_ = now;\n"
                  "  };\n")
    mark = lambda ps: "".join(f"      mark_({PHASES.index(p)});\n"
                              for p in ps)
    for line, before, after in MARKS:
        src = _insert(src, line, mark(before), mark(after))
    src = _insert(src, END, "", "")
    src = src.replace(END, f"  }}\n  if (tid == 0 && blockIdx.x < "
                      f"{MAX_BLOCKS})\n    for (int q = 0; q < 8; ++q) "
                      f"g_prof[blockIdx.x * 8 + q] = prof_[q];\n}}\n\n"
                      f"// A probe loop's plan")
    return src + ('\nextern "C" int srt_probe_profile(unsigned long long* '
                  'out, int n) {\n  return (int)cudaMemcpyFromSymbol(out, '
                  'g_prof, n * sizeof(unsigned long long));\n}\n')


def build():
    """The instrumented library, bound like the production one."""
    src = instrumented_source()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cu = _build.BUILD_DIR / f"probe_profile-{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the profile build:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES["probe_seq"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    lib.srt_probe_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _ms(fn, reps=3):
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


def run():
    """Yield one record per case: the dual forward, then one direction at
    float32 and at bfloat16 gates."""
    from sketch_rnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device()      # a card, or an error
    plib = build()
    xs, xs_rev, w = PD.probe_inputs(T, B, H, D, 1, dev)
    fwd = (xs[0], w["wx_f"], w["b_f"], w["wh_f"])
    cases = (("dual_seq_fwd", 2, lambda: PD.dual_seq_fwd_entries(
        xs[0], xs_rev[0], *fwd[1:], w["wx_b"], w["b_b"], w["wh_b"])),
             ("seq_fwd f32 gates", 1, lambda: PB.seq_fwd_entries(*fwd,
                                                                 False)),
             ("seq_fwd bf16 gates", 1, lambda: PB.seq_fwd_entries(*fwd,
                                                                  True)))
    for name, dirs, entries in cases:
        run_entry, outs = entries()
        run_entry("loop")
        torch.cuda.synchronize()
        want = [o.clone() for o in outs]
        entry_ms = _ms(lambda: run_entry("loop"))
        real = _build.load("probe_seq")
        _build._libs["probe_seq"] = plib   # the same call into the build
        try:
            for o in outs:
                o.fill_(7.0)
            run_entry("loop")
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(outs, want))
            ms = _ms(lambda: run_entry("loop"), 1)
        finally:
            _build._libs["probe_seq"] = real
        buf = np.zeros(MAX_BLOCKS * 8, dtype=np.uint64)
        _build.check(plib, plib.srt_probe_profile(buf.ctypes.data, buf.size),
                     "read")
        blocks = _probe.device_plan(dev, B, H, D, dirs).blocks(dirs)
        cyc = buf.reshape(MAX_BLOCKS, 8)[:blocks].astype(float) / T
        yield {"case": name, "T": T, "B": B, "H": H, "D": D,
               "bitwise_entry": bitwise, "entry_ms": entry_ms,
               "instrumented_ms": ms,
               "cycles_per_step": {p: float(cyc[:, i].mean())
                                   for i, p in enumerate(PHASES)},
               "cycles_per_step_sum": float(cyc[:, :len(PHASES)].sum(1)
                                            .mean()),
               "device": torch.cuda.get_device_name(dev)}
        del run_entry, outs, want
        torch.cuda.empty_cache()


def main(argv=None):
    for rec in run():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
