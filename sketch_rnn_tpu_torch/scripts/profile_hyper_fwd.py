"""Where the time of the HyperLSTM forward's loop goes.

``srt_hyper_fwd`` (``csrc/fused_hyper.cu``, ``hyper_fwd_loop_kernel``)
runs T serial steps of five phases, each ended by a grid barrier. This
script builds the source a second time with ``clock64()`` marks in that
kernel (inserted at the source lines of ``MARKS``; thread 0 of every block
sums the cycles between marks) and runs that build's ``srt_hyper_fwd``
beside the production library's at the ``hyper`` preset's shape (T=250,
B=100, D=5, H=512, HH=256, e=32, seeded inputs, both per-example biases,
dropout seeded at keep 0.9) at float32 and bfloat16. Per dtype it prints
one JSON line: whether the instrumented build's outputs are bitwise the
production build's, both builds' ms by CUDA events, and the cycles per step
by phase (means over blocks):

- ``products``: a products pass's rows staged and its tasks' sums (h @
  wh, h @ wxh_h, hh @ whh), summed over the passes;
- ``aux``: the auxiliary LSTM's gates of a pass's pairs, over the passes;
- ``z``: the block's share of z (hh_t staged, the chains over HH);
- ``scales``: z staged, xp, the block scales, pre and the gates' slice
  moments;
- ``cell``: the gate norms, the gate block and the cell's slice moments;
- ``h``: the cell norm, h and the stores;
- ``barrier``: the five grid barriers, each including its wait for the
  last block.

The marks cost a few cycles each (the instrumented build's ms sits beside
the production loop's). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.profile_hyper_fwd

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
from sketch_rnn_tpu_torch.ops import cuda_fused as CF

PHASES = ("products", "aux", "z", "scales", "cell", "h", "barrier")
MAX_BLOCKS = 1024
# (source line of hyper_fwd_loop_kernel, the phase booked by a mark put
# before it, the phase booked by a mark put after it); each line appears
# once in csrc/fused_hyper.cu
MARKS = (
    ("      __syncthreads();  // the auxiliary sums complete, the rows "
     "read\n", None, "products"),
    ("      }  // the pass's auxiliary gates\n", None, "aux"),
    ("    grid.sync();  // hp and hh_t complete\n", None, "barrier"),
    ("    grid.sync();  // z complete\n", "z", "barrier"),
    ("    grid.sync();  // the gates' slice moments complete\n", "scales",
     "barrier"),
    ("    grid.sync();  // the cell's slice moments complete\n", "cell",
     "barrier"),
    ("    grid.sync();  // hx and h_t complete\n", "h", "barrier"),
)
KERNEL = ("template <typename W, typename R, int U>\n__global__ void "
          "__launch_bounds__(kFwdThreads)\nhyper_fwd_loop_kernel")
START = "  __syncthreads();  // the resident state, before any phase reads it\n"
END = "  if (a.T == 0) {  // no step: the final carries are the first\n"
T, B, D, H, HH, E = 250, 100, 5, 512, 256, 32


def _insert(src, line, before, after):
    if src.count(line) != 1:
        raise ValueError(f"csrc/fused_hyper.cu changed: {line.strip()!r} is "
                         f"not one line of the loop; update MARKS")
    return src.replace(line, before + line + after)


def _mark(phase):
    return "" if phase is None else f"    mark_({PHASES.index(phase)});\n"


def instrumented_source():
    """``csrc/fused_hyper.cu`` with the marks, plus ``srt_hyper_profile``
    to read the sums."""
    n = len(PHASES)
    src = (_build.CSRC / "fused_hyper.cu").read_text()
    src = _insert(src, KERNEL, f"__device__ unsigned long long "
                  f"g_prof[{MAX_BLOCKS * 16}];\n", "")
    src = _insert(src, START, "",
                  f"  long long prof_[{n}] = {{0}};\n"
                  "  long long tick_ = clock64();\n"
                  "  auto mark_ = [&](int q) {\n"
                  "    if (threadIdx.x != 0) return;\n"
                  "    const long long now = clock64();\n"
                  "    prof_[q] += now - tick_;\n"
                  "    tick_ = now;\n"
                  "  };\n")
    for line, before, after in MARKS:
        src = _insert(src, line, _mark(before), _mark(after))
    src = _insert(src, END, f"  if (threadIdx.x == 0 && blockIdx.x < "
                  f"{MAX_BLOCKS})\n"
                  f"    for (int q = 0; q < {n}; ++q)\n"
                  f"      g_prof[blockIdx.x * 16 + q] += prof_[q];\n", "")
    return src + _READER


# reads (or zeroes) the sums of the marked build
_READER = '''
static void* g_prof_addr() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_prof);
  return p;
}

extern "C" int srt_hyper_profile(unsigned long long* out, int n, int zero) {
  if (zero)
    return (int)cudaMemset(g_prof_addr(), 0, n * sizeof(unsigned long long));
  return (int)cudaMemcpyFromSymbol(out, g_prof,
                                   n * sizeof(unsigned long long));
}
'''


def build():
    """The instrumented library, bound like the production one."""
    src = instrumented_source()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cu = _build.BUILD_DIR / f"hyper_fwd_profile-{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the profile build:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES["fused_hyper"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    lib.srt_hyper_profile.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    return lib


def inputs(dt, dev, seed=0):
    """Seeded operands at the preset's shape: the keyword arguments of
    ``hyper_lstm_fwd_entries``."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    w = CF.HyperWeights(
        wx=f(D, 4 * H, sc=0.4), b=f(4 * H, sc=0.1),
        wh=f(H, 4 * H, sc=H ** -0.5), wxh_x=f(D, 4 * HH, sc=0.4),
        wxh_h=f(H, 4 * HH, sc=H ** -0.5), bh=f(4 * HH, sc=0.1),
        whh=f(HH, 4 * HH, sc=HH ** -0.5), w_hz_x=f(HH, 4 * E, sc=0.1),
        b_hz_x=1 + f(4 * E, sc=0.1), w_hz_h=f(HH, 4 * E, sc=0.1),
        b_hz_h=1 + f(4 * E, sc=0.1), w_hz_b=f(HH, 4 * E, sc=0.1),
        zd_x=0.1 / E + f(4, E, H, sc=0.02),
        zd_h=0.1 / E + f(4, E, H, sc=0.02), zd_b=f(4, E, H, sc=0.02),
        ln_gamma=1 + f(4, H, sc=0.1), ln_beta=f(4, H, sc=0.1),
        lnc_gamma=1 + f(H, sc=0.1), lnc_beta=f(H, sc=0.1))
    w = w._replace(**{n: getattr(w, n).to(dt) for n in CF.HYPER_MATRICES})
    return dict(xs=f(T, B, D), w=w, c0=f(B, H, sc=0.3), h0=f(B, H, sc=0.3),
                hc0=f(B, HH, sc=0.3), hh0=f(B, HH, sc=0.3),
                dropout_seed=torch.tensor(4242, dtype=torch.int32,
                                          device=dev),
                keep_prob=0.9, x_bias=f(B, 4 * H, sc=0.3),
                x_bias_hyper=f(B, 4 * HH, sc=0.3),
                residual_dtype=None if dt == torch.float32 else dt)


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
    """Yield one record per dtype (float32, then bfloat16)."""
    from sketch_rnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device()      # a card, or an error
    plib = build()
    for dt in (torch.float32, torch.bfloat16):
        args = inputs(dt, dev)
        run_entry, outs = CF.hyper_lstm_fwd_entries(**args)
        run_entry("srt_hyper_fwd")
        torch.cuda.synchronize()
        want = [o.clone() for o in outs]
        entry_ms = _ms(lambda: run_entry("srt_hyper_fwd"))
        real = _build.load("fused_hyper")
        _build._libs["fused_hyper"] = plib   # the same call into the build
        try:
            prof_entry, prof_outs = CF.hyper_lstm_fwd_entries(**args)
        finally:
            _build._libs["fused_hyper"] = real
        n = MAX_BLOCKS * 16
        buf = np.zeros(n, dtype=np.uint64)
        _build.check(plib, plib.srt_hyper_profile(buf.ctypes.data, n, 1),
                     "zero")
        prof_entry("srt_hyper_fwd")
        torch.cuda.synchronize()
        _build.check(plib, plib.srt_hyper_profile(buf.ctypes.data, n, 0),
                     "read")
        bitwise = all(torch.equal(a, b) for a, b in zip(prof_outs, want))
        ms = _ms(lambda: prof_entry("srt_hyper_fwd"), 1)
        plan = CF.hyper_fwd_plan(B, D, H, HH, E, dt)
        cyc = buf.reshape(MAX_BLOCKS, 16)[:plan.slices * plan.tiles]
        cyc = cyc.astype(float) / T
        yield {"dtype": str(dt).replace("torch.", ""), "T": T, "B": B,
               "H": H, "HH": HH, "e": E, "plan": plan._asdict(),
               "bitwise": bitwise, "ms": entry_ms, "instrumented_ms": ms,
               "cycles_per_step": {p: float(cyc[:, i].mean())
                                   for i, p in enumerate(PHASES)},
               "cycles_per_step_sum": float(cyc[:, :len(PHASES)].sum(1)
                                            .mean()),
               "device": torch.cuda.get_device_name(dev)}
        del run_entry, outs, prof_entry, prof_outs, want, args
        torch.cuda.empty_cache()


def main(argv=None):
    for rec in run():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
