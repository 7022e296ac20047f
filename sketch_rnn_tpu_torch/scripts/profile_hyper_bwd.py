"""Where the time of the HyperLSTM backward's loop goes.

``srt_hyper_bwd``'s loop (``csrc/fused_hyper.cu``,
``hyper_bwd_loop_kernel``) runs T serial steps of six phases, each but the
last ended by a grid barrier. This script builds the source a second time
with ``clock64()`` marks in that kernel (inserted at the source lines of
``MARKS``; thread 0 of every block sums the cycles between marks) and runs
the loop stage of the build (``srt_hyper_bwd_stage`` 3, after stages 1-2
of the production library) at the ``hyper`` preset's shape (T=250,
B=100, D=5, H=512, HH=256, e=32, seeded inputs, both per-example biases,
dropout seeded at keep 0.9) at float32 and bfloat16. Per dtype it prints
one JSON line: whether the loop's outputs (the carries' and both
biases' gradients) are bitwise the production loop's,
both builds' ms by CUDA events, and the cycles per step by phase (means
over blocks; a phase that ends in a grid barrier includes the wait for
the last block):

- ``load``: the pairs' dh and dhh from the exchanges (none at the first
  step);
- ``a``, ``b``, ``c``: the LayerNorm gate backward's phases (ln_loop.cuh),
  ``c`` with d_pre's products and the dz partials;
- ``d1``: dz summed over the slices;
- ``d2_dz``: the dz rows staged and their products with w_hz;
- ``d2``: the auxiliary LSTM's backward;
- ``e``: the transposed products;
- ``e_out``: their parts added into the exchanges, the last barrier.

The marks cost a few cycles each (the instrumented build's ms sits beside
the production loop's). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.profile_hyper_bwd

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

PHASES = ("load", "a", "b", "c", "d1", "d2_dz", "d2", "e", "e_out")
MAX_BLOCKS = 1024
# (source line, the phase whose cycles since the last mark it books, put
# after the line); each line appears once in hyper_bwd_loop_kernel
MARKS = (
    ("      __syncthreads();  // s_part, s_pa\n", "load"),
    ("    grid.sync();  // exa complete\n", "a"),
    ("    grid.sync();  // exb complete\n", "b"),
    ("    grid.sync();  // the four streams' step s and exz complete\n", "c"),
    ("    grid.sync();  // dz of step s complete\n", "d1"),
    ("      __syncthreads();  // s_ex read\n    }\n", "d2_dz"),
    ("    grid.sync();  // dh_pre of step s complete\n", "d2"),
    ("    __syncthreads();  // every part of this step's dh and dhh "
     "written\n", "e"),
    ("    if (s > 0) grid.sync();  // dhx and dhhx complete\n", "e_out"),
)
KERNEL = ("template <typename W, typename R, int U, int F>\n__global__ void "
          "__launch_bounds__(kLoopThreads)\nhyper_bwd_loop_kernel")
START = "  __syncthreads();  // the resident state\n"
END = "  for (int e = tid; e < nb * na; e += kLoopThreads) {\n    const int " \
      "bl = e / na, k = e - bl * na, row = b0 + bl;\n    h.dhc0"
T, B, D, H, HH, E = 250, 100, 5, 512, 256, 32
# what the loop writes among hyper_lstm_bwd_entries' outputs: dx_bias,
# dx_bias_hyper, dc0, dh0, dhc0, dhh0 (the rest come from later stages)
LOOP_OUTS = (1, 2, 22, 23, 24, 25)


def _insert(src, line, before, after):
    if src.count(line) != 1:
        raise ValueError(f"csrc/fused_hyper.cu changed: {line.strip()!r} is "
                         f"not one line of the loop; update MARKS")
    return src.replace(line, before + line + after)


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
                  "    if (tid != 0) return;\n"
                  "    const long long now = clock64();\n"
                  "    prof_[q] += now - tick_;\n"
                  "    tick_ = now;\n"
                  "  };\n")
    for line, phase in MARKS:
        src = _insert(src, line, "", f"    mark_({PHASES.index(phase)});\n")
    src = _insert(src, END, f"  if (tid == 0 && blockIdx.x < {MAX_BLOCKS})\n"
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
    cu = _build.BUILD_DIR / f"hyper_profile-{tag}.cu"
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
    """Seeded operands at the preset's shape and the forward's residuals:
    the keyword arguments of ``hyper_lstm_bwd_entries``."""
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
    xs, xb, xbh = f(T, B, D), f(B, 4 * H, sc=0.3), f(B, 4 * HH, sc=0.3)
    h0, hh0 = f(B, H, sc=0.3), f(B, HH, sc=0.3)
    seed_t = torch.tensor(4242, dtype=torch.int32, device=dev)
    drop = dict(dropout_seed=seed_t, keep_prob=0.9, x_bias=xb,
                x_bias_hyper=xbh)
    rdt = None if dt == torch.float32 else dt
    hs, cs, hycs, hyhs = CF.hyper_lstm_fwd(
        xs, w, f(B, H, sc=0.3), h0, f(B, HH, sc=0.3), hh0, 1.0, **drop,
        residual_dtype=rdt)[:4]
    rdt = hs.dtype
    return dict(xs=xs, w=w, h0=h0, hh0=hh0, hs=hs, cs=cs, hycs=hycs,
                hyhs=hyhs, dhs=f(T, B, H, sc=0.01).to(rdt),
                dcT=f(B, H, sc=0.01), dhT=f(B, H, sc=0.01),
                dhcT=f(B, HH, sc=0.01), dhhT=f(B, HH, sc=0.01), **drop)


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
        run_entry, outs = CF.hyper_lstm_bwd_entries(**args)
        for k in (1, 2, 3):     # the streams, the statistics, the loop
            run_entry("srt_hyper_bwd_stage", k)
        torch.cuda.synchronize()
        live = [outs[i] for i in LOOP_OUTS]
        want = [o.clone() for o in live]
        entry_ms = _ms(lambda: run_entry("srt_hyper_bwd_stage", 3))
        real = _build.load("fused_hyper")
        _build._libs["fused_hyper"] = plib   # the same call into the build
        try:
            prof_entry, prof_outs = CF.hyper_lstm_bwd_entries(**args)
        finally:
            _build._libs["fused_hyper"] = real
        for k in (1, 2):
            prof_entry("srt_hyper_bwd_stage", k)
        n = MAX_BLOCKS * 16
        buf = np.zeros(n, dtype=np.uint64)
        _build.check(plib, plib.srt_hyper_profile(buf.ctypes.data, n, 1),
                     "zero")
        prof_entry("srt_hyper_bwd_stage", 3)
        torch.cuda.synchronize()
        _build.check(plib, plib.srt_hyper_profile(buf.ctypes.data, n, 0),
                     "read")
        got = [prof_outs[i] for i in LOOP_OUTS]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
        ms = _ms(lambda: prof_entry("srt_hyper_bwd_stage", 3), 1)
        plan = CF.hyper_bwd_plan(B, H, HH, E, dt)
        cyc = buf.reshape(MAX_BLOCKS, 16)[:plan.slices * plan.tiles]
        cyc = cyc.astype(float) / T
        yield {"dtype": str(dt).replace("torch.", ""), "T": T, "B": B,
               "H": H, "HH": HH, "e": E, "plan": plan._asdict(),
               "bitwise_loop": bitwise, "loop_ms": entry_ms,
               "instrumented_ms": ms,
               "cycles_per_step": {p: float(cyc[:, i].mean())
                                   for i, p in enumerate(PHASES)},
               "cycles_per_step_sum": float(cyc[:, :len(PHASES)].sum(1)
                                            .mean()),
               "device": torch.cuda.get_device_name(dev)}
        del run_entry, outs, prof_entry, prof_outs, want, live, got, args
        torch.cuda.empty_cache()


def main(argv=None):
    for rec in run():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
