"""Where the time of the serving loop goes.

``srt_decode_chunk`` and ``srt_replay_chunk`` (``csrc/decode.cu``,
``serve_loop_kernel``) run K (or E) serial steps of phases ended by grid
barriers. This script builds the source a second time with ``clock64()``
marks in that kernel (inserted at the source lines of ``MARKS``; thread 0
of every block sums the cycles between marks) and runs that build beside
the production library at the serving shapes (B=64 slots, K=8 steps, H=512,
M=20, Nz=128; replay at E=64; seeded random weights, every 4th row's cap
mid-chunk, every 16th row done at the start) for both cells at float32 and
bfloat16. Per case it prints one JSON line: whether the instrumented
build's outputs are bitwise the production build's, both builds' ms by
CUDA events, the cycles of the launch's staging and the cycles per step by
phase (means over blocks):

- ``staging``: the resident columns' copies issued, the rest of the
  resident state read (once a launch);
- ``first_products``: step 0's products, including the wait for the
  resident wh and wx columns (once a launch);
- ``products``: the later steps' products (the h rows staged, the chains);
- ``moments``: LN: each gate's slice moments to the exchange;
- ``norms``: LN: the gate norms, the gate block, the cell's moments;
- ``cell``: LN: the cell norm; both cells: h, the freeze, hx, and (decode)
  the projection partials; lstm: also the gate block;
- ``raw``: decode: each owned row's partials summed over the slices;
- ``sampler``: decode: the owned rows' draws on one warp each;
- ``barrier``: the grid barriers, each including its wait for the last
  block.

``staging`` and ``first_products`` are per launch, ``products`` per step
after the first, the other phases per step over all steps (so a later
step's cycles are their sum). The marks cost a
few cycles each. Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.profile_decode

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
from sketch_rnn_tpu_torch.ops import cuda_decode as cd

PHASES = ("staging", "first_products", "products", "moments", "norms",
          "cell", "raw", "sampler", "barrier")
PER_LAUNCH = ("staging", "first_products")
MAX_BLOCKS = 1024
# (source line of serve_loop_kernel, the mark put before it, the mark put
# after it); each line appears once in csrc/decode.cu
_P = {p: f"{i}" for i, p in enumerate(PHASES)}
MARKS = (
    ("  __syncthreads();  // the resident state (wh and wx: at the first "
     "product)\n", None, _P["staging"]),
    ("      __syncthreads();  // the pass's h rows read, its pre in s_pre\n"
     "    }\n", None,
     f"t == 0 ? {_P['first_products']} : {_P['products']}"),
    ("      grid.sync();  // the gates' slice moments complete\n",
     _P["moments"], _P["barrier"]),
    ("      grid.sync();  // the cell's slice moments complete\n",
     _P["norms"], _P["barrier"]),
    ("      if (t + 1 < a.steps) grid.sync();  // hx[t & 1] complete\n",
     _P["cell"], _P["barrier"]),
    ("    grid.sync();  // hx[t & 1] and the projection partials complete\n",
     _P["cell"], _P["barrier"]),
    ("      __syncthreads();  // the row's raw in s_raw\n", None, _P["raw"]),
    ("    if (t + 1 < a.steps) grid.sync();  // the strokes: step t + 1's x\n",
     _P["sampler"], _P["barrier"]),
)
KERNEL = ("template <typename W, bool LN, bool DEC>\n__global__ void "
          "__launch_bounds__(kDecThreads, 1)\nserve_loop_kernel")
START = "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
END = "  __syncthreads();  // the last step's carries and owned rows\n"
B, K, E, H, M, NZ = 64, 8, 64, 512, 20, 128


def _insert(src, line, before, after):
    if src.count(line) != 1:
        raise ValueError(f"csrc/decode.cu changed: {line.strip()!r} is not "
                         f"one line of the loop; update MARKS")
    return src.replace(line, before + line + after)


def _mark(q):
    return "" if q is None else f"    mark_({q});\n"


def instrumented_source():
    """``csrc/decode.cu`` with the marks, plus ``srt_decode_profile`` to
    read the sums."""
    n = len(PHASES)
    src = (_build.CSRC / "decode.cu").read_text()
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

extern "C" int srt_decode_profile(unsigned long long* out, int n, int zero) {
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
    cu = _build.BUILD_DIR / f"decode_profile-{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the profile build:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES["decode"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    lib.srt_decode_profile.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int]
    return lib


def inputs(cell, dt, dev, policy, seed=0):
    """Seeded operands at the serving shapes: ``(args, kw)`` of
    ``decode_chunk_entries`` (policy ``"decode"``) or
    ``replay_chunk_entries``."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    cp = {"wx": f(5 + NZ, 4 * H, sc=0.4).to(dt), "wh": f(H, 4 * H, sc=H ** -0.5)
          .to(dt)}
    if cell == "lstm":
        cp["b"] = f(4 * H, sc=0.1)
    else:
        cp.update(ln_gamma=1 + f(4, H, sc=0.1), ln_beta=f(4, H, sc=0.1),
                  lnc_gamma=1 + f(H, sc=0.1), lnc_beta=f(H, sc=0.1))
    z = f(B, NZ)
    c0, h0 = f(B, H, sc=0.3), f(B, H, sc=0.3)
    cdt = None if dt == torch.float32 else dt
    kw = dict(cell_kind=cell, compute_dtype=cdt)
    if policy == "replay":
        xs = f(E, B, 5)
        seq_len = torch.randint(1, E + 1, (B,), generator=g,
                                dtype=torch.int32).to(dev)
        return (cp, c0, h0, xs, z, seq_len), kw
    out_b = f(6 * M + 3, sc=0.1)
    out_b[2] = -3.0       # most rows draw through the chunk
    t0 = torch.randint(0, 200, (B,), generator=g, dtype=torch.int32)
    caps = torch.where(torch.arange(B) % 4 == 0, t0 + 3, t0 + 250)
    keys = torch.randint(0, 2 ** 32, (B, 2), generator=g, dtype=torch.int64)
    u = cd.make_uniforms(keys, t0, K).to(dev)
    args = (cp, f(H, 6 * M + 3, sc=H ** -0.5).to(dt), out_b, c0, h0,
            torch.tensor([0, 0, 1.0, 0, 0]).repeat(B, 1).to(dev), z, u,
            (0.4 + torch.rand((B,), generator=g)).to(dev), t0.to(dev),
            (torch.arange(B) % 16 == 3).to(dev), caps.to(dev),
            torch.tensor([0, 0, 0, 0, 1.0]).to(dev))
    return args, dict(kw, num_mixture=M)


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


CASES = tuple((policy, cell, dt) for policy in ("decode", "replay")
              for cell in ("layer_norm", "lstm")
              for dt in (torch.float32, torch.bfloat16))


def run(cases=CASES):
    """Yield one record per case ``(policy, cell, dtype)``."""
    from sketch_rnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device()      # a card, or an error
    plib = build()
    for policy, cell, dt in cases:
        args, kw = inputs(cell, dt, dev, policy)
        entries = (cd.decode_chunk_entries if policy == "decode"
                   else cd.replay_chunk_entries)
        entry = f"srt_{policy}_chunk"
        run_entry, outs = entries(*args, **kw)
        run_entry(entry)
        torch.cuda.synchronize()
        want = [o.clone() for o in outs]
        entry_ms = _ms(lambda: run_entry(entry))
        real = _build.load("decode")
        _build._libs["decode"] = plib    # the same call into the build
        try:
            prof_entry, prof_outs = entries(*args, **kw)
        finally:
            _build._libs["decode"] = real
        n = MAX_BLOCKS * 16
        buf = np.zeros(n, dtype=np.uint64)
        _build.check(plib, plib.srt_decode_profile(buf.ctypes.data, n, 1),
                     "zero")
        prof_entry(entry)
        torch.cuda.synchronize()
        _build.check(plib, plib.srt_decode_profile(buf.ctypes.data, n, 0),
                     "read")
        bitwise = all(torch.equal(a, b) for a, b in zip(prof_outs, want))
        ms = _ms(lambda: prof_entry(entry), 3)
        plan = cd.decode_plan(B, H, M, dt, policy)
        steps = K if policy == "decode" else E
        cyc = buf.reshape(MAX_BLOCKS, 16)[:plan.slices * plan.tiles,
                                          :len(PHASES)].astype(float)
        # products over the steps after the first, the others over all
        div = {"staging": 1, "first_products": 1, "products": steps - 1}
        per = {p: float(cyc[:, i].mean()) / div.get(p, steps)
               for i, p in enumerate(PHASES)}
        yield {"policy": policy, "cell": cell,
               "dtype": str(dt).replace("torch.", ""), "B": B,
               "steps": steps, "H": H, "M": M, "plan": plan._asdict(),
               "bitwise": bitwise, "ms": entry_ms, "instrumented_ms": ms,
               "cycles_per_launch": {p: per[p] for p in PER_LAUNCH},
               "cycles_per_step": {p: v for p, v in per.items()
                                   if p not in PER_LAUNCH},
               "cycles_per_step_sum": sum(v for p, v in per.items()
                                          if p not in PER_LAUNCH),
               "device": torch.cuda.get_device_name(dev)}
        del run_entry, outs, prof_entry, prof_outs, want, args
        torch.cuda.empty_cache()


def main(argv=None):
    for rec in run():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
