"""Hold this checkout's serving path against another checkout's, on a card.

The serving chunk is host-bound, so a kernel made faster can still leave
the wall per chunk where it was, or the host work around its launch can
grow. This script measures both for this checkout and another one
(``OTHER``, e.g. an earlier commit unpacked with ``git archive``), in
turns (this, other, other, this; ``--reps`` turns), one child process per
turn that imports only its own checkout's package:

- ``decode_ms`` / ``replay_ms``: the public ``decode_chunk`` and
  ``replay_chunk`` wrappers called back to back (CUDA events, ms a call;
  B=64 slots, K=8 steps, H=512, M=20, replay at E=64, seeded random
  weights, every 4th row's cap mid-chunk, every 16th row done at the
  start);
- ``decode_host_ms`` / ``replay_host_ms``: the host's time a wrapper call
  (``time.perf_counter`` over the same calls, without the final wait);
- ``generate_ms_per_chunk``: a 128-request ``generate`` burst through
  ``ServeEngine`` (64 slots, K=8, caps in [16, 250]), its wall over its
  chunks; the median of three bursts after one to warm up.

Each at the ``layer_norm`` preset, float32 and bfloat16. Every child
checks that its burst went through the kernels (launch counts above 0).
It prints one JSON line a child and, last, one line with the medians of
each checkout and their ratios (this over other). Both checkouts' kernels
are built first, at once. Needs a card and nvcc::

    python -m sketch_rnn_tpu_torch.scripts.compare_serving OTHER [--reps N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DTYPES = ("float32", "bfloat16")
B, K, E = 64, 8, 64
BURSTS = 3
METRICS = ("decode_ms", "decode_host_ms", "replay_ms", "replay_host_ms",
           "generate_ms_per_chunk")


def _child_env(root: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root)
    return env


def _run_child(root: Path, *args: str) -> dict:
    """This file run as a child against ``root``'s package; its last line
    of output, parsed."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--child", str(root), *args], cwd=root,
                          env=_child_env(root), capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"the child for {root} failed "
                           f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _events_ms(fn, iters):
    """``(device ms a call by CUDA events, host ms a call)`` over
    ``iters`` back-to-back calls, after three to warm up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def _model(dt, seed=0):
    import torch

    from sketch_rnn_tpu_torch import HParams
    from sketch_rnn_tpu_torch.models.vae import SketchRNN

    hps = HParams(conditional=True, dec_model="layer_norm", serve_slots=B,
                  serve_chunk=K, compute_dtype=dt)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device="cuda")
    return hps, model, params


def _wrappers(dt):
    """The two wrappers' times at the serving shapes."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params = _model(dt)
    params["out_b"][2] = -3.0
    cdt = model.dec.compute_dtype
    dec = cd.cast_weights(params["dec"], cdt)
    out_w = params["out_w"].to(cd.weight_dtype(cdt))
    g = torch.Generator().manual_seed(1)
    z = torch.randn((B, hps.z_size), generator=g).to("cuda")
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, B))
    prev0 = torch.tensor([0, 0, 1.0, 0, 0]).expand(B, 5).contiguous()
    keys = prng.fold_in(prng.key(1), torch.arange(B)).to("cuda")
    t0 = torch.randint(0, 200, (B,), generator=g, dtype=torch.int32)
    caps = torch.where(torch.arange(B) % 4 == 0,
                       t0 + torch.randint(1, K, (B,), generator=g,
                                          dtype=torch.int32),
                       torch.full((B,), 250, dtype=torch.int32))
    t0, caps, prev0 = t0.to("cuda"), caps.to("cuda"), prev0.to("cuda")
    u = cd.make_uniforms(keys, t0, K)
    temps = (0.4 + torch.rand((B,), generator=g)).to("cuda")
    done0 = (torch.arange(B) % 16 == 3).to("cuda")
    end = torch.tensor([0, 0, 0, 0, 1.0]).to("cuda")
    decode = lambda: cd.decode_chunk(
        dec, out_w, params["out_b"], c0, h0, prev0, z, u, temps, t0, done0,
        caps, end, cell_kind="layer_norm", num_mixture=hps.num_mixture,
        compute_dtype=cdt)
    xs = torch.zeros((E, B, 5))
    xs[..., :2] = torch.randn((E, B, 2), generator=g)
    pen = torch.randint(0, 2, (E, B), generator=g)
    xs[..., 2], xs[..., 3] = (pen == 0).float(), (pen == 1).float()
    xs = xs.to("cuda")
    seq_len = torch.randint(1, E + 1, (B,), generator=g,
                            dtype=torch.int32).to("cuda")
    replay = lambda: cd.replay_chunk(dec, c0, h0, xs, z, seq_len,
                                     cell_kind="layer_norm",
                                     compute_dtype=cdt)
    d_ms, d_host = _events_ms(decode, 50)
    r_ms, r_host = _events_ms(replay, 20)
    return {"decode_ms": d_ms, "decode_host_ms": d_host, "replay_ms": r_ms,
            "replay_host_ms": r_host}


def _generate(dt):
    """The median wall a chunk of a 128-request generate burst."""
    import numpy as np
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params = _model(dt)
    params["out_b"][2] = -1e9          # pen-suppression sentinel
    engine = ServeEngine(model, hps, params, device="cuda")
    rng = np.random.default_rng(0)
    n = 128
    z = rng.normal(size=(n, hps.z_size)).astype(np.float32)
    caps = rng.integers(16, hps.max_seq_len + 1, n)
    k0 = prng.key(0)

    def burst():
        reqs = [Request(key=prng.fold_in(k0, i), z=z[i], temperature=0.8,
                        max_len=int(caps[i])) for i in range(n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = engine.run(reqs)["metrics"]
        torch.cuda.synchronize()
        if m["completed"] != n:
            raise AssertionError(f"completed {m['completed']} of {n}")
        return (time.perf_counter() - t0) * 1e3 / m["chunks"]

    burst()
    cd.reset_launch_counts()
    walls = [burst() for _ in range(BURSTS)]
    if cd.decode_chunk_launches == 0:
        raise AssertionError("the burst launched no decode_chunk")
    return {"generate_ms_per_chunk": statistics.median(walls),
            "generate_ms_per_chunk_all": walls}


def child(root: Path, build_only: bool) -> dict:
    sys.path.insert(0, str(root))
    from sketch_rnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("decode")
    if build_only:
        return {"root": str(root), "build_s": time.perf_counter() - t0}
    out = {"root": str(root)}
    for dt in DTYPES:
        out[dt] = {**_wrappers(dt), **_generate(dt)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", type=Path,
                    help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child.resolve(), args.build_only)))
        return 0
    if args.other is None:
        ap.error("OTHER is required")
    roots = {"this": ROOT, "other": args.other.resolve()}
    builds = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--child", str(r),
         "--build-only"], cwd=r, env=_child_env(r),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in roots.values()]
    for proc in builds:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build failed:\n{out[-4000:]}{err[-4000:]}")
        print(out.strip().splitlines()[-1], flush=True)
    runs = {"this": [], "other": []}
    for _ in range(args.reps):
        for which in ("this", "other", "other", "this"):
            rec = _run_child(roots[which])
            runs[which].append(rec)
            print(json.dumps({"checkout": which, **rec}), flush=True)
    summary = {}
    for dt in DTYPES:
        med = {w: {m: statistics.median(r[dt][m] for r in runs[w])
                   for m in METRICS} for w in runs}
        summary[dt] = {**med, "this_over_other": {
            m: med["this"][m] / med["other"][m] for m in METRICS}}
    print(json.dumps({"summary": summary, "reps": args.reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
