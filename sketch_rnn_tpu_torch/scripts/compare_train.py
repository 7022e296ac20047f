"""Hold this checkout's training step against another checkout's, on a card.

A change around the step (how its host values reach the card, what it
launches besides the kernels) can move the wall per step, the device
time per step or the number of device events without touching a kernel.
This script measures them for this checkout and another one (``OTHER``,
e.g. an earlier commit unpacked with ``git archive``), in turns (this,
other, other, this; ``--reps`` turns), one child process per turn that
imports only its own checkout's package, through ``train/loop.train`` at
``steps_per_call=1`` from the same seeded weights on the synthetic
loader (B=100, T=250), for each cell:

- ``flagship``: the ``quickdraw345_dp`` model (conditional VAE, bi-LSTM
  encoder 256, LayerNorm-LSTM decoder 512, 345 classes, recurrent
  dropout at keep 0.9) at bfloat16 through the fused kernels, as
  ``chip_smoke.py``'s ``train`` phase runs it: 2 steps to warm up, then
  ``ms_per_step`` over 10;
- ``plain``: the ``vae`` model (lstm decoder) at ``fused_rnn=false``,
  float32, as the ``train_plain`` phase runs it: 1 step to warm up, then
  ``ms_per_step`` over 4.

Then two steps timed and two more under ``torch.profiler``:
``device_ms`` for the two, ``device_busy_share`` (device ms over the
unprofiled wall) and ``device_events_per_step`` (every device event:
kernels, copies and fills). Every child checks the cell's launch counts
(the flagship's kernels a step; none on the plain path) and finite
losses. It prints one JSON line a child and, last, one line with the
medians of each checkout and their ratios (this over other). Both
checkouts' kernels are built first, at once. Needs a card and nvcc::

    python -m sketch_rnn_tpu_torch.scripts.compare_train OTHER [--reps N]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
METRICS = ("ms_per_step", "device_ms", "device_busy_share",
           "device_events_per_step")
# cell: (hparams, warm-up steps, timed steps, the launches of a step)
CELLS = {
    "flagship": (dict(conditional=True, dec_model="layer_norm",
                      num_classes=345, fused_rnn=True,
                      compute_dtype="bfloat16",
                      fused_residual_dtype="bfloat16"), 2, 10,
                 {"fused_lstm_seq_fwd": 2, "fused_lstm_seq_bwd": 2,
                  "fused_ln_lstm_fwd": 1, "fused_ln_lstm_bwd": 1}),
    "plain": (dict(conditional=True, dec_model="lstm", fused_rnn=False),
              1, 4, {}),
}


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


def _cell(name: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sketch_rnn_tpu_torch import HParams
    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.train.loop import train

    over, warm, steps, per_step = CELLS[name]
    hps = HParams(**over)
    params = SketchRNN(hps).init_params(torch.Generator().manual_seed(0),
                                        device="cuda")
    loader, _ = synthetic_loader(hps, num=10 * hps.batch_size, seed=0)

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = []
        train(hps, loader, seed=0, num_steps=n, params=params,
              device="cuda", history=rows)
        torch.cuda.synchronize()
        if not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"{name}: non-finite losses {rows}")
        return time.perf_counter() - t0

    run(warm)
    CF.reset_launch_counts()
    wall = run(steps)
    launched = CF.launch_counts()
    want = {k: per_step.get(k, 0) * steps for k in launched}
    if launched != want:
        raise AssertionError(f"{name}: launches {launched}, expected {want}")
    wall2 = run(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(2)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    return {"ms_per_step": wall * 1e3 / steps, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall2,
            "device_events_per_step": sum(e.count for e in events) / 2}


def child(root: Path, build_only: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from sketch_rnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("fused_rnn")
    if build_only:
        return {"root": str(root), "build_s": time.perf_counter() - t0}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"root": str(root), **{c: _cell(c) for c in CELLS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", type=Path,
                    help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=1)
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
    for cell in CELLS:
        med = {w: {m: statistics.median(r[cell][m] for r in runs[w])
                   for m in METRICS} for w in runs}
        summary[cell] = {**med, "this_over_other": {
            m: med["this"][m] / med["other"][m] for m in METRICS}}
    print(json.dumps({"summary": summary, "reps": args.reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
