"""Command-line interface of the PyTorch port: train / eval / sample.

The counterpart of ``sketch_rnn_tpu/cli.py``, with its flag names, its
presets and its usage checks (exit 2 before any checkpoint is read):

    python -m sketch_rnn_tpu_torch.cli train  --data_dir=D --workdir=W [--hparams=...]
    python -m sketch_rnn_tpu_torch.cli eval   --data_dir=D --workdir=W [--split=test]
    python -m sketch_rnn_tpu_torch.cli sample --workdir=W --output=out.svg [-n 10]

``--synthetic`` substitutes the deterministic synthetic corpus for the
QuickDraw ``.npz`` files. ``--device`` (``cuda``, the default, or
``cpu``) is the port's counterpart of ``JAX_PLATFORMS``: without a card
the default exits 2, and ``--device cpu`` runs the plain PyTorch versions
of the kernels. A workdir is checkpoint format 1, so either package's
``train`` writes what the other's ``eval`` and ``sample`` read.

The flags and subcommands of features the port does not have yet are
accepted by the parser and refused with exit 2, naming the ROADMAP item
that brings them (:data:`LATER_FLAGS`, ``distill``, ``serve-bench``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams, get_default_hparams

# BASELINE.md's five benchmark configs as one-flag presets (applied before
# --hparams, so explicit overrides still win), as in the JAX package
PRESETS = {
    # 1: unconditional decoder-only LSTM, M=20 GMM, single category
    "uncond_lstm": "conditional=false,dec_model=lstm",
    # 2: full seq2seq VAE (bi-LSTM enc 256, dec 512, Nz=128), plain LSTM
    "vae": "conditional=true,dec_model=lstm",
    # 3: the decoder cell variants (LayerNorm-LSTM / HyperLSTM)
    "layer_norm": "conditional=true,dec_model=layer_norm",
    "hyper": "conditional=true,dec_model=hyper",
    # 4: class-conditional, 75 categories (data_set must list 75 files)
    "classes75": "conditional=true,dec_model=layer_norm,num_classes=75",
    # 5: 345-category QuickDraw, the production perf config
    "quickdraw345_dp": ("conditional=true,dec_model=layer_norm,"
                        "num_classes=345,compute_dtype=bfloat16,"
                        "fused_rnn=true,fused_residual_dtype=bfloat16,"
                        "remat=true"),
}

_LATER = "comes with a later slice of the PyTorch port"
_TRAIN_FEATURES = "ROADMAP queue 1 item 7 (remaining training features"

# train flags of unported features: dest -> (its default, what brings it)
LATER_FLAGS = {
    "profile": (False, f"{_TRAIN_FEATURES}: utils/profiling.py)"),
    "trace_dir": ("", f"{_TRAIN_FEATURES}: utils/telemetry.py)"),
    "watchdog": (False, f"{_TRAIN_FEATURES}: train/watchdog.py)"),
    "halt_on_anomaly": (False, f"{_TRAIN_FEATURES}: train/watchdog.py)"),
    "fault_plan": ("", f"{_TRAIN_FEATURES}: the fault-injection sites "
                       f"of utils/faults.py)"),
    "fault_seed": (0, f"{_TRAIN_FEATURES}: the fault-injection sites "
                      f"of utils/faults.py)"),
    "bucket_edges": ("", f"{_TRAIN_FEATURES}: bucketed plans)"),
    "elastic_hosts": (0, f"{_TRAIN_FEATURES}: train/elastic.py)"),
    "elastic_host_id": (0, f"{_TRAIN_FEATURES}: train/elastic.py)"),
    "rendezvous": ("", f"{_TRAIN_FEATURES}: train/elastic.py)"),
    "heartbeat_interval": (0.25, f"{_TRAIN_FEATURES}: train/elastic.py)"),
    "stale_after": (2.5, f"{_TRAIN_FEATURES}: train/elastic.py)"),
    "serve_fleet": (0, "ROADMAP queue 1 items 5 and 6 (the serving fleet "
                       "and runtime/coresident.py)"),
    "serve_poll": (0.25, "ROADMAP queue 1 items 5 and 6 (the serving "
                         "fleet and runtime/coresident.py)"),
}

LATER_COMMANDS = {
    "distill": "ROADMAP queue 1 item 6 (speculative decoding: "
               "train/distill.py)",
    "serve-bench": "ROADMAP queue 1 item 5 (the serving fleet and its "
                   "benchmarks)",
}


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="", choices=[""] + list(PRESETS),
                   help="BASELINE.md benchmark config preset "
                        "(hparams base; --hparams overrides on top)")
    p.add_argument("--hparams", default="",
                   help="comma-separated key=value overrides")
    p.add_argument("--workdir", default="workdir",
                   help="checkpoints + metrics directory")
    p.add_argument("--data_dir", default="", help="QuickDraw .npz directory")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic corpus instead of .npz files")
    p.add_argument("--synthetic_grid", type=float, default=255.0,
                   help="integer-grid scale of the synthetic corpus "
                        "(QuickDraw-shaped integer deltas, so "
                        "transfer_dtype=int16 works; 0 = float-natured "
                        "corpus)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip_bad_records", action="store_true",
                   help="skip corrupt .npz records instead of failing "
                        "on the first one (one warning per file)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the port runs: the CUDA card (default; "
                        "exit 2 without one) or the CPU, with the plain "
                        "PyTorch versions of the kernels")


def _resolve_hps(args) -> HParams:
    # workdir config (from a previous run's checkpoint sidecar) seeds the
    # defaults so eval/sample agree with training automatically
    base = get_default_hparams()
    meta_hps = _workdir_hps(args.workdir)
    if meta_hps is not None:
        base = meta_hps
    if args.preset:
        base = base.parse(PRESETS[args.preset])
    if args.data_dir:
        base = base.replace(data_dir=args.data_dir)
    return base.parse(args.hparams)


def _workdir_hps(workdir: str) -> Optional[HParams]:
    from sketch_rnn_tpu_torch.train.checkpoint import latest_checkpoint
    step = latest_checkpoint(workdir) if workdir else None
    if step is None:
        return None
    with open(os.path.join(workdir, f"ckpt_{step:08d}.json")) as f:
        meta = json.load(f)
    return HParams.from_json(json.dumps(meta["hps"]))


def _device(args) -> Optional[torch.device]:
    """``--device`` as a torch device; None (after saying why) when it
    names the card and there is none."""
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[cli] --device cuda (the default) needs a CUDA card, and "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "run the plain PyTorch versions of the kernels on the CPU",
              file=sys.stderr)
        return None
    return torch.device(args.device)


def _load_data(hps: HParams, args, scale_factor: Optional[float] = None
               ) -> Tuple[object, object, object, float]:
    """Build the loaders of one host; ``scale_factor`` (from a
    checkpoint) overrides the recomputed train-split normalization:
    eval/sample must use the scale the model was trained with."""
    from sketch_rnn_tpu_torch.data.loader import (load_dataset,
                                                  synthetic_loader)
    if args.synthetic:
        grid = (args.synthetic_grid if args.synthetic_grid > 0 else None)
        if scale_factor is None:
            train_l, scale = synthetic_loader(
                hps, 20 * hps.batch_size, seed=1, augment=True,
                integer_grid=grid)
        else:
            # eval/sample with a checkpointed scale never touch the train
            # corpus: skip generating it
            train_l, scale = None, scale_factor
        valid_l, _ = synthetic_loader(hps, 2 * hps.batch_size, seed=2,
                                      scale_factor=scale,
                                      integer_grid=grid)
        test_l, _ = synthetic_loader(hps, 2 * hps.batch_size, seed=3,
                                     scale_factor=scale, integer_grid=grid)
        return train_l, valid_l, test_l, scale
    return load_dataset(hps, scale_factor=scale_factor,
                        skip_bad_records=args.skip_bad_records)


def _restore(hps: HParams, workdir: str, device):
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.train.checkpoint import restore_checkpoint
    from sketch_rnn_tpu_torch.train.state import make_train_state
    model = SketchRNN(hps)
    template = make_train_state(model.init_params(
        torch.Generator().manual_seed(0), device=device))
    state, scale, meta = restore_checkpoint(workdir, template,
                                            device=device)
    return model, state, scale, meta


def cmd_train(args) -> int:
    from sketch_rnn_tpu_torch.train.loop import train
    hps = _resolve_hps(args)
    if args.steps_per_call:
        # shorthand for --hparams steps_per_call=K
        hps = hps.replace(steps_per_call=args.steps_per_call)
    if args.sync_io:
        # blocking saves and eager metric conversion in one flag
        hps = hps.replace(async_checkpoint=False, metrics_defer=False)
    dev = _device(args)
    if dev is None:
        return 2
    train_l, valid_l, test_l, scale = _load_data(hps, args)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[cli] {len(train_l)} train / {len(valid_l)} valid sketches, "
          f"scale={scale:.4f}, device={where}", flush=True)
    train(hps, train_l, valid_l, test_l, scale_factor=scale,
          workdir=args.workdir, seed=args.seed,
          resume=not args.no_resume, device=dev)
    return 0


def cmd_eval(args) -> int:
    from sketch_rnn_tpu_torch.train.loop import evaluate, evaluate_per_class
    from sketch_rnn_tpu_torch.train.step import (
        make_eval_step, make_multi_eval_step,
        make_multi_per_class_eval_step, make_per_class_eval_step)
    hps = _resolve_hps(args)
    if args.per_class and hps.num_classes <= 0:
        print("[cli] --per_class needs a multi-class model "
              "(num_classes > 0)", file=sys.stderr)
        return 2
    dev = _device(args)
    if dev is None:
        return 2
    model, state, scale, meta = _restore(hps, args.workdir, dev)
    _, valid_l, test_l, _ = _load_data(hps, args, scale_factor=scale)
    loader = {"valid": valid_l, "test": test_l}[args.split]
    eval_k = hps.eval_steps_per_call
    multi = (None if eval_k == 1
             else (make_multi_eval_step(model, hps, device=dev), eval_k))
    ev = evaluate(state.params, loader,
                  make_eval_step(model, hps, device=dev), multi=multi)
    out = {"split": args.split, "step": meta["step"],
           **{k: round(v, 6) for k, v in sorted(ev.items())}}
    if args.per_class:
        # per-category losses: one masked sweep over the standard eval
        # batches; classes with no examples report null
        pc_multi = (None if eval_k == 1 else
                    (make_multi_per_class_eval_step(model, hps, device=dev),
                     eval_k))
        per = evaluate_per_class(
            state.params, loader,
            make_per_class_eval_step(model, hps, device=dev),
            hps.num_classes, multi=pc_multi)
        out["per_class"] = {
            str(c): (None if r is None
                     else {k: round(v, 6) for k, v in sorted(r.items())})
            for c, r in per.items()}
    print(json.dumps(out))
    return 0


def _sample_usage(args, hps: HParams):
    """The sample command's usage checks: ``(exit code, temperatures)``,
    the code 2 on a usage error (said on stderr), else 0."""
    if (args.interpolate or args.reconstruct) and not hps.conditional:
        print("[cli] --interpolate/--reconstruct need a conditional "
              "(encoder) model (hps.conditional=false)", file=sys.stderr)
        return 2, None
    if args.strokes_out and not (args.interpolate or args.reconstruct):
        print("[cli] --strokes_out archives the endpoint demos' raw "
              "stroke-5 arrays; add --interpolate or --reconstruct",
              file=sys.stderr)
        return 2, None
    if args.interpolate and args.n < 2:
        print(f"[cli] --interpolate needs -n >= 2 frames, got "
              f"{args.n}", file=sys.stderr)
        return 2, None
    if not args.temperatures:
        return 0, None
    if args.interpolate or args.reconstruct:
        print("[cli] --temperatures cannot combine with "
              "--interpolate/--reconstruct", file=sys.stderr)
        return 2, None
    try:
        temps = [float(t) for t in args.temperatures.split(",") if t]
    except ValueError:
        print(f"[cli] bad --temperatures {args.temperatures!r}; "
              f"expected comma-separated floats", file=sys.stderr)
        return 2, None
    if not temps:
        print("[cli] --temperatures is empty", file=sys.stderr)
        return 2, None
    return 0, temps


def _sample_endpoints(args, hps, model, state, scale, key, dev) -> int:
    """``--interpolate`` / ``--reconstruct``: requests through the
    endpoints' ``serve_requests``, so the strokes are the serving
    endpoint's on the same checkpoint, key and serving geometry;
    ``--strokes_out`` archives their raw stroke-5 arrays (model units)."""
    from sketch_rnn_tpu_torch.data import strokes as S
    from sketch_rnn_tpu_torch.sample import svg_grid
    from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
    from sketch_rnn_tpu_torch.serve.engine import Request
    from sketch_rnn_tpu_torch.utils import prng
    n = args.n
    originals = None
    _, valid_l, _, _ = _load_data(hps, args, scale_factor=scale)
    if args.interpolate:
        # --label conditions every frame's decode
        reqs = [Request(key=key, endpoint="interpolate",
                        prefix=(valid_l.strokes[0], valid_l.strokes[1]),
                        frames=n, temperature=args.temperature,
                        label=args.label)]
    else:
        # encode real sketches, decode conditioned on their posterior
        # means: inputs (top row) against reconstructions (bottom row)
        if n > len(valid_l.strokes):
            print(f"[cli] requested {n} reconstructions but the valid "
                  f"split holds {len(valid_l.strokes)}; clamping",
                  file=sys.stderr)
            n = len(valid_l.strokes)
        reqs = [Request(key=prng.fold_in(key, i), endpoint="reconstruct",
                        prefix=valid_l.strokes[i],
                        temperature=args.temperature,
                        label=(int(valid_l.labels[i])
                               if hps.num_classes > 0 else 0))
                for i in range(n)]
        originals = []
        for i in range(n):
            s3 = np.array(valid_l.strokes[i], np.float32)
            s3[:, 0:2] *= scale
            originals.append(s3)
    out = serve_requests(model, hps, state.params, reqs,
                         greedy=args.greedy, device=dev)
    by_uid = {r.uid: r for r in out["results"]}
    if args.interpolate:
        strokes5 = list(by_uid[0].frames)
        lengths = np.asarray([len(s) for s in strokes5])
    else:
        strokes5 = [by_uid[i].strokes5 for i in range(n)]
        lengths = np.asarray([by_uid[i].length for i in range(n)])
    if args.strokes_out:
        np.savez(args.strokes_out,
                 **{f"strokes5_{i:03d}": s for i, s in enumerate(strokes5)})
        print(f"[cli] wrote raw stroke-5 arrays to {args.strokes_out}",
              file=sys.stderr)
    sketches = []
    for s5 in strokes5:
        s3 = S.to_normal_strokes(np.asarray(s5))
        s3[:, 0:2] *= scale
        sketches.append(s3)
    if originals is not None:
        cols = max(1, min(args.cols, n))
        blank = np.zeros((0, 3), np.float32)
        cells = []
        for lo in range(0, n, cols):
            for row in (originals[lo:lo + cols], sketches[lo:lo + cols]):
                cells += row + [blank] * (cols - len(row))
        svg_grid(cells, cols=cols, path=args.output)
        print(f"[cli] wrote {n} input|reconstruction pairs (lengths "
              f"{[int(x) for x in lengths]}) to {args.output}")
    else:
        svg_grid(sketches, cols=args.cols, path=args.output)
        print(f"[cli] wrote {len(sketches)} interpolation frames to "
              f"{args.output}")
    return 0


def cmd_sample(args) -> int:
    from sketch_rnn_tpu_torch.sample import sample, svg_grid
    from sketch_rnn_tpu_torch.utils import prng
    hps = _resolve_hps(args)
    # usage errors fail before the (expensive) checkpoint restore
    rc, temps = _sample_usage(args, hps)
    if rc:
        return rc
    dev = _device(args)
    if dev is None:
        return 2
    model, state, scale, meta = _restore(hps, args.workdir, dev)
    key = prng.key(args.seed)
    if args.interpolate or args.reconstruct:
        return _sample_endpoints(args, hps, model, state, scale, key, dev)
    n = args.n
    z = None
    labels = (np.full((n,), args.label, np.int32) if hps.num_classes > 0
              else None)
    if temps is not None:
        # one grid row of n samples per temperature, the SAME latents in
        # every row so the rows differ only by tau (conditional models:
        # one prior z batch drawn up front; the per-row keys still vary
        # the in-row mixture draws)
        kz, key = prng.split(key, 2).unbind(dim=-2)
        if hps.conditional:
            z = prng.normal(kz, (n, hps.z_size))
        sketches = []
        for i, tau in enumerate(temps):
            sk, _ = sample(model, state.params, hps, prng.fold_in(key, i),
                           n=n, temperature=tau, z=z, labels=labels,
                           scale_factor=scale, greedy=args.greedy,
                           device=dev)
            sketches += sk
        svg_grid(sketches, cols=n, path=args.output)
        print(f"[cli] wrote {len(temps)} temperature rows ({temps}) x {n} "
              f"sketches to {args.output}")
        return 0
    sketches, lengths = sample(model, state.params, hps, key, n=n,
                               temperature=args.temperature, z=z,
                               labels=labels, scale_factor=scale,
                               greedy=args.greedy, device=dev)
    svg_grid(sketches, cols=args.cols, path=args.output)
    print(f"[cli] wrote {n} sketches (lengths "
          f"{[int(x) for x in lengths]}) to {args.output}")
    return 0


def _refusal(args) -> Optional[str]:
    """What the command line asks for that the port does not have yet,
    naming the ROADMAP item that brings it; None if nothing."""
    if args.cmd in LATER_COMMANDS:
        return f"the {args.cmd} subcommand {_LATER}: " \
               f"{LATER_COMMANDS[args.cmd]}"
    for dest, (default, item) in LATER_FLAGS.items():
        if getattr(args, dest, default) != default:
            return f"--{dest} {_LATER}: {item}"
    return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sketch_rnn_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model")
    _add_common(p)
    p.add_argument("--steps_per_call", type=int, default=0,
                   help="optimizer steps per call (K > 1 = one CUDA graph "
                        "replay per K steps on the card); 0 = keep the "
                        "hparams value. Shorthand for --hparams "
                        "steps_per_call=K")
    p.add_argument("--no_resume", action="store_true",
                   help="start fresh even when <workdir> holds "
                        "checkpoints (default: resume from the latest)")
    p.add_argument("--sync_io", action="store_true",
                   help="blocking saves and eager metric conversion "
                        "(async_checkpoint=false,metrics_defer=false), "
                        "for debugging; results are identical either way")
    p.add_argument("--bucket_edges", default="",
                   help="length-bucketed execution (refused: "
                        "ROADMAP queue 1 item 7)")
    for flag in ("--profile", "--watchdog", "--halt_on_anomaly"):
        p.add_argument(flag, action="store_true",
                       help="refused: ROADMAP queue 1 item 7")
    p.add_argument("--trace_dir", default="",
                   help="telemetry traces (refused: ROADMAP queue 1 "
                        "item 7)")
    p.add_argument("--elastic_hosts", type=int, default=0,
                   help="elastic multi-host training (refused: ROADMAP "
                        "queue 1 item 7), like --elastic_host_id, "
                        "--rendezvous, --heartbeat_interval and "
                        "--stale_after")
    p.add_argument("--elastic_host_id", type=int, default=0)
    p.add_argument("--rendezvous", default="")
    p.add_argument("--heartbeat_interval", type=float, default=0.25)
    p.add_argument("--stale_after", type=float, default=2.5)
    p.add_argument("--serve_fleet", type=int, default=0,
                   help="co-resident train-and-serve (refused: ROADMAP "
                        "queue 1 items 5 and 6), like --serve_poll")
    p.add_argument("--serve_poll", type=float, default=0.25)
    p.add_argument("--fault_plan", default="",
                   help="fault injection (refused: ROADMAP queue 1 item "
                        "7), like --fault_seed")
    p.add_argument("--fault_seed", type=int, default=0)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint")
    _add_common(p)
    p.add_argument("--split", choices=("valid", "test"), default="valid")
    p.add_argument("--per_class", action="store_true",
                   help="also report metrics per class (multi-class "
                        "models)")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("sample", help="draw sketches from a checkpoint")
    _add_common(p)
    p.add_argument("-n", type=int, default=10, help="number of sketches")
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--temperatures", default="",
                   help="comma-separated sweep (e.g. 0.2,0.5,0.8,1.0): "
                        "one grid row of n sketches per temperature")
    p.add_argument("--greedy", action="store_true")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--interpolate", action="store_true",
                      help="interpolate between two encoded valid sketches")
    mode.add_argument("--reconstruct", action="store_true",
                      help="encode n valid sketches and decode from their "
                           "latents; output pairs inputs (top row) with "
                           "reconstructions (bottom row)")
    p.add_argument("--label", type=int, default=0,
                   help="class id for class-conditional models")
    p.add_argument("--output", default="samples.svg")
    p.add_argument("--strokes_out", default="",
                   help="with --interpolate/--reconstruct: also write "
                        "the raw stroke-5 arrays (normalized model "
                        "units) to this .npz; the serving endpoints "
                        "produce these exact bytes on the same "
                        "checkpoint, key and serving geometry")
    p.add_argument("--cols", type=int, default=5)
    p.set_defaults(fn=cmd_sample)

    for name, item in LATER_COMMANDS.items():
        p = sub.add_parser(name, help=f"refused: {item}")
        _add_common(p)
        p.set_defaults(fn=None)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    refused = _refusal(args)
    if refused:
        print(f"[cli] {refused}", file=sys.stderr)
        return 2
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
