"""Command-line interface of the PyTorch port: train / eval / sample /
serve-bench.

The counterpart of ``sketch_rnn_tpu/cli.py``, with its flag names, its
presets and its usage checks (exit 2 before any checkpoint is read):

    python -m sketch_rnn_tpu_torch.cli train  --data_dir=D --workdir=W [--hparams=...]
    python -m sketch_rnn_tpu_torch.cli eval   --data_dir=D --workdir=W [--split=test]
    python -m sketch_rnn_tpu_torch.cli sample --workdir=W --output=out.svg [-n 10]
    python -m sketch_rnn_tpu_torch.cli serve-bench --workdir=W [-n 64] [--fleet [N] --rate R]

``--synthetic`` substitutes the deterministic synthetic corpus for the
QuickDraw ``.npz`` files. ``--device`` (``cuda``, the default, or
``cpu``) is the port's counterpart of ``JAX_PLATFORMS``: without a card
the default exits 2, and ``--device cpu`` runs the plain PyTorch versions
of the kernels. A workdir is checkpoint format 1, so either package's
``train`` writes what the other's ``eval`` and ``sample`` read.

``serve-bench`` serves a burst through the engine (``--static``: static
batching) or through the fleet (``--fleet``: open-loop Poisson arrivals
at ``--rate``, admission ``--classes``, an ``--endpoints`` mix,
``--tenants`` seeded fine-tunes paged through one value-paged fleet) and
prints one JSON report, the JAX CLI's ``serve_bench_cli`` keys less
those of unported features (``run_id``, ``metrics_port``,
``metrics_prom``; the fleet block's elastic and tail fields).

Data parallelism: one process per card. ``train``, ``eval`` and
``sample`` join the process group first (``parallel/multihost.
initialize``: torchrun's environment, NCCL on the card, gloo with
``--device cpu``; a no-op without it), so

    torchrun --standalone --nproc_per_node=N -m sketch_rnn_tpu_torch.cli train --preset quickdraw345_dp ...

trains on N cards: each rank loads its stripe of every split at its
share of the global ``batch_size`` (``local_batch_hps``), and only rank
0 prints results and writes files (checkpoints, metrics, SVGs); every
rank reads the shared workdir.

The flags and subcommands of features the port does not have yet are
accepted by the parser and refused with exit 2, naming the ROADMAP item
that brings them (:data:`LATER_FLAGS`, :data:`SERVE_BENCH_LATER_FLAGS`,
``distill``).
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

_ITEM_5B_II = ("ROADMAP queue 1 item 5b-ii (elastic replicas, rollout, "
               "metrics_http.py)")
_ITEM_6 = "ROADMAP queue 1 item 6 (speculative decoding"
_ITEM_7 = "ROADMAP queue 1 item 7 (utils/telemetry.py and the fault " \
          "injector of utils/faults.py)"

# serve-bench flags of unported features: dest -> (its default, its item)
SERVE_BENCH_LATER_FLAGS = {
    "draft_ckpt": ("", f"{_ITEM_6}: models/draft.py)"),
    "draft_depth": (0, f"{_ITEM_6}: models/draft.py)"),
    "draft_tol": (-1.0, f"{_ITEM_6}: models/draft.py)"),
    "draft_noise": (0.0, f"{_ITEM_6}: models/draft.py)"),
    "watch_ckpt": ("", _ITEM_5B_II),
    "metrics_port": (None, _ITEM_5B_II),
    "trace_dir": ("", _ITEM_7),
    "fault_plan": ("", _ITEM_7),
    "fault_seed": (0, _ITEM_7),
}

LATER_COMMANDS = {
    "distill": "ROADMAP queue 1 item 6 (speculative decoding: "
               "train/distill.py)",
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
    """``--device`` as a torch device (``cuda``: this rank's card,
    ``cuda:LOCAL_RANK``); None (after saying why) when it names the card
    and there is none. Joins the process group first, when launched as
    one (gloo on the CPU)."""
    from sketch_rnn_tpu_torch.parallel import multihost as mh
    from sketch_rnn_tpu_torch.utils.device import resolve_device
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[cli] --device cuda (the default) needs a CUDA card, and "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "run the plain PyTorch versions of the kernels on the CPU",
              file=sys.stderr)
        return None
    mh.initialize(backend="gloo" if args.device == "cpu" else None)
    return resolve_device(None if args.device == "cuda" else args.device)


def _primary() -> bool:
    from sketch_rnn_tpu_torch.parallel import multihost as mh
    return mh.is_primary()


def _load_data(hps: HParams, args, scale_factor: Optional[float] = None
               ) -> Tuple[object, object, object, float]:
    """Build this rank's loaders: its stripe of every split over the
    mesh's data axis, at its share of the global batch
    (``local_batch_hps``; ``hps`` carries the global batch size).
    ``scale_factor`` (from a checkpoint) overrides the recomputed
    train-split normalization: eval/sample must use the scale the model
    was trained with."""
    from sketch_rnn_tpu_torch.data.loader import (load_dataset,
                                                  synthetic_loader)
    from sketch_rnn_tpu_torch.parallel.mesh import make_mesh
    from sketch_rnn_tpu_torch.parallel.multihost import local_batch_hps
    mesh = make_mesh(hps)
    host, nhosts = mesh.data_index, mesh.data_size
    lhps = local_batch_hps(hps, nhosts)
    if args.synthetic:
        grid = (args.synthetic_grid if args.synthetic_grid > 0 else None)
        stripe = dict(host_id=host, num_hosts=nhosts, integer_grid=grid)
        if scale_factor is None:
            train_l, scale = synthetic_loader(
                lhps, 20 * hps.batch_size, seed=1, augment=True, **stripe)
        else:
            # eval/sample with a checkpointed scale never touch the train
            # corpus: skip generating it
            train_l, scale = None, scale_factor
        # valid/test are striped too: each global eval batch then holds
        # distinct rows
        valid_l, _ = synthetic_loader(lhps, 2 * hps.batch_size, seed=2,
                                      scale_factor=scale, **stripe)
        test_l, _ = synthetic_loader(lhps, 2 * hps.batch_size, seed=3,
                                     scale_factor=scale, **stripe)
        return train_l, valid_l, test_l, scale
    return load_dataset(lhps, scale_factor=scale_factor, host_id=host,
                        num_hosts=nhosts,
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
    if args.bucket_edges:
        # shorthand for --hparams bucket_edges=...: comma or semicolon
        # separators (the hparam tuple syntax is ';')
        hps = hps.parse(
            f"bucket_edges={args.bucket_edges.replace(',', ';')}")
    if args.steps_per_call:
        # shorthand for --hparams steps_per_call=K (with --bucket_edges:
        # the bucket-run scheduler)
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
    if _primary():
        from sketch_rnn_tpu_torch.parallel import multihost as mh
        print(f"[cli] {len(train_l)} train / {len(valid_l)} valid sketches "
              f"(rank 0 of {mh.process_count()}), scale={scale:.4f}, "
              f"device={where}", flush=True)
    train(hps, train_l, valid_l, test_l, scale_factor=scale,
          workdir=args.workdir, seed=args.seed,
          resume=not args.no_resume, device=dev)
    return 0


def cmd_eval(args) -> int:
    from sketch_rnn_tpu_torch.parallel.mesh import make_mesh
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
    mesh = make_mesh(hps)
    eval_k = hps.eval_steps_per_call
    multi = (None if eval_k == 1 else
             (make_multi_eval_step(model, hps, device=dev, mesh=mesh),
              eval_k))
    ev = evaluate(state.params, loader,
                  make_eval_step(model, hps, device=dev, mesh=mesh), mesh,
                  multi=multi)
    out = {"split": args.split, "step": meta["step"],
           **{k: round(v, 6) for k, v in sorted(ev.items())}}
    if args.per_class:
        # per-category losses: one masked sweep over the standard eval
        # batches; classes with no examples report null
        pc_multi = (None if eval_k == 1 else
                    (make_multi_per_class_eval_step(model, hps, device=dev,
                                                    mesh=mesh), eval_k))
        per = evaluate_per_class(
            state.params, loader,
            make_per_class_eval_step(model, hps, device=dev, mesh=mesh),
            hps.num_classes, mesh, multi=pc_multi)
        out["per_class"] = {
            str(c): (None if r is None
                     else {k: round(v, 6) for k, v in sorted(r.items())})
            for c, r in per.items()}
    if _primary():
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
    if not _primary():
        # ranks hold other stripes: only the primary writes
        return 0
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
        if _primary():
            svg_grid(sketches, cols=n, path=args.output)
            print(f"[cli] wrote {len(temps)} temperature rows ({temps}) x "
                  f"{n} sketches to {args.output}")
        return 0
    sketches, lengths = sample(model, state.params, hps, key, n=n,
                               temperature=args.temperature, z=z,
                               labels=labels, scale_factor=scale,
                               greedy=args.greedy, device=dev)
    if _primary():
        svg_grid(sketches, cols=args.cols, path=args.output)
        print(f"[cli] wrote {n} sketches (lengths "
              f"{[int(x) for x in lengths]}) to {args.output}")
    return 0


def _serve_bench_usage(args, hps: HParams):
    """serve-bench's usage checks, before any checkpoint is read and with
    the JAX CLI's messages: ``(exit code, slo tracker, endpoints config,
    tenants config, device)``, the code 2 on a usage error (said on
    stderr)."""
    from sketch_rnn_tpu_torch.serve.admission import \
        parse_admission_classes
    from sketch_rnn_tpu_torch.serve.slo import SLOTracker, parse_slo
    fail = (2, None, None, None, None)
    if hps.decode_kernel == "pallas":
        from sketch_rnn_tpu_torch.ops.cuda_decode import check_cell_kind
        try:
            check_cell_kind(hps.dec_model)
        except ValueError as e:
            print(f"[cli] {e}", file=sys.stderr)
            return fail
    slo_tracker = None
    if args.slo:
        try:
            slo_tracker = SLOTracker([parse_slo(s) for s in args.slo])
        except ValueError as e:
            print(f"[cli] {e}", file=sys.stderr)
            return fail
    if args.fleet is None and (args.rate or args.classes):
        print("[cli] --rate/--classes configure the fleet scheduler; "
              "add --fleet", file=sys.stderr)
        return fail
    if args.fleet is not None:
        if args.static:
            print("[cli] --static (freeze-until-batch-done) has no "
                  "fleet equivalent; drop one of --static/--fleet",
                  file=sys.stderr)
            return fail
        try:
            parse_admission_classes(args.classes)
        except ValueError as e:
            print(f"[cli] {e}", file=sys.stderr)
            return fail
        if args.rate < 0:
            print(f"[cli] --rate must be >= 0, got {args.rate}",
                  file=sys.stderr)
            return fail
    endpoints_cfg = None
    if args.endpoints or args.endpoint_mix:
        if args.fleet is None:
            print("[cli] --endpoints/--endpoint_mix configure the "
                  "multi-task fleet; add --fleet", file=sys.stderr)
            return fail
        from sketch_rnn_tpu_torch.serve.endpoints import (
            ENCODER_ENDPOINTS, ENDPOINTS, parse_endpoint_specs)
        from sketch_rnn_tpu_torch.serve.fleet import default_pool_cap
        from sketch_rnn_tpu_torch.serve.loadgen import parse_endpoint_mix
        try:
            ep_map, ep_classes = parse_endpoint_specs(
                args.endpoints,
                classes=parse_admission_classes(args.classes))
            mix = (parse_endpoint_mix(args.endpoint_mix)
                   if args.endpoint_mix else
                   tuple((e, 1.0) for e in ENDPOINTS if e in ep_map)
                   or (("generate", 1.0),))
        except ValueError as e:
            print(f"[cli] {e}", file=sys.stderr)
            return fail
        bad = [name for name, _ in mix if name not in ENDPOINTS]
        if bad:
            print(f"[cli] unknown endpoint(s) {bad} in "
                  f"--endpoint_mix; want {ENDPOINTS}", file=sys.stderr)
            return fail
        unrouted = [name for name, _ in mix
                    if name not in ep_map and len(ep_classes) > 1]
        if unrouted:
            print(f"[cli] endpoint(s) {unrouted} in the mix have no "
                  f"class route; add --endpoints "
                  f"{unrouted[0]}=CLASS", file=sys.stderr)
            return fail
        enc_needed = sorted(set(name for name, _ in mix)
                            & set(ENCODER_ENDPOINTS))
        if enc_needed and not hps.conditional:
            print(f"[cli] endpoint(s) {enc_needed} need the "
                  f"bidirectional encoder but this checkpoint is "
                  f"unconditional (hps.conditional=false)",
                  file=sys.stderr)
            return fail
        if args.frames < 2:
            print(f"[cli] --frames must be >= 2, got {args.frames}",
                  file=sys.stderr)
            return fail
        pool_cap = default_pool_cap(args.slots or hps.serve_slots)
        if any(name == "interpolate" for name, _ in mix) \
                and args.frames > pool_cap:
            print(f"[cli] --frames {args.frames} exceeds the fleet's "
                  f"pool_cap {pool_cap} (4x slots); shrink --frames "
                  f"or raise --slots", file=sys.stderr)
            return fail
        endpoints_cfg = {"map": ep_map, "classes": ep_classes,
                         "mix": mix, "frames": args.frames,
                         "encoder": bool(enc_needed)}
    tenants_cfg = None
    if args.tenants or args.tenant_mix or args.tenant_cap \
            or args.tenant_slo:
        if args.fleet is None:
            print("[cli] --tenants/--tenant_mix/--tenant_cap/"
                  "--tenant_slo configure the multi-tenant fleet; add "
                  "--fleet", file=sys.stderr)
            return fail
        if args.tenants < 2:
            print(f"[cli] --tenants needs >= 2 tenants (got "
                  f"{args.tenants}); a single-tenant fleet is just "
                  f"--fleet", file=sys.stderr)
            return fail
        if args.tenant_cap < 0:
            print(f"[cli] --tenant_cap must be >= 0, got "
                  f"{args.tenant_cap}", file=sys.stderr)
            return fail
        from sketch_rnn_tpu_torch.serve.admission import parse_tenant_slos
        from sketch_rnn_tpu_torch.serve.loadgen import parse_tenant_mix
        names = [f"tn{i}" for i in range(args.tenants)]
        try:
            tslos = parse_tenant_slos(args.tenant_slo)
            tmix = (parse_tenant_mix(args.tenant_mix)
                    if args.tenant_mix
                    else tuple((t, 1.0) for t in [""] + names))
        except ValueError as e:
            print(f"[cli] {e}", file=sys.stderr)
            return fail
        known = set(names) | {""}
        bad = sorted({t for t, _ in tmix} - known) \
            + sorted(set(tslos) - known)
        if bad:
            print(f"[cli] unknown tenant(s) {bad} in --tenant_mix/"
                  f"--tenant_slo; --tenants {args.tenants} registers "
                  f"tn0..tn{args.tenants - 1} ('' = base)",
                  file=sys.stderr)
            return fail
        tenants_cfg = {"names": names, "mix": tmix,
                       "cap": args.tenant_cap, "slos": tslos}
    dev = _device(args)
    if dev is None:
        return fail
    if args.fleet is not None and dev.type == "cuda" \
            and args.fleet > torch.cuda.device_count():
        print(f"[cli] --fleet {args.fleet} needs {args.fleet} "
              f"devices but only {torch.cuda.device_count()} are "
              f"available", file=sys.stderr)
        return fail
    return 0, slo_tracker, endpoints_cfg, tenants_cfg, dev


def cmd_serve_bench(args) -> int:
    """Serve a burst of requests and print the serving metrics as one
    JSON line: through the engine (a warm-up burst, then the timed run;
    ``--static`` for static batching) or, with ``--fleet``, through the
    fleet under open-loop Poisson arrivals at ``--rate``. With
    ``--random_init`` the model is freshly initialized from ``--seed``,
    else the latest checkpoint in ``--workdir`` is restored."""
    hps = _resolve_hps(args)
    if args.decode_kernel:
        hps = hps.replace(decode_kernel=args.decode_kernel)
    if args.quantize:
        hps = hps.replace(serve_quantize=args.quantize)
    rc, slo_tracker, endpoints_cfg, tenants_cfg, dev = \
        _serve_bench_usage(args, hps)
    if rc:
        return rc
    return _serve_bench_run(args, hps, slo_tracker, endpoints_cfg,
                            tenants_cfg, dev)


def _json_safe(obj):
    """A strict-JSON copy: non-finite floats (an infinite SLO burn rate)
    become their repr strings."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return repr(obj)
    return obj


def _serve_bench_fleet(args, hps, model, params, requests, slo_tracker,
                       endpoints_cfg, ckpt_id: str, dev, tenants_cfg=None,
                       tenant_store=None):
    """The fleet's measured section: build and warm the fleet, replay the
    open-loop schedule through ``submit``, drain. With ``tenant_store``
    the fleet is value-paged over it. Returns ``(report metrics, fleet
    summary, per-request rows)``."""
    from sketch_rnn_tpu_torch.serve.admission import \
        parse_admission_classes
    from sketch_rnn_tpu_torch.serve.fleet import ServeFleet
    from sketch_rnn_tpu_torch.serve.loadgen import (OpenLoopLoadGen,
                                                    poisson_arrivals)

    if endpoints_cfg is not None:
        classes = endpoints_cfg["classes"]
        endpoint_classes = endpoints_cfg["map"]
    else:
        classes = parse_admission_classes(args.classes)
        endpoint_classes = None
    cls_order = [c.name for c in sorted(classes.values(),
                                        key=lambda c: c.priority)]
    # the CPU has no device count: --fleet N gives N CPU replicas
    devices = ([dev] * max(1, args.fleet) if dev.type == "cpu"
               else None)
    tenant_kw = {}
    if tenant_store is not None:
        tenant_kw = dict(tenants=tenant_store,
                         tenant_cap=tenants_cfg["cap"],
                         tenant_slos=tenants_cfg["slos"])
    fleet = ServeFleet(model, hps, params, replicas=args.fleet,
                       slots=args.slots, chunk=args.chunk,
                       greedy=args.greedy, classes=classes,
                       devices=devices, slo=slo_tracker,
                       endpoint_classes=endpoint_classes,
                       ckpt_id=ckpt_id, **tenant_kw)
    fleet.warm(requests[0],
               endpoints=bool(endpoints_cfg
                              and endpoints_cfg.get("encoder")))
    for i, r in enumerate(requests):
        r.uid = i

    def _submit(i):
        if endpoints_cfg is not None:
            fleet.submit(requests[i])     # the endpoint routes the class
        else:
            fleet.submit(requests[i], cls=cls_order[i % len(cls_order)])

    with fleet:
        gen = OpenLoopLoadGen(
            poisson_arrivals(len(requests), args.rate, args.seed),
            _submit).start()
        try:
            gen.join()
            fleet.drain()
        finally:
            gen.stop()
        fsum = fleet.summary()
        rows = [{"uid": uid, "replica": rec["replica"],
                 "class": rec.get("class"),
                 "endpoint": rec.get("endpoint", "generate"),
                 "tenant": rec.get("tenant", ""),
                 "queue_pos": rec.get("queue_pos"),
                 "steps": rec["result"].steps,
                 "length": rec["result"].length,
                 "queue_wait_s": rec["result"].queue_wait_s,
                 "decode_s": rec["result"].decode_s,
                 "latency_s": rec["result"].latency_s}
                for uid, rec in sorted(fleet.results.items())]
    fsum["offered_rate"] = args.rate
    fsum["loadgen_max_lag_s"] = round(gen.max_lag_s, 6)
    out_metrics = {
        "completed": fsum["completed"],
        "wall_s": fsum["wall_s"],
        "sketches_per_sec": fsum["sketches_per_sec"],
        "requests_shed": fsum["shed"],
        "shed_frac": fsum["shed_frac"],
        "latency_p50_s": fsum["latency"]["p50_s"],
        "latency_p95_s": fsum["latency"]["p95_s"],
        "latency_p99_s": fsum["latency"]["p99_s"],
    }
    if endpoints_cfg is not None:
        out_metrics["latency_by_endpoint"] = fsum["latency_by_endpoint"]
        fsum["endpoint_mix"] = [list(m) for m in endpoints_cfg["mix"]]
        fsum["endpoint_classes"] = dict(endpoints_cfg["map"])
    if tenant_store is not None:
        out_metrics["latency_by_tenant"] = \
            fsum["tenants"]["latency_by_tenant"]
        out_metrics["tenant_swaps"] = fsum["tenants"]["tenant_swaps"]
        fsum["tenant_mix"] = [list(m) for m in tenants_cfg["mix"]]
    if slo_tracker is not None:
        out_metrics["slo"] = slo_tracker.summary()
    return out_metrics, fsum, rows


def _tenant_store_of(params, names, seed, ckpt_id):
    """The ``--tenants`` adapter store: N seeded stand-in fine-tunes of
    the served tree as int8-delta pages, the JAX CLI's recipe (leaves
    walked in sorted key order, as JAX's trees keep them): ``tn0`` is a
    copy (a zero delta), ``tn1`` nudges every float leaf by 0.01 N(0, 1),
    the rest only ``out_w`` and ``out_b``."""
    from sketch_rnn_tpu_torch.serve.tenants import TenantStore

    def perturb(want, pseed):
        rng = np.random.default_rng(pseed)

        def walk(node, path=""):
            if isinstance(node, dict):
                return {k: walk(node[k], f"{path}/{k}" if path else k)
                        for k in sorted(node)}
            a = node.detach().cpu().numpy()
            hit = want is True or any(w in path for w in want)
            if (hit and np.issubdtype(a.dtype, np.floating)
                    and a.ndim >= 1):
                d = 0.01 * rng.standard_normal(a.shape)
                return (a + d).astype(a.dtype)
            return a
        return walk(params)

    store = TenantStore(params, base_ckpt_id=ckpt_id or "base")
    for i, t in enumerate(names):
        want = [] if i == 0 else (True if i == 1
                                  else ["out_w", "out_b"])
        rep = store.register(t, perturb(want, seed + 1000 + i))
        print(f"[cli] tenant {t}: {rep['pages']} adapter page(s), "
              f"{rep['nbytes']} bytes", file=sys.stderr)
    mt = store.memory_table()
    print(f"[cli] adapter memory: resident {mt['resident_bytes']} / "
          f"{mt['tenants']} full trees {mt['full_bytes']} "
          f"(ratio {mt['ratio']:.3f})", file=sys.stderr)
    return store


def _build_endpoint_requests(args, hps, scale, n, kz, kreq,
                             endpoints_cfg):
    """The seeded mixed-endpoint requests (``serve/endpoints.
    build_mix_requests``) over prefixes from the valid split
    (``--synthetic``/``--data_dir``) or a synthetic corpus."""
    from sketch_rnn_tpu_torch.serve.endpoints import build_mix_requests
    from sketch_rnn_tpu_torch.utils import prng

    mix = endpoints_cfg["mix"]
    pool, pool_labels = [], None
    if any(name != "generate" for name, _ in mix):
        if args.synthetic or args.data_dir:
            _, valid_l, _, _ = _load_data(hps, args, scale_factor=scale)
            pool, pool_labels = valid_l.strokes, valid_l.labels
        else:
            # --random_init without a corpus: a normalized synthetic pool
            from sketch_rnn_tpu_torch.data.loader import synthetic_loader
            loader, _ = synthetic_loader(hps, max(64, min(2 * n, 512)),
                                         seed=args.seed)
            pool, pool_labels = loader.strokes, loader.labels
    z = None
    if hps.conditional:
        z = prng.normal(kz, (n, hps.z_size)).numpy().astype(np.float32)
    return build_mix_requests(hps, mix, n, args.seed, kreq, z, pool,
                              pool_labels,
                              frames=endpoints_cfg["frames"],
                              temperature=args.temperature,
                              default_label=args.label)


def _warm_engine(engine, requests) -> None:
    """The engine path's warm-up outside the timed run: the same request
    count, each request capped at one step."""
    import dataclasses

    engine.run([dataclasses.replace(r, uid=None, max_len=1)
                for r in requests])


def _serve_bench_run(args, hps, slo_tracker, endpoints_cfg, tenants_cfg,
                     dev) -> int:
    """The body of ``serve-bench`` after its usage checks."""
    import time

    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.train.metrics import MetricsWriter
    from sketch_rnn_tpu_torch.utils import prng

    if args.random_init:
        model = SketchRNN(hps)
        params = model.init_params(torch.Generator().manual_seed(args.seed),
                                   device=dev)
        scale = 1.0
        init_ckpt_id = ""
    else:
        from sketch_rnn_tpu_torch.train.checkpoint import ckpt_id_of
        model, state, scale, _ = _restore(hps, args.workdir, dev)
        params = state.params
        init_ckpt_id = ckpt_id_of(int(state.step))
    # quantized serving: round the params through the serving precision
    # and stamp the serving identity; the engine serves the dequantized
    # float32 weights
    qreport = []
    if hps.serve_quantize != "float32":
        from sketch_rnn_tpu_torch.serve.quantize import (
            quantize_for_serving, stamp_ckpt_id)
        params, qreport = quantize_for_serving(params, hps.serve_quantize)
        init_ckpt_id = stamp_ckpt_id(init_ckpt_id, hps.serve_quantize)
    kz, kreq = prng.split(prng.key(args.seed), 2).unbind(dim=-2)
    n = args.n
    if endpoints_cfg is not None:
        requests = _build_endpoint_requests(args, hps, scale, n, kz, kreq,
                                            endpoints_cfg)
    else:
        z = None
        if hps.conditional:
            z = prng.normal(kz, (n, hps.z_size)).numpy().astype(
                np.float32)
        requests = [
            Request(key=prng.fold_in(kreq, i),
                    z=None if z is None else z[i],
                    label=args.label, temperature=args.temperature)
            for i in range(n)]
    tenant_store = None
    if tenants_cfg is not None:
        # pages against the served tree (after any --quantize rounding);
        # each request's tenant from the seeded mix stream
        from sketch_rnn_tpu_torch.serve.loadgen import tenant_mix_ids
        tenant_store = _tenant_store_of(params, tenants_cfg["names"],
                                        args.seed, init_ckpt_id)
        tmix = tenants_cfg["mix"]
        tids = tenant_mix_ids(n, tmix, args.seed)
        for i, r in enumerate(requests):
            r.tenant = tmix[int(tids[i])][0]
    writer = (MetricsWriter(args.workdir, name="serve")
              if args.log_metrics else None)
    fleet_report = None
    if args.fleet is not None:
        t0 = time.time()
        out_metrics, fleet_report, rows = _serve_bench_fleet(
            args, hps, model, params, requests, slo_tracker,
            endpoints_cfg, init_ckpt_id, dev, tenants_cfg, tenant_store)
        slots_v, chunk_v = fleet_report["slots"], fleet_report["chunk"]
        if writer is not None:
            for i, row in enumerate(rows):
                writer.write(i + 1, row)
    else:
        engine = ServeEngine(model, hps, params, slots=args.slots,
                             chunk=args.chunk, greedy=args.greedy,
                             device=dev, ckpt_id=init_ckpt_id)
        slots_v, chunk_v = engine.slots, engine.chunk
        _warm_engine(engine, requests)
        t0 = time.time()
        out_metrics = engine.run(requests, recycle=not args.static,
                                 metrics_writer=writer,
                                 slo=slo_tracker)["metrics"]
    if slo_tracker is not None:
        # an SLO that matched nothing reports vacuous compliance: say so
        for key, rec in sorted(slo_tracker.summary().items()):
            if rec["total"] == 0:
                print(f"[slo] WARNING: {key} matched no completed "
                      f"request (endpoint {rec['endpoint']!r} unseen) "
                      f"— its compliance is vacuous", file=sys.stderr)
    report = {
        "kind": "serve_bench_cli",
        "n_requests": n,
        "slots": slots_v,
        "chunk": chunk_v,
        "static": bool(args.static),
        "param_dtype": hps.serve_quantize,
        "quantized_tensors": len(qreport),
        "quantize_max_err": max((r["max_err"] for r in qreport),
                                default=0.0),
        "scale_factor": scale,
        "started": t0,
        **out_metrics,
        # the chunk the port runs: the CUDA kernel, or the plain chunk
        # for the hyper cell (hps.decode_kernel is a label here)
        "decode_kernel": "plain" if hps.dec_model == "hyper" else "cuda",
    }
    if fleet_report is not None:
        report["fleet"] = fleet_report
    print(json.dumps(_json_safe(report), allow_nan=False))
    return 0


def _refusal(args) -> Optional[str]:
    """What the command line asks for that the port does not have yet,
    naming the ROADMAP item that brings it; None if nothing."""
    if args.cmd in LATER_COMMANDS:
        return f"the {args.cmd} subcommand {_LATER}: " \
               f"{LATER_COMMANDS[args.cmd]}"
    later = (SERVE_BENCH_LATER_FLAGS if args.cmd == "serve-bench"
             else LATER_FLAGS)
    for dest, (default, item) in later.items():
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
                   help="length-bucketed execution: comma/semicolon-"
                        "separated bucket pad lengths (e.g. 32,64,96,250); "
                        "batches pad only to their bucket edge and each "
                        "(B, Tb) geometry gets its own kernel launches "
                        "(its own CUDA graph at --steps_per_call > 1). "
                        "Shorthand for --hparams bucket_edges=...")
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

    p = sub.add_parser("serve-bench",
                       help="continuous-batching serving benchmark")
    _add_common(p)
    p.add_argument("-n", type=int, default=64, help="number of requests")
    p.add_argument("--slots", type=int, default=0,
                   help="decoder slots B (0 = hps.serve_slots)")
    p.add_argument("--chunk", type=int, default=0,
                   help="decode steps per dispatch K (0 = hps.serve_chunk)")
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--label", type=int, default=0,
                   help="class id for class-conditional models")
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--decode_kernel", default="",
                   choices=["", "scan", "pallas"],
                   help="the JAX package's decode flavor, kept as a label: "
                        "the port serves the lstm and layer_norm cells "
                        "through its CUDA kernel either way ('pallas' "
                        "refuses the hyper cell, as in JAX). Default: "
                        "hps.decode_kernel")
    p.add_argument("--quantize", default="",
                   choices=["", "float32", "bfloat16", "int8"],
                   help="serving-parameter precision: int8 = per-tensor "
                        "symmetric, dequantized on load (error <= "
                        "scale/2 per element); bfloat16 = "
                        "round-through-bf16. The served ckpt_id is "
                        "stamped ':int8'/':bf16'. Default: "
                        "hps.serve_quantize")
    p.add_argument("--static", action="store_true",
                   help="disable slot recycling (freeze-until-batch-done "
                        "schedule, for comparison)")
    p.add_argument("--fleet", type=int, nargs="?", const=0, default=None,
                   help="serve through a fleet of N device-pinned "
                        "engines (bare/0 = one per CUDA device; with "
                        "--device cpu, N CPU replicas): one host "
                        "scheduler, SLA-aware admission, per-replica "
                        "queues")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open-loop Poisson arrival rate in requests/sec "
                        "for --fleet (seeded schedule; 0 = closed burst)")
    p.add_argument("--classes", action="append", default=[],
                   help="admission class spec for --fleet, repeatable "
                        "(e.g. 'interactive:p95<=250ms'); first spec = "
                        "highest priority; requests are assigned "
                        "round-robin over the classes. Default: one "
                        "no-deadline 'default' class")
    p.add_argument("--endpoints", action="append", default=[],
                   help="endpoint route for --fleet, repeatable: "
                        "ENDPOINT=CLASS ('complete=interactive:p95<="
                        "250ms' or 'interpolate=batch'); endpoints "
                        "generate, complete, reconstruct, interpolate")
    p.add_argument("--endpoint_mix", default="",
                   help="seeded endpoint mix, 'name:weight,...'; "
                        "default: uniform over the routed endpoints")
    p.add_argument("--frames", type=int, default=6,
                   help="latent-grid size of interpolate requests (<= "
                        "pool_cap = 4x slots)")
    p.add_argument("--random_init", action="store_true",
                   help="fresh random params instead of a checkpoint")
    p.add_argument("--log_metrics", action="store_true",
                   help="write per-request serve_metrics JSONL+CSV into "
                        "--workdir")
    p.add_argument("--slo", action="append", default=[],
                   help="latency SLO spec, repeatable: "
                        "[endpoint:[metric:]]pNN<=SECONDS; with --fleet "
                        "the endpoint names an admission class")
    p.add_argument("--draft_ckpt", default="",
                   help="speculative decoding (refused: ROADMAP queue 1 "
                        "item 6), like --draft_depth, --draft_tol and "
                        "--draft_noise")
    p.add_argument("--draft_depth", type=int, default=0)
    p.add_argument("--draft_tol", type=float, default=-1.0)
    p.add_argument("--draft_noise", type=float, default=0.0)
    p.add_argument("--tenants", type=int, default=0,
                   help="multi-tenant serving for --fleet: register N >= 2 "
                        "seeded stand-in fine-tunes ('tn0'..) as int8-delta "
                        "adapter pages against the served checkpoint and "
                        "serve them through one value-paged fleet; the "
                        "report grows latency_by_tenant, tenant_swaps and "
                        "the fleet's tenants block")
    p.add_argument("--tenant_mix", default="",
                   help="seeded tenant mix for --tenants runs, "
                        "'name:weight,...' over tn0..tnN-1 (':1' weights "
                        "the base checkpoint); default: uniform over base "
                        "and every tenant")
    p.add_argument("--tenant_cap", type=int, default=0,
                   help="cap on a tenant's outstanding pool rows (0 = "
                        "none); admission sheds a tenant at its cap")
    p.add_argument("--tenant_slo", action="append", default=[],
                   help="per-tenant SLO spec, repeatable: "
                        "tenant:class:pNN<=SECONDS")
    p.add_argument("--watch_ckpt", default="",
                   help="checkpoint rollout (refused: ROADMAP queue 1 "
                        "item 5b-ii), like --metrics_port")
    p.add_argument("--metrics_port", type=int, default=None)
    p.add_argument("--trace_dir", default="",
                   help="serving telemetry (refused: ROADMAP queue 1 item "
                        "7), like --fault_plan and --fault_seed")
    p.add_argument("--fault_plan", default="")
    p.add_argument("--fault_seed", type=int, default=0)
    p.set_defaults(fn=cmd_serve_bench)

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
