"""The training loop and the eval sweep.

The port of ``sketch_rnn_tpu/train/loop.py``'s single-device loop
(``train``, ``evaluate``, ``evaluate_per_class``). The key discipline:
``root_key, init_key = split(key(seed))``, step ``s`` trains with
``fold_in(root_key, s)`` and eval batch ``i`` uses ``fold_in(key, i)``,
so a run resumed from a checkpoint at step ``R`` continues the stream
instead of replaying it. With a ``workdir`` the loop writes the metric
files (``train/metrics.py``; the train rows one log window late), sweeps
``valid_loader`` every ``eval_every`` steps, checkpoints every
``save_every`` steps (``train/checkpoint.py``; in the background by
default, ``train/async_ckpt.py``) and at the end, resumes from the
latest checkpoint (fast-forwarding a fresh loader to the resumed step
with ``resume_align``), and sweeps ``test_loader`` at the end.

The batches come through ``data/prefetch.py``'s feeder, built after a
resume's fast-forward and closed when the loop ends: at
``hps.prefetch_depth`` batches ahead on a producer thread, which
assembles them (as int16 or bfloat16 at ``hps.transfer_dtype``) and
starts their copy to the card on a stream of its own; depth 0 feeds on
the calling thread. Every depth trains on the same batches. Eval sweeps
always feed float32.

``steps_per_call = K > 1`` feeds the K-step call
(``train/step.make_multi_train_step``: one CUDA graph replay on the card)
``[K, ...]`` stacks of K ``next_batch()`` draws, the JAX package's
stream; each call's key is ``fold_in(root_key, step)``, and a final
stretch shorter than K replays its micro-batches through the single step
with keys ``fold_in(step_key, i)``, folded into one row as the K call
folds its own (``replay_window_metrics``). A K > 1 run is not
RNG-identical to a K = 1 run; it matches the JAX package at the same K.
The cadences fire on crossing a multiple, and ``history`` holds one row
per call. ``eval_steps_per_call`` chunks the sweeps the same way
(``multi=`` on :func:`evaluate` and :func:`evaluate_per_class`): runs of
up to K batches through a K-batch call, a remainder of exactly one
through the single-batch step.

Length-bucketed execution (a loader with ``bucket_edges``): at K = 1 the
loop feeds the loader's bucketed ``next_batch`` stream, each batch at its
bucket's T. At K > 1 the bucket-run scheduler
drives it (:func:`dispatch_stack`, the JAX package's contract): the feed
is ``next_stack(K)``, a full stack of K is one K-step call built with
``key_by_global_step`` (one graph replay per geometry on the card), a
shorter run remainder replays through the single step, and every
micro-step uses ``fold_in(root_key, global step)``, so a bucketed K > 1
run is step for step the bucketed K = 1 run. The eval sweep's runs also
break where an eval batch's pad length changes. Each logged train row
carries the loader's padding ledger (``padded_frac``,
``bucket_T<edge>_n``, ``runs_per_epoch``, ``mean_run_len``,
``dispatches_saved``).

Data parallelism (``use_mesh=True``, the JAX package's default): the
loop builds the mesh of ``parallel/mesh.py`` over the process group and
every step and eval sweep runs on it, so a run over N ranks computes
what the JAX package computes over N hosts with one device each (keys
folded with the rank's data index, global-sum losses, one gradient
all-reduce a step). Each rank feeds its own rows: a loader striped over
the data axis (``load_dataset(host_id=, num_hosts=)`` at
``local_batch_hps``) is fed as it is; an unstriped loader's batches are
the global batch, and each rank takes its rows of it
(``parallel/mesh.shard_batch``). Only the primary (rank 0) writes
metrics and checkpoints and prints; every rank restores on resume, so
``workdir`` must be shared. Without a process group the world is one
rank: no collective runs, and the keys fold with 0 as on the JAX
package's one-device mesh. ``use_mesh=False`` is the JAX package's
``mesh=None`` path. Telemetry, the profiler, the watchdog and elastic
runs are not ported yet: asking for one raises, naming the later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.data.prefetch import prefetch_batches, stack_batches
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.parallel import multihost as mh
from sketch_rnn_tpu_torch.parallel.mesh import make_mesh, shard_batch
from sketch_rnn_tpu_torch.train.async_ckpt import AsyncCheckpointer
from sketch_rnn_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                   restore_checkpoint,
                                                   save_checkpoint)
from sketch_rnn_tpu_torch.train.metrics import (MetricsDrain, MetricsWriter,
                                                check_finite,
                                                scalars_from_device)
from sketch_rnn_tpu_torch.train.state import TrainState, make_train_state
from sketch_rnn_tpu_torch.train.step import (make_eval_step,
                                             make_multi_eval_step,
                                             make_multi_train_step,
                                             make_train_step,
                                             replay_window_metrics)
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.device import resolve_device, tree_to


def geometry_runs(n: int, k_max: int, geom_of=None):
    """``(i, k)`` spans of a sweep of ``n`` batches in runs of up to
    ``k_max`` that never cross a change of ``geom_of(i)`` (the JAX
    package's ``GeometryRunScheduler.geometry_runs``); without
    ``geom_of``, runs of ``k_max``, then a shorter last run."""
    i = 0
    while i < n:
        k = min(k_max, n - i)
        if k > 1 and geom_of is not None:
            run, g0 = 1, geom_of(i)
            while run < k and geom_of(i + run) == g0:
                run += 1
            k = run
        yield i, k
        i += k


def dispatch_stack(single_step, multi_step, state, batch, step: int,
                   remaining: int, root_key, k: int):
    """One bucket-run scheduler decision (the JAX package's
    ``dispatch_stack`` contract). ``batch`` is a stacked geometry-run
    prefix with leading axis ``kk <= k``, of which ``use = min(kk,
    remaining)`` micro-batches are trained on. A full ``use == k`` stack
    is one call of ``multi_step`` (built with ``key_by_global_step``: it
    folds the live step into ``root_key``; one graph replay on the card);
    anything shorter replays step by step through ``single_step`` with
    ``fold_in(root_key, step + i)``, the same keys, its metrics folded as
    the K call folds its own (:func:`replay_window_metrics`). Returns
    ``(state, metrics, use, dispatches)``, ``dispatches`` being the calls
    made (1 for a full stack, ``use`` for a replay)."""
    kk = int(batch["strokes"].shape[0])
    use = min(kk, remaining)
    if use == k:
        state, metrics = multi_step(state, batch, root_key)
        return state, metrics, use, 1
    per_step = []
    for i in range(use):
        state, m = single_step(state, {n: v[i] for n, v in batch.items()},
                               prng.fold_in(root_key, step + i))
        per_step.append(m)
    return state, replay_window_metrics(per_step), use, use


def feed_mesh(loader, mesh):
    """The mesh by which a rank takes its rows of ``loader``'s batches:
    None when they are its rows already (no mesh, a mesh of one data
    rank, or a loader striped over the data axis as this rank's stripe),
    ``mesh`` when they are the global batch (an unstriped loader); a
    loader striped another way raises."""
    if mesh is None:
        return None
    n = getattr(loader, "num_hosts", 1)
    if n == 1:
        return mesh if mesh.data_size > 1 else None
    if n != mesh.data_size or loader.host_id != mesh.data_index:
        raise ValueError(
            f"a loader striped as host {loader.host_id} of {n} feeds a "
            f"rank whose data index is {mesh.data_index} of "
            f"{mesh.data_size}; stripe it with host_id=data index and "
            f"num_hosts=the data axis's size")
    return None


def _sweep_rows(params, loader, eval_step, key, multi=None, mesh=None):
    """One metrics dict (host floats or numpy vectors) per eval batch over
    ``loader.num_eval_batches`` batches; batch ``i`` uses ``fold_in(key,
    i)``. ``multi=(multi_step, k_max)`` sweeps in :func:`geometry_runs`
    of ``k_max`` that break where ``loader.eval_pad_len`` changes (a
    bucketed loader's pad), each run of more than one batch through one
    K-batch call (one copy back to the host a run), a run of one through
    ``eval_step``: the same keys and the same bodies, so the rows are the
    per-batch sweep's. ``mesh``: the steps' mesh; a rank takes its rows
    of an unstriped loader's batches (:func:`feed_mesh`)."""
    n = loader.num_eval_batches
    if n == 0:
        raise ValueError(
            f"eval split has no batches ({len(loader)} examples, "
            f"batch_size={loader.hps.batch_size}; a striped split needs "
            f"rows in every stripe)")
    by = feed_mesh(loader, mesh)

    def rows(batch, stacked=False):
        return batch if by is None else shard_batch(batch, by, stacked)
    multi_step, k_max = multi if multi is not None else (None, 1)
    for i, k in geometry_runs(n, k_max, loader.eval_pad_len):
        if k > 1:
            out = multi_step(params, rows(stack_batches(
                [loader.get_batch(j) for j in range(i, i + k)]), True), key,
                range(i, i + k))
            host = {m: v.cpu().numpy() for m, v in out.items()}
            for j in range(k):
                yield {m: v[j] for m, v in host.items()}
            continue
        out = eval_step(params, rows(loader.get_batch(i)),
                        prng.fold_in(key, i))
        if all(v.dim() == 0 for v in out.values()):
            yield scalars_from_device(out)
        else:
            yield {k: v.cpu().numpy() for k, v in out.items()}


def evaluate(params, loader, eval_step, mesh=None,
             key: Optional[torch.Tensor] = None,
             multi=None) -> Dict[str, float]:
    """Eval metrics over a full sweep of ``loader``: each batch's
    weighted means combined by its ``weight_sum``, so the result is the
    exact mean over the split (the wrap-filled rows of the last batch
    weigh 0). ``multi=(make_multi_eval_step(...), k)`` chunks the sweep
    (:func:`_sweep_rows`). ``mesh``: the eval steps' mesh, whose
    ``weight_sum`` is the global batch's, so every rank gets the same
    result; the batch count comes from the corpus before striping, so
    every rank makes the same number of calls."""
    if key is None:
        key = prng.key(0)
    totals: Dict[str, float] = {}
    weight_total = 0.0
    for metrics in _sweep_rows(params, loader, eval_step, key, multi,
                               mesh):
        w = float(metrics.pop("weight_sum", loader.hps.batch_size))
        weight_total += w
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + float(v) * w
    return {k: v / max(weight_total, 1.0) for k, v in totals.items()}


def evaluate_per_class(params, loader, per_class_step, num_classes: int,
                       mesh=None, key: Optional[torch.Tensor] = None,
                       multi=None
                       ) -> Dict[int, Optional[Dict[str, float]]]:
    """Per-class eval metrics over one standard sweep of ``loader``:
    ``{class: metrics}``, each batch's ``[num_classes]`` vectors combined
    by its per-class real-row counts; None for a class with no example
    in the split. ``multi=(make_multi_per_class_eval_step(...), k)``
    chunks the sweep and ``mesh`` shards it as in :func:`evaluate`."""
    if key is None:
        key = prng.key(0)
    totals: Dict[str, np.ndarray] = {}
    counts = np.zeros((num_classes,), np.float64)
    for metrics in _sweep_rows(params, loader, per_class_step, key, multi,
                               mesh):
        cnt = np.asarray(metrics.pop("weight_sum"), np.float64)
        counts += cnt
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + np.asarray(v, np.float64) * cnt
    return {c: (None if counts[c] == 0 else
                {k: float(v[c] / counts[c]) for k, v in totals.items()})
            for c in range(num_classes)}


def train(hps: HParams, train_loader, valid_loader=None, test_loader=None,
          scale_factor: float = 1.0, workdir: Optional[str] = None,
          seed: int = 0, num_steps: Optional[int] = None,
          use_mesh: bool = True, resume: bool = True,
          profile: bool = False, trace_dir: Optional[str] = None,
          watchdog: bool = False, halt_on_anomaly: bool = False,
          coordinator=None, model=None, *, params=None, device=None,
          history: Optional[List[Dict[str, float]]] = None) -> TrainState:
    """Train until step ``num_steps`` (default ``hps.num_steps``) and
    return the state, as the JAX package's ``train`` does, with its
    parameters in its order; on ``device`` (the card unless
    ``device="cpu"``).

    The state starts from ``params``, else from the port's own seeded
    initialization (drawn from ``init_key``; not the JAX package's
    values), with a fresh optimizer state; with ``workdir`` and
    ``resume`` the latest checkpoint there wins over both, and its scale
    factor over ``scale_factor``. ``scale_factor`` is written into every
    checkpoint. ``use_mesh`` (default True, as in the JAX package): run on
    the mesh of the process group (the module docstring); False: the JAX
    package's ``mesh=None`` steps. ``history``, a list, is extended at the
    end with one row per call of the step this run made (per step at
    ``steps_per_call=1``; per K steps, with the window's metrics, above),
    the call's first step and its metrics as floats, read from the device
    at the end.

    Not ported yet, each refused naming its ROADMAP queue 1 item:
    ``profile``, ``watchdog`` and ``halt_on_anomaly`` (7b), ``trace_dir``
    (7c), ``coordinator`` (7d) and ``model`` (6, the distillation
    objective).
    """
    later = (("profile", profile, "7b"), ("trace_dir", trace_dir, "7c"),
             ("watchdog", watchdog, "7b"),
             ("halt_on_anomaly", halt_on_anomaly, "7b"),
             ("coordinator", coordinator, "7d"), ("model", model, "6"))
    for what, asked, item in later:
        if asked not in (False, None):
            raise NotImplementedError(
                f"train(): {what}={asked!r} comes with a later slice of "
                f"the PyTorch port (ROADMAP queue 1 item {item})")
    dev = resolve_device(device)
    num_steps = hps.num_steps if num_steps is None else num_steps
    # fail fast: an un-evaluable valid split would otherwise raise only at
    # the first sweep
    if valid_loader is not None and valid_loader.num_eval_batches == 0:
        raise ValueError(
            f"valid split is not evaluable ({len(valid_loader)} local "
            f"examples, batch_size={hps.batch_size}); enlarge the split, "
            f"reduce batch_size, or pass valid_loader=None")
    model = SketchRNN(hps)
    mesh = make_mesh(hps) if use_mesh else None
    primary = mh.is_primary()
    root_key, init_key = prng.split(prng.key(seed), 2).unbind(dim=-2)
    if params is None:
        gen = torch.Generator().manual_seed(int(init_key[1]))
        params = model.init_params(gen, device=dev)
    state = make_train_state(tree_to(params, dev))
    if workdir and resume and latest_checkpoint(workdir) is not None:
        # every rank restores: the workdir is shared storage
        state, scale_factor, meta = restore_checkpoint(workdir, state,
                                                       device=dev)
        if primary:
            print(f"[train] resumed from step {meta['step']}", flush=True)
        # crash-equivalent resume: a fresh loader's stream starts at batch
        # 0, so draw the R batches the interrupted run consumed
        if state.step and hps.resume_align:
            train_loader.fast_forward(state.step)
            if primary:
                print(f"[train] resume_align: training feed fast-forwarded "
                      f"{state.step} batches (hparam resume_align=false to "
                      f"skip)", flush=True)

    spc = hps.steps_per_call
    # the bucket-run scheduler: stacks of one geometry run, keys by the
    # global step (dispatch_stack)
    run_sched = spc > 1 and bool(getattr(train_loader, "bucket_edges", ()))
    step_fn = make_multi_train_step(model, hps, device=dev,
                                    key_by_global_step=run_sched, mesh=mesh)
    # the final stretch shorter than K, and a bucket run's remainder,
    # replay through the single step
    single_step = make_train_step(model, hps, device=dev, mesh=mesh)
    pad_ledger = getattr(train_loader, "padding_ledger", None)
    if getattr(train_loader, "bucket_edges", ()) and primary:
        sched = (f" run_sched: steps_per_call={spc} "
                 f"run_len={hps.bucket_run_len}" if run_sched else "")
        print(f"[train] bucketed execution: edges="
              f"{train_loader.bucket_edges} "
              f"shuffle_window={hps.bucket_shuffle_window}{sched}",
              flush=True)
    eval_step = make_eval_step(model, hps, device=dev, mesh=mesh)
    eval_multi = (None if hps.eval_steps_per_call == 1 else
                  (make_multi_eval_step(model, hps, device=dev, mesh=mesh),
                   hps.eval_steps_per_call))
    # only the primary writes metrics and checkpoints
    write_dir = workdir if primary else None
    drain = MetricsDrain(MetricsWriter(write_dir, "train", primary),
                         defer=hps.metrics_defer, check=check_finite)
    eval_writer = MetricsWriter(write_dir, "valid", primary)
    ckpt = (AsyncCheckpointer(write_dir)
            if write_dir and hps.async_checkpoint else None)
    step = state.step
    crossed = lambda prev, every: step // every > prev // every
    last_saved_step = None      # the highest step THIS run checkpointed
    made = []           # (first step, metrics) of each call, for history
    # after the resume's fast-forward: the producer draws ahead of the
    # loop. K draws a call, the remainder's too, as the JAX package's
    # stacking feeder draws them
    feeder = prefetch_batches(train_loader, dev, hps.prefetch_depth,
                              stack=spc, transfer_dtype=hps.transfer_dtype,
                              mesh=feed_mesh(train_loader, mesh))
    try:
        while step < num_steps:
            prev = step
            remaining = num_steps - step
            step_key = prng.fold_in(root_key, step)
            batch = feeder.get()
            if run_sched:
                state, metrics, use, calls = dispatch_stack(
                    single_step, step_fn, state, batch, step, remaining,
                    root_key, spc)
            elif spc == 1 or remaining >= spc:
                state, metrics = step_fn(state, batch, step_key)
                use, calls = spc, 1
            else:
                per_step = []
                for i in range(remaining):
                    state, m = single_step(
                        state, {k: v[i] for k, v in batch.items()},
                        prng.fold_in(step_key, i))
                    per_step.append(m)
                metrics = replay_window_metrics(per_step)
                use = calls = remaining
            if pad_ledger is not None:
                pad_ledger.record_dispatch(use, calls)
            if history is not None:
                made.append((prev, metrics))
            step = state.step
            if crossed(prev, hps.log_every) or step == num_steps:
                drain.push(step, metrics, pad_ledger.window()
                           if pad_ledger is not None else None)
            if valid_loader is not None and crossed(prev, hps.eval_every):
                ev = evaluate(state.params, valid_loader, eval_step, mesh,
                              multi=eval_multi)
                eval_writer.write(step, ev)
                eval_writer.log_console(step, ev)
            if write_dir and crossed(prev, hps.save_every):
                # drain first, so a divergence in the save step's own
                # window stops the run before its state is committed
                drain.flush()
                if ckpt is not None:
                    ckpt.save(state, scale_factor, hps)
                else:
                    save_checkpoint(write_dir, state, scale_factor, hps,
                                    retries=hps.ckpt_retries,
                                    retry_backoff_s=hps.ckpt_retry_backoff_s)
                last_saved_step = step
        drain.flush()
    finally:
        feeder.close()
        # persist the pending window for a post-mortem; nothing here may
        # mask the error in flight
        try:
            drain.flush()
        except Exception:  # noqa: BLE001
            pass
        if ckpt is not None:
            ckpt.join()
            if ckpt.failure is not None:
                print(f"[ckpt] WARNING: background checkpoint write "
                      f"failed: {ckpt.failure!r} — latest_checkpoint in "
                      f"{write_dir} is older than the last save cadence",
                      flush=True)

    if write_dir:
        if ckpt is not None:
            ckpt.wait()        # raise a background save's failure
        # the last cadenced save of THIS run may already hold this step; a
        # stale same-step checkpoint of an earlier run is overwritten
        if last_saved_step != step:
            save_checkpoint(write_dir, state, scale_factor, hps,
                            retries=hps.ckpt_retries,
                            retry_backoff_s=hps.ckpt_retry_backoff_s)
    if test_loader is not None and test_loader.num_eval_batches > 0:
        ev = evaluate(state.params, test_loader, eval_step, mesh,
                      multi=eval_multi)
        MetricsWriter(write_dir, "test").write(state.step, ev)
        if primary:
            print("[test] " + " ".join(f"{k}={v:.4f}"
                                       for k, v in sorted(ev.items())),
                  flush=True)
    if made:
        names = sorted(made[0][1])
        table = torch.stack([torch.stack([m[k].float() for k in names])
                             for _, m in made]).cpu()
        history.extend({"step": s, **dict(zip(names, vals))}
                       for (s, _), vals in zip(made, table.tolist()))
    return state
