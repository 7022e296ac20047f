"""Length-bucketed execution in the port against the JAX package, on the
CPU.

The loader's bucketed plan and streams (``data/loader.py``), the padding
ledger (``utils/profiling.py``), the bucket-run scheduler's step
(``make_multi_train_step(key_by_global_step=True)``, ``dispatch_stack``),
bucketed ``train()`` and the eval sweep at bucket pads, at the tiny
flagship-shaped widths of ``tests/test_torch_train.py`` (JAX-made
weights carried across with ``convert.py``; the JAX package's fused
kernels in interpret mode, the port's through their plain versions):

- the loader, bit for bit the JAX ``DataLoader``: the epoch plans over
  three epochs at ``bucket_run_len`` 0 and 8 and three shuffle windows,
  the ``next_batch`` stream and ``next_stack`` at ``k_max`` 1, 3 and 5
  (augmented, with both packages' native batchers off so both take the
  numpy path; ``tests/test_torch_native_batcher.py`` holds the native
  streams), the tail ``weights``, ``eval_pad_len`` and ``get_batch``,
  ``plan_fingerprint``, ``seek_epoch``, and the padding ledger's
  ``window()`` and ``summary()`` columns;
- the step: a ``key_by_global_step`` K=3 call bit for bit three single
  steps with ``fold_in(key, s0 + i)``, and within ``rtol=1e-5,
  atol=1e-6`` (metrics) and 2e-5 (parameters) of JAX's
  ``make_multi_train_step(key_by_global_step=True)``; a replayed
  remainder's ``grad_norm_max`` the max of its steps; a weighted tail
  batch's training loss and gradients against JAX's (weight-0 rows
  change nothing);
- training: bucketed ``train()`` at K=3 bit for bit K=1 (full stacks,
  run remainders, the weighted tail, an epoch boundary), and a kill and
  resume over the bucketed stream bit for bit the uninterrupted run;
- eval: the sweep at bucket pads equal to the sweep at ``max_seq_len``
  (masked losses), and to JAX's bucketed sweep within ``rtol=1e-5,
  atol=1e-6``; its K-batch runs break at pad changes;
- the stacked prefetch feed at depth 2 equals ``next_stack``;
- the CLI: ``train --bucket_edges ... --steps_per_call 3`` with both
  dropouts runs on the CPU and logs the ledger's columns.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.train import loop as jloop
from sketch_rnn_tpu.train import step as jstep
from sketch_rnn_tpu.train.state import TrainState as JTrainState
from sketch_rnn_tpu.train.state import make_optimizer
from sketch_rnn_tpu.utils.profiling import PaddingLedger as JLedger
from sketch_rnn_tpu_torch import HParams, cli
from sketch_rnn_tpu_torch.convert import params_from_jax, params_to_jax
from sketch_rnn_tpu_torch.data import loader as tloader
from sketch_rnn_tpu_torch.data.prefetch import prefetch_batches
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.train import loop as tloop
from sketch_rnn_tpu_torch.train import step as tstep
from sketch_rnn_tpu_torch.train.state import make_train_state, states_equal
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.profiling import PaddingLedger

TINY = dict(batch_size=4, max_seq_len=24, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, conditional=True, dec_model="layer_norm",
            num_classes=3, class_embed_size=4, fused_rnn=True,
            bucket_edges=(8, 16), bucket_shuffle_window=4)
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 2e-5
WINDOW = ("loss", "grad_norm", "grad_norm_max", "lr", "kl_weight")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_path(monkeypatch):
    """Both packages' native batchers off: both assemble on the numpy
    path (the native one draws its own augmentation stream)."""
    for name in ("assemble_batch_aug", "assemble_batch_aug_i16",
                 "assemble_batch"):
        monkeypatch.setattr(jloader.NB, name, lambda *a, **k: None)
    monkeypatch.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")


def _pair(**over):
    kw = dict(TINY, **over)
    return JHParams(**kw), HParams(**kw)


def _corpus(n=70, seed=3):
    return jloader.make_synthetic_strokes(n, num_classes=3, min_len=3,
                                          max_len=22, seed=seed,
                                          integer_grid=255.0)


def _loaders(augment=False, seed=5, n=70, **over):
    jh, th = _pair(**over)
    seqs, labels = _corpus(n)
    return (jloader.DataLoader([s.copy() for s in seqs], jh, labels=labels,
                               augment=augment, seed=seed),
            tloader.DataLoader([s.copy() for s in seqs], th, labels=labels,
                               augment=augment, seed=seed))


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(y, x, err_msg=k)


# -- the loader ----------------------------------------------------------------

@pytest.mark.parametrize("run_len", [0, 8])
@pytest.mark.parametrize("window", [1, 4, 256])
def test_epoch_plans_bitwise(run_len, window):
    jl, tl = _loaders(bucket_run_len=run_len, bucket_shuffle_window=window)
    assert tl.bucket_edges == jl.bucket_edges == (8, 16, 24)
    for epoch in range(3):
        want, got = jl._plan_bucket_epoch(epoch), tl._plan_bucket_epoch(epoch)
        assert len(want) == len(got)
        for (ta, ia, wa), (tb, ib, wb) in zip(want, got):
            assert ta == tb
            np.testing.assert_array_equal(ib, ia)
            assert (wa is None) == (wb is None)
            if wa is not None:
                np.testing.assert_array_equal(wb, wa)
        assert (tl._count_geometry_runs(got)
                == jl._count_geometry_runs(want))
        assert tl.plan_fingerprint(epoch) == jl.plan_fingerprint(epoch)


@pytest.mark.parametrize("k_max", [1, 3, 5])
def test_streams_bitwise(k_max, numpy_path):
    """``next_stack(k_max)`` over three epochs against JAX's, and the
    stacks' micro-batches against the port's own ``next_batch`` stream;
    the padding ledger's columns on the way."""
    jl, tl = _loaders(augment=True)
    _, flat = _loaders(augment=True)
    seen_weights = False
    for _ in range(60):
        a, b = jl.next_stack(k_max), tl.next_stack(k_max)
        _same_batch(a, b)
        k = b["strokes"].shape[0]
        assert 1 <= k <= k_max
        seen_weights |= "weights" in b
        for i in range(k):
            _same_batch(flat.next_batch(), {n: v[i] for n, v in b.items()})
        if _ % 7 == 0:
            assert tl.padding_ledger.window() == jl.padding_ledger.window()
    assert seen_weights and tl._bucket_epoch == jl._bucket_epoch >= 3
    assert tl.padding_ledger.summary() == jl.padding_ledger.summary()


def test_tail_weights_seek_and_fast_forward(numpy_path):
    jl, tl = _loaders(augment=True)
    plan = tl._plan_bucket_epoch(0)
    tails = [(tb, w) for tb, _, w in plan if w is not None]
    assert len(tails) == 1 and 0 < tails[0][1].sum() < 4
    # every example weighs 1 exactly once an epoch
    counts = np.zeros(len(tl))
    for _, idx, w in plan:
        np.add.at(counts, idx, np.ones(4) if w is None else w)
    np.testing.assert_array_equal(counts, np.ones(len(tl)))
    for loader in (jl, tl):
        loader.seek_epoch(2)
    for _ in range(5):
        _same_batch(jl.next_batch(), tl.next_batch())
    jl2, tl2 = _loaders(augment=True)
    jl2.fast_forward(7)
    tl2.fast_forward(7)
    assert tl2.padding_ledger.window() == jl2.padding_ledger.window()
    _same_batch(jl2.next_batch(), tl2.next_batch())
    with pytest.raises(ValueError, match="seek_epoch requires"):
        tloader.DataLoader(_corpus()[0], HParams(**dict(
            TINY, bucket_edges=()))).seek_epoch(0)
    with pytest.raises(ValueError, match="next_stack is the bucketed"):
        tloader.DataLoader(_corpus()[0], HParams(**dict(
            TINY, bucket_edges=()))).next_stack(2)


def test_eval_batches_at_bucket_pads_bitwise():
    jl, tl = _loaders()
    pads = set()
    assert tl.num_eval_batches == jl.num_eval_batches == 18
    for i in range(tl.num_eval_batches):
        assert tl.eval_pad_len(i) == jl.eval_pad_len(i)
        pads.add(tl.eval_pad_len(i))
        b = tl.get_batch(i)
        _same_batch(jl.get_batch(i), b)
        assert b["strokes"].shape[1] == tl.eval_pad_len(i) + 1
    assert len(pads) > 1
    assert tl.padding_ledger.summary() == jl.padding_ledger.summary()


def test_padding_ledger_columns():
    edges = (8, 16, 24)
    a, b = JLedger(edges), PaddingLedger(edges)
    for led in (a, b):
        led.note_epoch_plan(5, 18)
        led.record(8, 4, 20)
        led.record(24, 4, 61)
        led.record_dispatch(3, 1)
    assert b.window() == a.window()
    for led in (a, b):
        led.record(16, 4, 40)
        led.record_dispatch(2, 2)
    assert b.window() == a.window()
    assert b.summary() == a.summary()
    assert sorted(b.window()) == sorted(
        ["padded_frac", "bucket_T8_n", "bucket_T16_n", "bucket_T24_n",
         "runs_per_epoch", "mean_run_len", "dispatches_saved"])


# -- the step ------------------------------------------------------------------

def _models(**over):
    jh, th = _pair(**over)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jp = jm.init_params(jax.random.key(5))
    return jh, th, jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _full_stack(th, k):
    """``k`` consecutive unweighted batches of one geometry."""
    seqs, labels = _corpus()
    loader = tloader.DataLoader(seqs, th, labels=labels, seed=5)
    while True:
        s = loader.next_stack(k)
        if s["strokes"].shape[0] == k and "weights" not in s:
            return s


def test_key_by_global_step_call_is_its_single_steps_bitwise():
    _, th, _, tm, _, tp = _models(steps_per_call=3)
    stack = _full_stack(th, 3)
    single = tstep.make_train_step(tm, th, device="cpu")
    st0, _ = single(make_train_state(tp), {k: v[0] for k, v in
                                           stack.items()}, prng.key(1))
    multi = tstep.make_multi_train_step(tm, th, device="cpu",
                                        key_by_global_step=True)
    got, met = multi(st0, stack, prng.key(4))
    st, per = st0, []
    for i in range(3):
        st, m = single(st, {k: v[i] for k, v in stack.items()},
                       prng.fold_in(prng.key(4), st0.step + i))
        per.append(m)
    want = tstep.replay_window_metrics(per)
    assert got.step == 4 and states_equal(got, st)
    assert sorted(met) == sorted(want)
    assert all(torch.equal(met[k], want[k]) for k in want)


def test_key_by_global_step_call_matches_jax():
    jh, th, jm, tm, jp, tp = _models(steps_per_call=3)
    stack = _full_stack(th, 3)
    tx = make_optimizer(jh)
    jmulti = jstep.make_multi_train_step(jm, jh, None,
                                         key_by_global_step=True)
    jstate, jmet = jmulti(
        JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32)),
        {k: jnp.asarray(v) for k, v in stack.items()}, jax.random.key(7))
    multi = tstep.make_multi_train_step(tm, th, device="cpu",
                                        key_by_global_step=True)
    state, met = multi(make_train_state(tp), stack, prng.key(7))
    assert state.step == int(jstate.step) == 3
    for k in WINDOW:
        np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    want = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jstate.params))[0]
    got = jax.tree_util.tree_leaves(params_to_jax(state.params))
    for (path, a), b in zip(want, got):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


def test_weighted_tail_batch_loss_matches_jax():
    """A plan's wrap-filled tail batch trains with its ``weights``: the
    training loss and its gradients against JAX's on the same batch and
    key (``rtol=1e-5, atol=1e-6``), and the weight-0 rows change
    nothing."""
    jh, th, jm, tm, jp, tp = _models()
    _, tl = _loaders()
    tl.normalize(tloader.S.calculate_normalizing_scale_factor(tl.strokes))
    tail = next(b for b in (tl.next_batch() for _ in range(40))
                if "weights" in b)
    assert 0 < tail["weights"].sum() < th.batch_size

    def jloss(p, batch):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(3), 0.5, train=True)

    (_, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp, tail)
    flat = [x.requires_grad_(True) for x in jax.tree_util.tree_leaves(tp)]
    ttot, tmet = tm.loss(tp, {k: torch.from_numpy(np.asarray(v))
                              for k, v in tail.items()}, prng.key(3), 0.5)
    tg = torch.autograd.grad(ttot, flat)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tg):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    # the weight-0 rows: other strokes there give the same loss
    moved = dict(tail, strokes=tail["strokes"].copy())
    moved["strokes"][tail["weights"] == 0, 1:, :2] += 0.5
    again, _ = tm.loss(tp, {k: torch.from_numpy(np.asarray(v))
                            for k, v in moved.items()}, prng.key(3), 0.5)
    assert float(again.detach()) == pytest.approx(float(ttot.detach()),
                                                  rel=1e-6)


def test_dispatch_stack_replay_accumulates_grad_norm_max():
    """The port's ``dispatch_stack`` (the JAX package's contract, as
    ``tests/test_bucketed.py`` holds it): a run remainder replays step by
    step with ``grad_norm_max`` the max of its steps, the window's mean,
    the last schedule values; a full stack is one call; the end of
    training cuts a stack to the steps left."""
    _, th, _, tm, _, tp = _models(steps_per_call=4)
    tmpl = {k: v[0] for k, v in _full_stack(th, 1).items()}
    stk = {k: np.stack([v] * 2) for k, v in tmpl.items()}
    root = prng.key(9)
    single = tstep.make_train_step(tm, th, device="cpu")
    multi = tstep.make_multi_train_step(tm, th, device="cpu",
                                        key_by_global_step=True)
    state, metrics, use, n = tloop.dispatch_stack(
        single, multi, make_train_state(tp), stk, 0, 10, root, 4)
    assert (use, n, state.step) == (2, 2, 2)
    ref, per = make_train_state(tp), []
    for i in range(2):
        ref, m = single(ref, {k: v[i] for k, v in stk.items()},
                        prng.fold_in(root, i))
        per.append(m)
    assert states_equal(state, ref)
    norms = [float(m["grad_norm"]) for m in per]
    assert float(metrics["grad_norm_max"]) == max(norms)
    assert float(metrics["grad_norm"]) == pytest.approx(np.mean(norms),
                                                        rel=1e-6)
    assert float(metrics["lr"]) == float(per[-1]["lr"])
    full = {k: np.stack([v] * 4) for k, v in tmpl.items()}
    _, m2, use2, n2 = tloop.dispatch_stack(single, multi,
                                           make_train_state(tp), full, 0,
                                           10, root, 4)
    assert (use2, n2) == (4, 1) and "grad_norm_max" in m2
    st3, _, use3, n3 = tloop.dispatch_stack(single, multi,
                                            make_train_state(tp), full, 0,
                                            3, root, 4)
    assert (use3, n3, st3.step) == (3, 3, 3)


# -- training and eval ---------------------------------------------------------

def _train_loader(th, seed=5):
    seqs, labels = _corpus()
    return tloader.DataLoader(seqs, th, labels=labels, augment=True,
                              seed=seed)


def test_bucketed_train_k3_is_k1_bitwise():
    """20 steps: an epoch is 18 batches here, so the run crosses an epoch
    boundary, replays run remainders and the weighted tail batch."""
    _, th, _, tm, _, tp = _models(bucket_run_len=4, log_every=3)
    base = tloop.train(th, _train_loader(th), num_steps=20, params=tp,
                       device="cpu")
    h3 = th.replace(steps_per_call=3)
    rows3 = []
    k3 = tloop.train(h3, _train_loader(h3), num_steps=20, params=tp,
                     device="cpu", history=rows3)
    assert base.step == k3.step == 20
    assert states_equal(base, k3)
    starts = [r["step"] for r in rows3]
    assert len(starts) < 20 and starts[0] == 0
    assert any(b - a == 3 for a, b in zip(starts, starts[1:]))
    assert any(b - a not in (0, 3) for a, b in zip(starts, starts[1:]))


def test_bucketed_kill_and_resume_is_bitwise(tmp_path):
    _, th, _, tm, _, tp = _models(save_every=5, log_every=1,
                                  steps_per_call=3, bucket_run_len=4)
    base = tloop.train(th, _train_loader(th), num_steps=21, params=tp,
                       device="cpu")
    d = str(tmp_path / "w")
    tloop.train(th, _train_loader(th), workdir=d, num_steps=10, params=tp,
                resume=False, device="cpu")
    rows = []
    resumed = tloop.train(th, _train_loader(th), workdir=d, num_steps=21,
                          params=tp, device="cpu", history=rows)
    assert rows[0]["step"] in (10, 11, 12) and resumed.step == 21
    assert states_equal(base, resumed)
    with open(os.path.join(d, "train_metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert {"padded_frac", "bucket_T8_n", "bucket_T16_n", "bucket_T24_n",
            "runs_per_epoch", "mean_run_len",
            "dispatches_saved"} <= set(logged[-1])


def test_bucketed_eval_sweep():
    """The sweep at bucket pads against the sweep of the same corpus at
    ``max_seq_len`` (the masked losses do not see the pad) and against
    JAX's bucketed sweep; at ``eval_steps_per_call=8`` its K-batch runs
    break where the pad changes and give the per-batch sweep's rows."""
    jh, th, jm, tm, jp, tp = _models()
    jl, tl = _loaders()
    _, flat = _loaders(bucket_edges=())
    step = tstep.make_eval_step(tm, th, device="cpu")
    got = tloop.evaluate(tp, tl, step)
    unbucketed = tloop.evaluate(tp, flat, step)
    want = jloop.evaluate(jp, jl, jstep.make_eval_step(jm, jh))
    assert sorted(got) == sorted(want) == sorted(unbucketed)
    for k in want:
        np.testing.assert_allclose(got[k], unbucketed[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    spans = []
    multi = tstep.make_multi_eval_step(tm, th, device="cpu")

    def counted(params, batches, key, idx):
        spans.append(list(idx))
        return multi(params, batches, key, idx)

    chunked = tloop.evaluate(tp, tl, step, multi=(counted, 8))
    assert chunked == got
    for run in spans:
        assert len({tl.eval_pad_len(i) for i in run}) == 1
    runs = list(tloop.geometry_runs(tl.num_eval_batches, 8,
                                    tl.eval_pad_len))
    assert sum(k for _, k in runs) == tl.num_eval_batches
    assert [r for r in (list(range(i, i + k)) for i, k in runs)
            if len(r) > 1] == spans


def test_stacked_prefetch_feed_is_next_stack(numpy_path):
    _, tl = _loaders(augment=True)
    _, ref = _loaders(augment=True)
    with prefetch_batches(tl, "cpu", 2, stack=3) as feeder:
        for _ in range(12):
            got, want = feeder.get(), ref.next_stack(3)
            assert sorted(got) == sorted(want)
            for k in want:
                assert torch.equal(got[k], torch.as_tensor(want[k])), k


def test_cli_trains_bucketed_with_dropout(tmp_path, capsys):
    hp = ("batch_size=4,max_seq_len=48,enc_rnn_size=8,dec_rnn_size=16,"
          "z_size=4,num_mixture=2,num_steps=7,save_every=7,eval_every=7,"
          "log_every=2,use_input_dropout=true,use_output_dropout=true,"
          "bucket_run_len=4")
    rc = cli.main(["train", "--synthetic", f"--workdir={tmp_path}",
                   "--device", "cpu", "--bucket_edges=16,32",
                   "--steps_per_call=3", f"--hparams={hp}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "bucketed execution: edges=(16, 32, 48)" in out
    assert "run_sched: steps_per_call=3" in out
    with open(tmp_path / "train_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1]["step"] == 7 and np.isfinite(rows[-1]["loss"])
    assert "padded_frac" in rows[-1] and "bucket_T16_n" in rows[-1]
    with open(tmp_path / "ckpt_00000007.json") as f:
        meta = json.load(f)
    saved = meta.get("hps", meta)
    assert list(saved["bucket_edges"]) == [16, 32]
    assert saved["use_input_dropout"] and saved["use_output_dropout"]
