"""K optimizer steps a call and K eval batches a call, on the CPU.

``steps_per_call`` and ``eval_steps_per_call`` in the port against the
JAX package's ``make_multi_train_step`` / ``make_multi_eval_step`` and
against the port's own single steps, at ``tests/test_torch_train.py``'s
tiny flagship-shaped widths (JAX-made weights carried across with
``convert.py``; the JAX package's fused kernels in interpret mode, the
port's through their plain versions). On the CPU the K call is the plain
version: the same body K times, eagerly (on the card one CUDA graph
replay; ``tests/test_torch_cuda.py`` holds the replay against the eager
steps there).

- the K=3 call against JAX's K=3 ``lax.scan``: parameters within
  ``PARAM_ATOL`` (2e-5), the window's ``loss``, ``grad_norm``,
  ``grad_norm_max``, ``lr`` and ``kl_weight`` within ``rtol=1e-5,
  atol=1e-6`` (JAX means the stacked metrics, the port sums them in
  order and divides: equal to float32 rounding);
- the K call bit for bit K single steps with keys ``fold_in(key, i)``,
  with the window's mean, max and last-value semantics; K=1 is the single
  step; with the bucket scheduler's ``key_by_global_step`` micro-step
  ``i`` of a call from step ``s0`` is the single step with ``fold_in(key,
  s0 + i)``;
- a step's draws (noise, dropout seeds or keys) packed on the host into
  one row unpack bit for bit to its key's draws, and the step bodies hash
  no key;
- ``train()`` at K=2 over 5 steps with a workdir: one row a call, the
  remainder's row folded, the cadences on crossings, bit for bit
  hand-driven calls; killed at step 4 and resumed to 6, bit for bit the
  uninterrupted run;
- the eval sweeps at ``eval_steps_per_call=8``: spans 8 + 6 of a 14-batch
  split and 8 + 1 of a 9-batch one (the 1 through the single-batch step),
  bit for bit the per-batch sweep, and within 1e-6 relative of the JAX
  package's ``evaluate(multi=)``.
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
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax, params_to_jax
from sketch_rnn_tpu_torch.data import loader as tloader
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.train import checkpoint as tc
from sketch_rnn_tpu_torch.train import graph as tgraph
from sketch_rnn_tpu_torch.train import loop as tloop
from sketch_rnn_tpu_torch.train import step as tstep
from sketch_rnn_tpu_torch.train.state import make_train_state, states_equal
from sketch_rnn_tpu_torch.utils import prng

TINY = dict(batch_size=4, max_seq_len=8, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, conditional=True, dec_model="layer_norm",
            num_classes=3, class_embed_size=4, fused_rnn=True)
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 2e-5
EVAL_RTOL = 1e-6
WINDOW = ("loss", "grad_norm", "grad_norm_max", "lr", "kl_weight")
FILES = ("cat.npz", "dog.npz", "owl.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(**over):
    kw = dict(TINY, **over)
    jh, th = JHParams(**kw), HParams(**kw)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jp = jm.init_params(jax.random.key(5))
    return jh, th, jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def _batches(th, k, seed=1):
    loader, _ = tloader.synthetic_loader(th, num=24, seed=seed)
    return [loader.next_batch() for _ in range(k)]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_multi_train_step_matches_jax():
    jh, th, jm, tm, jp, tp = _models()
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=1)
    stacked = tloop.stack_batches([loader.random_batch() for _ in range(3)])
    tx = make_optimizer(jh)
    jmulti = jstep.make_multi_train_step(jm, jh, None, steps_per_call=3)
    jstate, jmet = jmulti(
        JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32)),
        {k: jnp.asarray(v) for k, v in stacked.items()}, jax.random.key(7))
    multi = tstep.make_multi_train_step(tm, th.replace(steps_per_call=3),
                                        device="cpu")
    state, met = multi(make_train_state(tp), stacked, prng.key(7))
    assert state.step == int(jstate.step) == 3
    assert state.opt_state.adam.count == state.opt_state.schedule_count == 3
    for k in WINDOW:
        np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    want = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jstate.params))[0]
    got = jax.tree_util.tree_leaves(params_to_jax(state.params))
    assert len(want) == len(got)
    for (path, a), b in zip(want, got):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


@pytest.mark.parametrize("over", [
    {}, dict(dec_model="lstm", num_classes=0), dict(fused_rnn=False)])
def test_multi_train_step_is_its_single_steps_bitwise(over):
    _, th, _, tm, _, tp = _models(**over)
    batches = _batches(th, 3)
    key = prng.key(9)
    multi = tstep.make_multi_train_step(tm, th.replace(steps_per_call=3),
                                        device="cpu")
    assert multi.graphed is None
    state, met = multi(make_train_state(tp),
                       tloop.stack_batches(batches), key)
    single = tstep.make_train_step(tm, th, device="cpu")
    st, per = make_train_state(tp), []
    for i, b in enumerate(batches):
        st, m = single(st, b, prng.fold_in(key, i))
        per.append(m)
    assert states_equal(state, st)
    assert sorted(met) == sorted(list(per[0]) + ["grad_norm_max"])
    for name in per[0]:
        if name in ("lr", "kl_weight"):
            want = per[-1][name]
        else:
            want = (per[0][name] + per[1][name] + per[2][name]) / 3
        assert torch.equal(met[name], want), name
    assert torch.equal(met["grad_norm_max"], torch.stack(
        [m["grad_norm"] for m in per]).max())
    # the schedules read the live step: the window's lr is the last one's
    assert float(met["lr"]) == float(
        tstep.step_scalars(th, 2, 2, 2)[1])


def test_single_step_call_and_refusals():
    _, th, _, tm, _, tp = _models()
    (batch,) = _batches(th, 1)
    one = tstep.make_multi_train_step(tm, th.replace(steps_per_call=1),
                                      device="cpu")
    a = one(make_train_state(tp), batch, prng.key(3))
    b = tstep.make_train_step(tm, th, device="cpu")(make_train_state(tp),
                                                    batch, prng.key(3))
    assert states_equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in b[1])
    # key_by_global_step (the bucket-run scheduler's keys): micro-step i
    # of a call from step s0 is the single step with fold_in(key, s0 + i)
    st1 = a[0]
    pair = _batches(th, 2)
    by_step = tstep.make_multi_train_step(
        tm, th.replace(steps_per_call=2), device="cpu",
        key_by_global_step=True)
    got = by_step(st1, tloop.stack_batches(pair), prng.key(3))
    want = st1
    for i, b in enumerate(pair):
        want, _ = tstep.make_train_step(tm, th, device="cpu")(
            want, b, prng.fold_in(prng.key(3), st1.step + i))
    assert states_equal(got[0], want)
    multi = tstep.make_multi_train_step(tm, th.replace(steps_per_call=2),
                                        device="cpu")
    with pytest.raises(ValueError, match=r"stacked \[2"):
        multi(make_train_state(tp), tloop.stack_batches(_batches(th, 3)),
              prng.key(3))
    with pytest.raises(ValueError, match="CUDA device"):
        tgraph.GraphedCall(lambda x: x, "body", "cpu")
    tree = {"b": [torch.zeros(2), (torch.ones(1),)], "a": torch.ones(3)}
    leaves, spec = tgraph.flatten(tree)
    assert [x.shape[0] for x in leaves] == [3, 2, 1]
    back = tgraph.unflatten(spec, leaves)
    assert sorted(back) == ["a", "b"] and isinstance(back["b"][1], tuple)


@pytest.mark.parametrize("fused_rnn", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_packed_draws_are_the_keys_draws(fused_rnn, train):
    """A step's draws cross to the card packed into one float32 row: each
    row unpacks bit for bit to the draws of its own key (the dropout seeds
    of the fused path, the plain path's keys with words above 2**31), and
    the loss reads the same from the key and from the unpacked draws."""
    _, th, _, tm, _, tp = _models(fused_rnn=fused_rnn)
    (batch,) = _batches(th, 1)
    b = th.batch_size
    keys = prng.fold_in(prng.key(11), torch.arange(3))
    packed = tm.packed_draws(keys, b, train)
    assert packed.dtype == torch.float32 and packed.shape[0] == 3
    for i in range(3):
        got = tm.unpack_draws(packed[i], b, train)
        want = tm.draws(keys[i], b, train)
        assert sorted(got) == sorted(want)
        assert sorted(want) == (
            ["dec", "enc_bwd", "enc_fwd", "eps"] if train else ["eps"])
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert torch.equal(got[name], want[name]), name
    if not fused_rnn and train:
        # the plain path's key words span uint32, past int32's range
        whole = tm.draws(keys, b, True)
        assert max(int(whole[n].max())
                   for n in ("dec", "enc_fwd", "enc_bwd")) >= 2 ** 31
    batch = tstep.batch_to_device(batch, "cpu")
    by_key = tm.loss(tp, batch, keys[1], 0.5, train=train)[1]
    by_draws = tm.loss(tp, batch, tm.unpack_draws(packed[1], b, train), 0.5,
                       train=train)[1]
    assert all(torch.equal(by_key[k], by_draws[k]) for k in by_key)


@pytest.mark.parametrize("per_class", [False, True])
def test_step_bodies_hash_no_key(monkeypatch, per_class):
    """Everything a step draws from its key is made on the host before
    its body runs (``stage_steps``, ``stage_eval``): the train and eval
    bodies of the fused path call no threefry, so on the card neither the
    eager step nor a graph replay hashes a key."""
    _, th, _, tm, _, tp = _models()
    (batch,) = _batches(th, 1)
    batch = tstep.batch_to_device(batch, "cpu")
    state = make_train_state(tp)
    row = tstep.stage_steps(tm, th, state, prng.key(5)[None],
                            th.batch_size)[0]
    erow = tstep.stage_eval(tm, prng.key(6)[None], th.batch_size)[0]

    def refuse(*a):
        raise AssertionError("a key was hashed inside a step's body")

    monkeypatch.setattr(prng, "threefry2x32", refuse)
    a = state.opt_state.adam
    _, _, _, met = tstep.train_body(tm, th, tp, a.mu, a.nu, batch, row)
    assert torch.isfinite(met["loss"])
    body = tstep.per_class_body if per_class else tstep.eval_body
    with torch.no_grad():
        out = body(tm, th, tp, batch, erow)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three ``.npz`` files (the JAX package's writer): 18 valid sketches
    each, 54 in all, 14 eval batches at B=4; 12 test sketches each, 9."""
    d = str(tmp_path_factory.mktemp("npz"))
    for i, name in enumerate(FILES):
        jloader.write_synthetic_npz(os.path.join(d, name), num_train=10,
                                    num_valid=18, num_test=12, class_id=i,
                                    seed=i, max_len=14, integer_grid=255.0)
    return d


def _hps(**over):
    return HParams(**dict(TINY, max_seq_len=16, data_set=FILES, **over))


def _params(th):
    return SketchRNN(th).init_params(torch.Generator().manual_seed(2),
                                     device="cpu")


def test_train_at_k2_rows_cadences_and_hand_driven_calls(corpus, tmp_path):
    th = _hps(steps_per_call=2, log_every=2, eval_every=4, save_every=4)
    tp = _params(th)
    tr, va, te, scale = tloader.load_dataset(th, corpus)
    d = str(tmp_path / "w")
    # the mesh-less steps, as the hand-driven calls below
    rows = []
    state = tloop.train(th, tr, va, te, scale, workdir=d, seed=3,
                        num_steps=5, params=tp, device="cpu",
                        use_mesh=False, history=rows)
    assert state.step == 5 and [r["step"] for r in rows] == [0, 2, 4]
    assert sorted(n for n in os.listdir(d) if n.startswith("ckpt_")) == [
        f"ckpt_0000000{s}.{e}" for s in (4, 5) for e in ("json", "msgpack")]
    for name, steps in (("train", [2, 4, 5]), ("valid", [4]),
                        ("test", [5])):
        with open(os.path.join(d, f"{name}_metrics.jsonl")) as f:
            assert [json.loads(line)["step"] for line in f] == steps

    tm = SketchRNN(th)
    multi = tstep.make_multi_train_step(tm, th, device="cpu")
    single = tstep.make_train_step(tm, th, device="cpu")
    tr2 = tloader.load_dataset(th, corpus)[0]
    root = prng.split(prng.key(3), 2)[0]
    st = make_train_state(tp)
    want = []
    for s in (0, 2):
        st, m = multi(st, tloop.stack_batches(
            [tr2.next_batch() for _ in range(2)]), prng.fold_in(root, s))
        want.append(m)
    b4 = [tr2.next_batch() for _ in range(2)][0]
    st, m = single(st, b4, prng.fold_in(prng.fold_in(root, 4), 0))
    want.append(tstep.replay_window_metrics([m]))
    assert states_equal(state, st)
    for r, m in zip(rows, want):
        assert sorted(r) == sorted(list(m) + ["step"])
        assert all(r[k] == float(m[k]) for k in m)
    restored, _, meta = tc.restore_checkpoint(d, state, device="cpu")
    assert meta["step"] == 5 and states_equal(restored, state)


def test_kill_and_resume_at_k2_is_bitwise(corpus, tmp_path):
    th = _hps(steps_per_call=2, log_every=2, eval_every=10 ** 9,
              save_every=2)
    tp = _params(th)

    def run(steps, workdir=None):
        tr, va, te, scale = tloader.load_dataset(th, corpus)
        rows = []
        state = tloop.train(th, tr, scale_factor=scale, workdir=workdir,
                            seed=4, num_steps=steps, params=tp,
                            device="cpu", history=rows)
        return state, rows

    base, _ = run(6)
    d = str(tmp_path / "killed")
    run(4, d)
    assert tc.latest_checkpoint(d) == 4
    resumed, rows = run(6, d)
    assert [r["step"] for r in rows] == [4]
    assert states_equal(base, resumed)


class _Spans:
    """Wraps the K-batch and single-batch eval calls to record the
    sweep's spans."""

    def __init__(self, multi, single):
        self.spans = []
        self.multi, self.single = multi, single

    def multi_call(self, params, batches, key, idx):
        self.spans.append(len(idx))
        return self.multi(params, batches, key, idx)

    def single_call(self, params, batch, key):
        self.spans.append(1)
        return self.single(params, batch, key)


@pytest.mark.parametrize("per_class", [False, True])
def test_chunked_eval_sweeps_are_per_batch_sweeps(corpus, per_class):
    kw = dict(max_seq_len=16, data_set=FILES)
    jh, th, jm, tm, jp, tp = _models(**kw)
    tvalid = tloader.load_dataset(th, corpus)[1]
    jvalid = jloader.load_dataset(jh, corpus)[1]
    assert tvalid.num_eval_batches == 14 and len(tvalid) % 4
    if per_class:
        make, make_multi = (tstep.make_per_class_eval_step,
                            tstep.make_multi_per_class_eval_step)
        jmake, jmulti = (jstep.make_per_class_eval_step,
                         jstep.make_multi_per_class_eval_step)
        sweep = lambda *a, **k: tloop.evaluate_per_class(*a[:3], 3, **k)
        jsweep = lambda *a, **k: jloop.evaluate_per_class(*a[:3], 3, **k)
    else:
        make, make_multi = tstep.make_eval_step, tstep.make_multi_eval_step
        jmake, jmulti = jstep.make_eval_step, jstep.make_multi_eval_step
        sweep, jsweep = tloop.evaluate, jloop.evaluate
    spans = _Spans(make_multi(tm, th, device="cpu"),
                   make(tm, th, device="cpu"))
    got = sweep(tp, tvalid, spans.single_call, multi=(spans.multi_call, 8))
    assert spans.spans == [8, 6]
    per_batch = sweep(tp, tvalid, make(tm, th, device="cpu"))
    assert got == per_batch
    want = jsweep(jp, jvalid, jmake(jm, jh), multi=(jmulti(jm, jh), 8))
    flat = ((lambda r: {(c, k): v for c in r for k, v in r[c].items()})
            if per_class else (lambda r: r))
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=EVAL_RTOL, atol=ATOL,
                                   err_msg=str(k))


def test_eval_sweep_remainder_of_one_takes_the_single_step(corpus):
    th = _hps()
    tm, tp = SketchRNN(th), _params(th)
    test = tloader.load_dataset(th, corpus)[2]
    assert test.num_eval_batches == 9
    spans = _Spans(tstep.make_multi_eval_step(tm, th, device="cpu"),
                   tstep.make_eval_step(tm, th, device="cpu"))
    got = tloop.evaluate(tp, test, spans.single_call,
                         multi=(spans.multi_call, 8))
    assert spans.spans == [8, 1]
    assert got == tloop.evaluate(tp, test, tstep.make_eval_step(
        tm, th, device="cpu"))
    assert list(tloop.geometry_runs(14, 8)) == [(0, 8), (8, 6)]
    assert list(tloop.geometry_runs(3, 1)) == [(0, 1), (1, 1), (2, 1)]
