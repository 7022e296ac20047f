"""The loop's eval, save and resume in the port against the JAX package.

One tiny flagship-shaped model (conditional VAE, LayerNorm-LSTM decoder,
3 classes, the fused kernels: interpret-mode Pallas in the JAX package,
the plain versions in the port) on three ``.npz`` files written by the
JAX package's ``write_synthetic_npz``. One JAX ``train`` of 4 steps with
a workdir (checkpoints at steps 2 and 4; both packages' native batchers
switched off where the port meets it, so both draw the same augmented
batches)
is shared by the file:

- ``evaluate`` and ``evaluate_per_class`` of the JAX run's final
  parameters, over the valid split (its last batch wrap-filled at weight
  0), within the loss tolerance of ``tests/test_torch_train.py``
  (``rtol=1e-5, atol=1e-6``): the eval ``eps`` comes through
  ``prng.normal``, within 1e-6 of JAX's, not bitwise (measured here:
  9.5e-8 on the sweep's metrics, 4.8e-7 on the per-class ones);
- kill and resume in the port: a run stopped at its save and resumed with
  a fresh loader ends bitwise on the uninterrupted run's state (every
  parameter, moment and count), and with ``resume_align=false`` it does
  not, as ``tests/test_train.py`` pins for the JAX package; the metric
  files and checkpoint pairs are where the JAX package puts them;
- across packages: the port resumes the JAX run's step-2 checkpoint to
  step 4 and ends within the tolerance of
  ``test_three_train_steps_match_jax`` (parameters ``atol=2e-5``, the
  optimizer state ``atol=2e-5, rtol=1e-4``) of the JAX run's own step 4
  (measured: 6.0e-8 on parameters, 1.1e-8 on the moments);
- the JAX run's step-4 checkpoint served by the port (``generate``,
  ``complete``, ``reconstruct``) gives the JAX engine's strokes: steps and
  pens exact, offsets within the serving tests' 1e-5 (measured: 3.6e-7).
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.serve.endpoints import serve_requests as j_serve
from sketch_rnn_tpu.serve.engine import Request as JRequest
from sketch_rnn_tpu.train import checkpoint as jc
from sketch_rnn_tpu.train import loop as jloop
from sketch_rnn_tpu.train import step as jstep
from sketch_rnn_tpu.train.state import make_train_state as j_make_state
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax, train_state_to_jax
from sketch_rnn_tpu_torch.data import loader as tloader
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
from sketch_rnn_tpu_torch.serve.engine import Request
from sketch_rnn_tpu_torch.train import checkpoint as tc
from sketch_rnn_tpu_torch.train import loop as tloop
from sketch_rnn_tpu_torch.train import step as tstep
from sketch_rnn_tpu_torch.train.state import make_train_state, states_equal

FILES = ("cat.npz", "dog.npz", "owl.npz")
TINY = dict(batch_size=4, max_seq_len=16, enc_rnn_size=8, dec_rnn_size=16,
            z_size=4, num_mixture=3, conditional=True,
            dec_model="layer_norm", num_classes=3, class_embed_size=4,
            fused_rnn=True, data_set=FILES, save_every=2, log_every=2,
            eval_every=10 ** 9, serve_slots=4, serve_chunk=4,
            decode_kernel="pallas")
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 2e-5
SERVE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The corpus, the hparams of both packages, and one JAX run of 4 steps
    into a workdir: ``(corpus, jh, th, workdir, jax final state)``."""
    corpus = str(tmp_path_factory.mktemp("npz"))
    for i, name in enumerate(FILES):
        jloader.write_synthetic_npz(os.path.join(corpus, name),
                                    num_train=10, num_valid=5, num_test=3,
                                    class_id=i, seed=i, max_len=14,
                                    integer_grid=255.0)
    jh, th = JHParams(**TINY), HParams(**TINY)
    workdir = str(tmp_path_factory.mktemp("jax_run"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloader.NB, "assemble_batch_aug", lambda *a, **k: None)
        tr, _, _, scale = jloader.load_dataset(jh, corpus)
        final = jloop.train(jh, tr, scale_factor=scale, workdir=workdir,
                            num_steps=4, use_mesh=False, seed=5)
    return corpus, jh, th, workdir, jax.device_get(final)


def test_evaluate_matches_jax(run):
    corpus, jh, th, _, final = run
    jvalid = jloader.load_dataset(jh, corpus)[1]
    tvalid = tloader.load_dataset(th, corpus)[1]
    assert len(tvalid) % th.batch_size      # a wrap-filled last batch
    want = jloop.evaluate(final.params, jvalid,
                          jstep.make_eval_step(JSketchRNN(jh), jh))
    tp = params_from_jax(final.params, device="cpu")
    got = tloop.evaluate(tp, tvalid, tstep.make_eval_step(
        SketchRNN(th), th, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_evaluate_per_class_matches_jax(run):
    corpus, jh, th, _, final = run
    jvalid = jloader.load_dataset(jh, corpus)[1]
    tvalid = tloader.load_dataset(th, corpus)[1]
    want = jloop.evaluate_per_class(
        final.params, jvalid,
        jstep.make_per_class_eval_step(JSketchRNN(jh), jh), 3)
    got = tloop.evaluate_per_class(
        params_from_jax(final.params, device="cpu"), tvalid,
        tstep.make_per_class_eval_step(SketchRNN(th), th, device="cpu"), 3)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for c in want:
        assert sorted(got[c]) == sorted(want[c])
        for k in want[c]:
            np.testing.assert_allclose(got[c][k], want[c][k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{c} {k}")


def test_kill_and_resume_is_bitwise(run, tmp_path):
    corpus, _, th, _, _ = run
    h = th.replace(save_every=3, log_every=1, eval_every=3)

    def loaders(hps):
        return tloader.load_dataset(hps, corpus)

    tr, va, te, scale = loaders(h)
    rows = []
    base = tloop.train(h, tr, va, te, scale, seed=2, num_steps=6,
                       device="cpu", history=rows)
    assert [r["step"] for r in rows] == list(range(6))

    def interrupted(sub, align):
        hh = h.replace(resume_align=align)
        d = str(tmp_path / sub)
        tr, va, te, scale = loaders(hh)
        tloop.train(hh, tr, va, te, scale, workdir=d, seed=2, num_steps=3,
                    resume=False, device="cpu")
        assert tc.latest_checkpoint(d) == 3
        tr, va, te, _ = loaders(hh)       # a fresh process's loaders
        rows = []
        state = tloop.train(hh, tr, va, te, workdir=d, seed=2, num_steps=6,
                            device="cpu", history=rows)
        assert [r["step"] for r in rows] == [3, 4, 5]
        return state, d

    aligned, d = interrupted("aligned", True)
    assert states_equal(base, aligned)
    assert sorted(n for n in os.listdir(d) if n.startswith("ckpt_")) == [
        f"ckpt_0000000{s}.{e}" for s in (3, 6) for e in ("json", "msgpack")]
    for name in ("train", "valid", "test"):
        for ext in ("csv", "jsonl"):
            assert os.path.exists(os.path.join(d, f"{name}_metrics.{ext}"))
    restored, scale, _ = tc.restore_checkpoint(d, aligned, device="cpu")
    assert states_equal(restored, aligned)
    legacy, _ = interrupted("legacy", False)
    assert not states_equal(base, legacy)


def test_train_fails_fast_on_unevaluable_valid_split(run):
    corpus, _, th, _, _ = run
    tr, va, _, _ = tloader.load_dataset(th, corpus)
    va.strokes, va.labels = [], va.labels[:0]
    with pytest.raises(ValueError, match="not evaluable"):
        tloop.train(th, tr, va, num_steps=1, device="cpu")


def test_port_resumes_a_jax_checkpoint(run, tmp_path, monkeypatch):
    corpus, _, th, workdir, final = run
    # the JAX run trained on its numpy path: the port's too
    monkeypatch.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")
    for ext in ("json", "msgpack"):
        shutil.copy(os.path.join(workdir, f"ckpt_00000002.{ext}"),
                    tmp_path)
    tr, _, _, _ = tloader.load_dataset(th, corpus)
    # the JAX run above trained without a mesh
    rows = []
    state = tloop.train(th, tr, workdir=str(tmp_path), seed=5, num_steps=4,
                        device="cpu", use_mesh=False, history=rows)
    assert [r["step"] for r in rows] == [2, 3] and state.step == 4
    got = train_state_to_jax(state)
    for what, a, b, rtol in (("params", final.params, got[0], 0.0),
                             ("opt", final.opt_state, got[1], 1e-4)):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = jax.tree_util.tree_leaves(b)
        assert len(fa) == len(fb)
        for (path, x), y in zip(fa, fb):
            np.testing.assert_allclose(y, np.asarray(x), rtol=rtol,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{what}{path}")
    assert int(final.step) == state.step


def _prefix(rng, n):
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.normal(size=(n, 2))
    p[:, 2] = rng.random(n) < 0.2
    return p


def test_jax_checkpoint_serves_the_same_strokes(run):
    _, jh, th, workdir, _ = run
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jstate, jscale, _ = jc.restore_checkpoint(
        workdir, j_make_state(jm, jh, jax.random.key(0)))
    tstate, tscale, _ = tc.restore_checkpoint(
        workdir, make_train_state(tm.init_params(
            torch.Generator().manual_seed(0), device="cpu")), device="cpu")
    assert jscale == tscale and tstate.step == int(jstate.step) == 4
    n = 9
    rng = np.random.default_rng(3)
    keys = [jax.random.fold_in(jax.random.key(3), i) for i in range(n)]
    specs = []
    for i in range(n):
        ep = ("generate", "complete", "reconstruct")[i % 3]
        specs.append(dict(
            endpoint=ep, label=i % 3, max_len=int(rng.integers(8, 13)),
            temperature=float(rng.uniform(0.5, 1.0)),
            z=(rng.normal(size=th.z_size).astype(np.float32)
               if ep == "generate" else None),
            prefix=None if ep == "generate"
            else _prefix(rng, int(rng.integers(2, 10)))))
    jout = j_serve(jm, jh, jstate.params,
                   [JRequest(key=keys[i], **specs[i]) for i in range(n)])
    tout = serve_requests(tm, th, tstate.params, [
        Request(key=np.asarray(jax.random.key_data(keys[i])), **specs[i])
        for i in range(n)], device="cpu")
    jby = {r.uid: r for r in jout["results"]}
    tby = {r.uid: r for r in tout["results"]}
    assert sorted(jby) == sorted(tby) == list(range(n))
    for uid, a in jby.items():
        b = tby[uid]
        sa, sb = np.asarray(a.strokes5), np.asarray(b.strokes5)
        assert (a.steps, a.length, a.endpoint) == (b.steps, b.length,
                                                   b.endpoint), uid
        np.testing.assert_array_equal(sa[:, 2:], sb[:, 2:])
        np.testing.assert_allclose(sb, sa, rtol=0, atol=SERVE_TOL)


class _Rows:
    """A ``MetricsWriter`` stand-in that keeps the drained rows."""

    def __init__(self):
        self.rows = []

    def write(self, step, scalars):
        self.rows.append((step, scalars))

    def log_console(self, step, scalars):
        pass


@pytest.mark.parametrize("defer", [True, False])
def test_metrics_drain_defers_one_window(defer):
    """With ``defer`` a pushed window is written when the next one is
    pushed (the tail at ``flush``), without it inside its own ``push``; a
    non-finite window is written before ``check_finite`` raises."""
    from sketch_rnn_tpu_torch.train.metrics import MetricsDrain, check_finite

    out = _Rows()
    drain = MetricsDrain(out, defer=defer, check=check_finite)
    window = lambda v: {"loss": torch.tensor(v), "kl": torch.tensor(2 * v)}
    drain.push(1, window(0.5))
    assert out.rows == ([] if defer else [(1, {"loss": 0.5, "kl": 1.0})])
    drain.push(2, window(0.25))
    assert out.rows[-1] == (1 if defer else 2,
                            {"loss": 0.5, "kl": 1.0} if defer
                            else {"loss": 0.25, "kl": 0.5})
    drain.flush()
    assert [s for s, _ in out.rows] == [1, 2]
    with pytest.raises(FloatingPointError, match="step 3"):
        drain.push(3, window(float("nan")))
        drain.flush()
    assert out.rows[-1][0] == 3 and np.isnan(out.rows[-1][1]["loss"])
