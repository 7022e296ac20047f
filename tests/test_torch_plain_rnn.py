"""The plain recurrence path (``fused_rnn=false``) against the JAX scan.

The port's ``run_rnn(fused=False)`` is a Python loop of cell steps under
autograd; the JAX package's is ``lax.scan``. Same numpy-made inputs and
JAX-made weights (carried across with ``convert.py``), on the CPU, at
small widths (T=5, B=4, D=5, H=16; the HyperLSTM with HH=8, e=4):

- ``run_rnn`` with ``rdrop_gen`` (masks drawn from ``(key, t)``, ``t``
  the position also under ``reverse``), ``reverse``, ``hoist``
  (``precompute_inputs`` + ``step_pre``), ``remat`` (each step
  checkpointed) and ``x_extra`` (time-invariant inputs concatenated), for
  the lstm, layer_norm and hyper cells: ``hs``, the final carry and the
  gradients of every parameter, of ``xs`` and of the initial carry, at
  ``rtol=1e-5`` and ``atol=1e-6`` times each leaf's largest magnitude
  (at least 1): float32 summation order; the HyperLSTM's gradients reach
  ~10, measured gaps up to 4e-6 there;
- ``SketchRNN.loss`` and its gradients at ``fused_rnn=false`` for the
  ``vae``, ``layer_norm`` and ``hyper`` presets' cells, recurrent dropout
  on: the same tolerance;
- 3 ``make_train_step`` steps against 3 jitted JAX steps at
  ``fused_rnn=false``: parameters within ``2e-5`` (Adam divides each
  gradient by its running RMS, so a rounding gap in a near-zero gradient
  moves its update by up to ``lr``; measured worst ~1e-7, as in
  ``test_torch_train.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.ops import cells as jcells
from sketch_rnn_tpu.ops import rnn as jrnn
from sketch_rnn_tpu.train.state import TrainState as JTrainState
from sketch_rnn_tpu.train.state import make_optimizer
from sketch_rnn_tpu.train.step import _make_single_step_core
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax, params_to_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import cells, rnn
from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.ops import cuda_lstm as CL
from sketch_rnn_tpu_torch.train.state import make_train_state
from sketch_rnn_tpu_torch.train.step import make_train_step
from sketch_rnn_tpu_torch.utils import prng

T, B, D, E, H = 5, 4, 5, 3, 16
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 2e-5
KEEP = 0.9
TINY = dict(batch_size=4, max_seq_len=8, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, hyper_rnn_size=8, hyper_embed_size=4,
            conditional=True, fused_rnn=False)
PRESETS = {"vae": dict(dec_model="lstm"),
           "layer_norm": dict(dec_model="layer_norm"),
           "hyper": dict(dec_model="hyper")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    """Leaf by leaf, ``atol`` scaled by the leaf's largest magnitude (at
    least 1): a gradient of magnitude ~10 is summed from terms as large,
    and its float32 rounding gap scales with them."""
    fa = jax.tree_util.tree_leaves(a)
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb), what
    for i, (x, y) in enumerate(zip(fa, fb)):
        x = np.asarray(x)
        scale = max(1.0, float(np.abs(x).max(initial=0.0)))
        np.testing.assert_allclose(_np(y), x, rtol=rtol, atol=atol * scale,
                                   err_msg=f"{what} leaf {i}")


def _cell_case(kind):
    kw = dict(hyper_size=8, hyper_embed_size=4)
    jcell = jcells.make_cell(kind, H, **kw)
    cell = cells.make_cell(kind, H, **kw)
    jp = jax.device_get(jcell.init_params(jax.random.key(1), D + E))
    if kind == "hyper":
        # perturb the projections the init leaves at zero or constant, so
        # every gradient is dense
        rng = np.random.default_rng(5)
        for n in ("w_hz_x", "w_hz_h", "w_zd_x", "w_zd_h", "w_zd_b"):
            jp[n] = (jp[n] + 0.05 * rng.normal(size=jp[n].shape)).astype(
                np.float32)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(T, B, D)).astype(np.float32)
    xe = rng.normal(size=(B, E)).astype(np.float32)
    carry = jax.device_get(jcell.initial_carry(B))
    carry = jax.tree_util.tree_map(
        lambda z: (0.3 * rng.normal(size=z.shape)).astype(np.float32), carry)
    w = (rng.normal(size=(T, B, H)) * 0.1).astype(np.float32)
    return jcell, cell, jp, xs, xe, carry, w


@pytest.mark.parametrize("kind", ["lstm", "layer_norm", "hyper"])
@pytest.mark.parametrize("reverse,hoist,remat,extra", [
    (False, False, False, False), (True, True, True, True)])
def test_plain_run_rnn_matches_jax(kind, reverse, hoist, remat, extra):
    """hs, final carry and gradients (every parameter, xs, the carry)
    with recurrent dropout drawn in the loop from (key, t)."""
    jcell, cell, jp, xs, xe, carry, w = _cell_case(kind)
    jkey, tkey = jax.random.key(7), prng.key(7)
    xe_j = jnp.asarray(xe) if extra else None
    xs_in = xs if extra else np.concatenate(
        [xs, np.broadcast_to(xe, (T, B, E))], -1)

    def jloss(p, x, c):
        fin, hs = jrnn.run_rnn(jcell, p, x, c, reverse=reverse, hoist=hoist,
                               remat=remat, rdrop_gen=(jkey, KEEP),
                               x_extra=xe_j)
        leaves = jax.tree_util.tree_leaves(fin)
        return (jnp.sum(hs * w) + sum(0.5 * jnp.sum(v) for v in leaves),
                (fin, hs))

    (_, (jfin, jhs)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jp, jnp.asarray(xs_in), jax.tree_util.tree_map(jnp.asarray, carry))

    tp = params_from_jax(jp, device="cpu")
    p_leaves, p_def = jax.tree_util.tree_flatten(tp)
    p_leaves = [v.requires_grad_(True) for v in p_leaves]
    tp = jax.tree_util.tree_unflatten(p_def, p_leaves)
    x = torch.from_numpy(xs_in).requires_grad_(True)
    c_leaves = [torch.from_numpy(np.array(v)).requires_grad_(True)
                for v in jax.tree_util.tree_leaves(carry)]
    c0 = cell.carry_from_leaves(tuple(c_leaves))
    fin, hs = rnn.run_rnn(cell, tp, x, c0, reverse=reverse, hoist=hoist,
                          remat=remat, rdrop_gen=(tkey, KEEP),
                          x_extra=torch.from_numpy(xe) if extra else None)
    loss = (hs * torch.from_numpy(w)).sum() + sum(
        0.5 * v.sum() for v in cell.carry_leaves(fin))
    grads = torch.autograd.grad(loss, [*p_leaves, x, *c_leaves])
    _close(jhs, hs, "hs")
    _close(jfin, list(cell.carry_leaves(fin)), "final carry")
    _close(jg[0], list(grads[:len(p_leaves)]), "param grads")
    _close([jg[1], *jax.tree_util.tree_leaves(jg[2])],
           list(grads[len(p_leaves):]), "xs/carry grads")


def test_remat_recomputes_the_same_masks():
    """Under remat the backward re-runs each step: its masks come from
    (key, t), so loss and gradients equal the un-checkpointed run's bit
    for bit."""
    _, cell, jp, xs, xe, carry, w = _cell_case("layer_norm")
    out = []
    for remat in (False, True):
        tp = {k: v.requires_grad_(True) for k, v in
              params_from_jax(jp, device="cpu").items()}
        _, hs = rnn.run_rnn(cell, tp, torch.from_numpy(xs), remat=remat,
                            rdrop_gen=(prng.key(3), KEEP),
                            x_extra=torch.from_numpy(xe))
        loss = (hs * torch.from_numpy(w)).sum()
        out.append([loss, *torch.autograd.grad(loss, list(tp.values()))])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_step_masks_are_the_in_loop_draws_and_both_forms_refused():
    """``step_dropout_masks`` is, step for step, JAX's in-scan draw
    ``bernoulli(fold_in(key, t), keep, (B, H)) / keep``, bitwise."""
    key = jax.random.key(11)
    want = np.stack([np.asarray(
        jax.random.bernoulli(jax.random.fold_in(key, t), KEEP, (B, H))
        .astype(jnp.float32) / KEEP) for t in range(T)])
    got = rnn.step_dropout_masks(prng.key(11), KEEP, T, B, H)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    cell = cells.make_cell("lstm", H)
    with pytest.raises(ValueError, match="not both"):
        rnn.run_rnn(cell, {}, torch.zeros((T, B, D)),
                    rdrop_masks=got, rdrop_gen=(prng.key(1), KEEP))


@functools.lru_cache(maxsize=None)
def _jax_models(preset):
    """The JAX side of a preset, built once for both model tests."""
    kw = dict(TINY, **PRESETS[preset])
    jh, th = JHParams(**kw), HParams(**kw)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    return jh, th, jm, tm, jax.device_get(jm.init_params(jax.random.key(5)))


def _models(preset):
    jh, th, jm, tm, jp = _jax_models(preset)
    return jh, th, jm, tm, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("preset", list(PRESETS))
def test_model_loss_and_gradients_match_jax(preset):
    jh, th, jm, tm, jp, tp = _models(preset)
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=0)
    batch = loader.random_batch()

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(11), 0.37, train=True)

    (_, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    flat = [x.requires_grad_(True) for x in jax.tree_util.tree_leaves(tp)]
    ttot, tmet = tm.loss(tp, {k: torch.from_numpy(np.asarray(v))
                              for k, v in batch.items()},
                         prng.key(11), 0.37, train=True)
    tg = torch.autograd.grad(ttot, flat)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _close(jg, list(tg), "grads")


@pytest.mark.parametrize("preset", list(PRESETS))
def test_three_plain_train_steps_match_jax(preset, monkeypatch):
    """3 port steps at ``fused_rnn=false`` (as the presets train) against
    3 jitted JAX steps on the same batches and keys; no fused kernel is
    called on the way."""
    jh, th, jm, tm, jp, tp = _models(preset)
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=1)
    batches = [loader.random_batch() for _ in range(3)]
    tx = make_optimizer(jh)
    jstep = jax.jit(_make_single_step_core(jm, jh, None, tx))
    jstate = JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    step = make_train_step(tm, th, device="cpu")
    state = make_train_state(tp)

    def refuse(*a, **k):
        raise AssertionError("the plain path called a fused kernel")

    for mod, name in ((CF, "fused_lstm_seq"), (CF, "fused_lstm"),
                      (CF, "fused_ln_lstm"), (CF, "fused_hyper_lstm"),
                      (CL, "lstm_seq")):
        monkeypatch.setattr(mod, name, refuse)
    for s, b in enumerate(batches):
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v)
                                      for n, v in b.items()},
                             jax.random.fold_in(jax.random.key(7), s))
        state, met = step(state, b, prng.fold_in(prng.key(7), s))
        for k in jmet:
            np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    _close(jax.device_get(jstate.params), params_to_jax(state.params),
           "params", rtol=0.0, atol=PARAM_ATOL)
