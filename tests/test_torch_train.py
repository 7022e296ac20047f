"""The training slice of the port against the JAX package, on the CPU.

Tiny flagship-shaped model (conditional VAE, LSTM encoder, LayerNorm-LSTM
decoder with a class embedding, ``fused_rnn=true``, recurrent dropout at
keep 0.9), JAX-made weights carried across with ``convert.py``, the same
batch and the same threefry key in both packages. The JAX package's fused
kernels run in interpret mode, the port's through their plain versions.

- the stroke utilities bitwise, function by function;
- the loader: ``synthetic_loader`` batches bitwise (unaugmented; and
  augmented with both packages' native batchers switched off, so both
  take the numpy path);
- the losses and the schedules against ``ops/mdn.py`` / ``schedules.py``;
- ``SketchRNN.loss`` and its gradients: measured gap at these shapes 0
  on the loss and 7.6e-8 on gradients (largest gradient 0.27); held at
  ``rtol=1e-5, atol=1e-6`` (the float32 summation order of products and
  of the recurrence differs between the packages; ``z``'s noise differs
  by up to an ulp, see ``test_torch_prng.py``);
- the same loss and gradients at the ``quickdraw345_dp`` settings
  (bfloat16 compute and residuals): measured gap 0 on the loss and
  3.8e-6 on gradients, held at ``rtol=1e-3, atol=1e-4``;
- 3 steps of ``make_train_step`` against the JAX step core under
  ``jax.jit``, with the LayerNorm-LSTM decoder and with the ``vae`` /
  ``uncond_lstm`` presets' lstm decoder (``fused_lstm``): parameters
  held at ``atol=2e-5``. Adam divides each gradient by its own running
  RMS, so a float32 rounding gap in a near-zero gradient element can
  move that element's update by up to ``lr`` (1e-3); measured worst here
  1.2e-7, because no element's gradient is at the rounding level;
- ``train_state_from_jax`` after one JAX step, then one more step in
  each package;
- the training requests the port once refused (input and output
  dropout, ``bucket_edges``; bfloat16, the lstm decoder,
  ``fused_rnn=false``, the int16 and bfloat16 transfer dtypes, the
  presets) train, and the training entry points need the card unless
  asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.data import strokes as jstrokes
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.ops import cells as jcells
from sketch_rnn_tpu.ops import mdn as jmdn
from sketch_rnn_tpu.train import schedules as jsched
from sketch_rnn_tpu.train.state import TrainState as JTrainState
from sketch_rnn_tpu.train.state import make_optimizer
from sketch_rnn_tpu.train.step import _make_single_step_core
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import (params_from_jax, params_to_jax,
                                          train_state_from_jax,
                                          train_state_to_jax)
from sketch_rnn_tpu_torch.data import loader as tloader
from sketch_rnn_tpu_torch.data import strokes as tstrokes
from sketch_rnn_tpu_torch.data.prefetch import prefetch_batches
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import cells, mdn
from sketch_rnn_tpu_torch.train import schedules as tsched
from sketch_rnn_tpu_torch.train.loop import train
from sketch_rnn_tpu_torch.train.state import make_train_state, tree_items
from sketch_rnn_tpu_torch.train.step import make_train_step
from sketch_rnn_tpu_torch.utils import prng

TINY = dict(batch_size=4, max_seq_len=8, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, conditional=True, dec_model="layer_norm",
            num_classes=3, class_embed_size=4, fused_rnn=True)
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny shapes gain nothing from intra-op threads; one thread
    keeps the torch side from competing for cores with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**over):
    kw = dict(TINY, **over)
    return JHParams(**kw), HParams(**kw)


def _batch(jh, seed=0, num=24):
    loader, _ = jloader.synthetic_loader(jh, num=num, seed=seed)
    return loader.random_batch()


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _tree_close(a, b, atol, rtol=0.0, what=""):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb)
    for (path, x), y in zip(fa, fb):
        np.testing.assert_allclose(_np(y), np.asarray(x), rtol=rtol,
                                   atol=atol, err_msg=f"{what}{path}")


@pytest.mark.parametrize("augment,grid", [(False, None), (True, None),
                                          (False, 255.0)])
def test_loader_batches_bitwise(augment, grid, monkeypatch):
    jh, th = _pair(max_seq_len=40, batch_size=6)
    if augment:
        # the native batchers draw their own augmentation stream; with
        # both off both packages take the numpy path
        monkeypatch.setattr(jloader.NB, "assemble_batch_aug",
                            lambda *a, **k: None)
        monkeypatch.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")
    kw = dict(num=30, seed=3, augment=augment, integer_grid=grid)
    jl, jsf = jloader.synthetic_loader(jh, **kw)
    tl, tsf = tloader.synthetic_loader(th, **kw)
    assert jsf == tsf
    for _ in range(3):
        a, b = jl.next_batch(), tl.next_batch()
        assert sorted(a) == sorted(b)
        for k in ("strokes", "seq_len", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _stroke3(rng, n):
    s = rng.normal(0, 3, (n, 3)).astype(np.float32)
    s[:, 2] = rng.random(n) < 0.2
    s[-1, 2] = 1.0
    return s


@pytest.mark.parametrize("fn", ["to_big_strokes", "to_normal_strokes",
                                "calculate_normalizing_scale_factor",
                                "normalize_strokes", "random_scale",
                                "augment_strokes", "strokes_to_lines"])
def test_stroke_utilities_bitwise(fn):
    """Each stroke utility of the port's own copy gives the JAX package's
    values on the same inputs (and the same numpy RNG draws)."""
    rng = np.random.default_rng(6)
    seqs = [_stroke3(rng, int(n)) for n in rng.integers(3, 30, 5)]

    def call(mod, seed=1):
        g = np.random.default_rng(seed)
        f = getattr(mod, fn)
        if fn == "to_big_strokes":
            return [f(s, 32) for s in seqs]
        if fn == "to_normal_strokes":
            return [f(jstrokes.to_big_strokes(s, 32)) for s in seqs]
        if fn == "calculate_normalizing_scale_factor":
            return [np.float64(f(seqs))]
        if fn == "normalize_strokes":
            return f([s.copy() for s in seqs], 2.5)
        if fn == "random_scale":
            return [f(s, 0.15, g) for s in seqs]
        if fn == "augment_strokes":
            return [f(s, 0.3, g) for s in seqs]
        return [np.concatenate(f(s)) for s in seqs]

    want, got = call(jstrokes), call(tstrokes)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_loader_purify_and_refusals():
    seqs = [np.ones((3, 3)), np.zeros((0, 3)), np.full((50, 3), 2e3),
            np.full((4, 3), -5e3)]
    ref = jloader._purify(seqs, 10)
    got = tloader._purify(seqs, 10)
    assert len(ref) == len(got) == 2
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="record 1"):
        tloader._purify([np.ones((3, 3)), np.ones((3, 2))], 10)
    _, th = _pair()
    bucketed = tloader.DataLoader([np.ones((3, 3))],
                                  th.replace(bucket_edges=(4,)))
    assert bucketed.bucket_edges == (4, th.max_seq_len)
    assert bucketed.next_batch()["strokes"].shape == (th.batch_size, 5, 5)
    tl, _ = tloader.synthetic_loader(th, num=8)
    b = tl.random_batch(int16_scale=10.0)
    assert b["strokes"].dtype == np.int16
    np.testing.assert_array_equal(b["transfer_scale"],
                                  np.full((th.batch_size,), 10.0, np.float32))


def test_losses_and_schedules():
    rng = np.random.default_rng(0)
    raw = rng.normal(0, 1.5, (7, 4, 6 * 3 + 3)).astype(np.float32)
    tgt = np.zeros((7, 4, 5), np.float32)
    tgt[..., :2] = rng.normal(size=(7, 4, 2))
    pen = rng.integers(0, 3, (7, 4))
    tgt[np.arange(7)[:, None], np.arange(4)[None], 2 + pen] = 1.0
    jmp = jmdn.get_mixture_params(jnp.asarray(raw), 3)
    tmp = mdn.get_mixture_params(torch.from_numpy(raw), 3)
    w = np.asarray([1, 0, 1, 1], np.float32)
    for mask_pen in (False, True):
        for weights in (None, w):
            a = jmdn.reconstruction_loss(
                jmp, jnp.asarray(tgt), 9, mask_pen,
                None if weights is None else jnp.asarray(weights))
            b = mdn.reconstruction_loss(
                tmp, torch.from_numpy(tgt), 9, mask_pen,
                None if weights is None else torch.from_numpy(weights))
            for x, y in zip(a, b):
                np.testing.assert_allclose(_np(y), np.asarray(x),
                                           rtol=RTOL, atol=ATOL)
    mu, ps = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        _np(mdn.kl_loss(torch.from_numpy(mu), torch.from_numpy(ps))),
        np.asarray(jmdn.kl_loss(jnp.asarray(mu), jnp.asarray(ps))),
        rtol=RTOL, atol=ATOL)
    assert float(mdn.kl_cost_with_floor(torch.tensor(0.1), 0.2)) == \
        pytest.approx(0.2)
    jh, th = _pair()
    for step in (0, 1, 17, 5000, 123456):
        for f, g in ((jsched.lr_schedule, tsched.lr_schedule),
                     (jsched.kl_weight_schedule, tsched.kl_weight_schedule)):
            # float32 exp/log of the two libraries: an ulp apart at most
            np.testing.assert_allclose(_np(g(th, step)),
                                       np.asarray(f(jh, step)), rtol=3e-7)


@pytest.mark.parametrize("kind", ["lstm", "layer_norm"])
def test_cell_step_with_dropout_mask(kind):
    """The plain cell path's recurrent dropout on the candidate g."""
    jcell, cell = jcells.make_cell(kind, 16), cells.make_cell(kind, 16)
    jp = jcell.init_params(jax.random.key(1), 9)
    p = params_from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 9)).astype(np.float32)
    c, h = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(2))
    m = ((rng.random((4, 16)) < 0.9) / np.float32(0.9)).astype(np.float32)
    (jc, jh), _ = jcell(jp, (c, h), x, rdrop_mask=jnp.asarray(m))
    (tc, th), _ = cell(p, (torch.from_numpy(c), torch.from_numpy(h)),
                       torch.from_numpy(x), torch.from_numpy(m))
    for a, b in ((jc, tc), (jh, th)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


def _models(**over):
    jh, th = _pair(**over)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jp = jm.init_params(jax.random.key(5))
    return jh, th, jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("train_mode", [True, False])
def test_loss_and_gradients_match_jax(train_mode):
    jh, th, jm, tm, jp, tp = _models()
    batch = _batch(jh)
    kw = 0.37

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(11), kw, train=train_mode)

    (jtot, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = {k: v for k, v in tp.items()}
    flat = [x.requires_grad_(True) for x in jax.tree_util.tree_leaves(
        leaves)]
    ttot, tmet = tm.loss(leaves, _tbatch(batch), prng.key(11), kw,
                         train=train_mode)
    tg = torch.autograd.grad(ttot, flat)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _tree_close(jg, list(tg), atol=ATOL, rtol=RTOL, what="grad ")


BF16 = dict(compute_dtype="bfloat16", fused_residual_dtype="bfloat16")
# measured at these shapes (train=True / False): loss equal, largest
# gradient gap 3.8e-6 / 3.0e-8 against gradients up to ~0.3. The limits
# leave room for a bfloat16 ulp flip (2**-8 relative) in a gradient of
# magnitude <= 0.025, and hold the loss 10x tighter than a flip would
# move it.
BF_RTOL, BF_ATOL = 1e-3, 1e-4


@pytest.mark.parametrize("train_mode", [True, False])
def test_bf16_loss_and_gradients_match_jax(train_mode):
    """The ``quickdraw345_dp`` settings (bfloat16 compute and residuals,
    fused kernels): both packages round the same values at the same
    places (the weights cast once in the graph, every product's
    activation operand, the kernels' stored ``hs``/``cs``, the one-hot
    final states, each weight gradient through its cast), so loss and
    gradients agree to the bfloat16 ulps where float32 sums taken in
    another order straddle a rounding boundary."""
    jh, th, jm, tm, jp, tp = _models(**BF16)
    batch = _batch(jh)

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(11), 0.37, train=train_mode)

    (_, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    flat = [x.requires_grad_(True) for x in jax.tree_util.tree_leaves(tp)]
    ttot, tmet = tm.loss(tp, _tbatch(batch), prng.key(11), 0.37,
                         train=train_mode)
    tg = torch.autograd.grad(ttot, flat)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    gap = max(float(np.max(np.abs(_np(b) - np.asarray(a)))) for a, b in
              zip(jax.tree_util.tree_leaves(jg), tg))
    print(f"\nbf16 train={train_mode}: loss {_np(tmet['loss'])} vs "
          f"{jmet['loss']}, largest gradient gap {gap}")
    _tree_close(jg, list(tg), atol=BF_ATOL, rtol=BF_RTOL, what="grad ")


def _jax_steps(jh, jm, jp, batches, keys):
    tx = make_optimizer(jh)
    step = jax.jit(_make_single_step_core(jm, jh, None, tx))
    state = JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    out = []
    for b, k in zip(batches, keys):
        state, met = step(state, {n: jnp.asarray(v) for n, v in b.items()},
                          k)
        out.append(met)
    return state, out


def test_three_train_steps_match_jax():
    jh, th, jm, tm, jp, tp = _models()
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=1)
    batches = [loader.random_batch() for _ in range(3)]
    root = jax.random.key(7)
    jstate, jmets = _jax_steps(jh, jm, jp, batches,
                               [jax.random.fold_in(root, s)
                                for s in range(3)])
    step = make_train_step(tm, th, device="cpu")
    state = make_train_state(tp)
    for s, b in enumerate(batches):
        state, met = step(state, b, prng.fold_in(prng.key(7), s))
        for k in jmets[s]:
            np.testing.assert_allclose(_np(met[k]), np.asarray(jmets[s][k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    assert state.step == int(jstate.step) == 3
    _tree_close(jax.device_get(jstate.params), params_to_jax(state.params),
                atol=PARAM_ATOL, what="params ")
    jt = train_state_to_jax(state)
    _tree_close(jax.device_get(jstate.opt_state), jt[1], atol=PARAM_ATOL,
                rtol=1e-4, what="opt ")


@pytest.mark.parametrize("over", [
    dict(dec_model="lstm", num_classes=0),
    dict(dec_model="lstm", conditional=False, num_classes=0)])
def test_three_lstm_decoder_train_steps_match_jax(over):
    """The ``vae`` and ``uncond_lstm`` presets' cell (the lstm decoder,
    through ``fused_lstm``) at ``fused_rnn=true``: 3 port steps against
    3 jitted JAX steps, as ``test_three_train_steps_match_jax``."""
    jh, th, jm, tm, jp, tp = _models(**over)
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=1)
    batches = [loader.random_batch() for _ in range(3)]
    root = jax.random.key(7)
    jstate, jmets = _jax_steps(jh, jm, jp, batches,
                               [jax.random.fold_in(root, s)
                                for s in range(3)])
    step = make_train_step(tm, th, device="cpu")
    state = make_train_state(tp)
    for s, b in enumerate(batches):
        state, met = step(state, b, prng.fold_in(prng.key(7), s))
        for k in jmets[s]:
            np.testing.assert_allclose(_np(met[k]), np.asarray(jmets[s][k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    _tree_close(jax.device_get(jstate.params), params_to_jax(state.params),
                atol=PARAM_ATOL, what="params ")


def test_train_state_carries_across_and_continues():
    """One JAX step, the state carried into the port (and back, bitwise),
    then one more step in each package."""
    jh, th, jm, tm, jp, _ = _models()
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=2)
    b0, b1 = loader.random_batch(), loader.random_batch()
    root = jax.random.key(3)
    jstate, _ = _jax_steps(jh, jm, jp, [b0], [jax.random.fold_in(root, 0)])
    host = jax.device_get(jstate)
    tstate = train_state_from_jax(host, device="cpu")
    assert tstate.step == 1 and tstate.opt_state.adam.count == 1
    back = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(host),
        jax.tree_util.tree_leaves(train_state_to_jax(tstate)))
    for a, b in zip(jax.tree_util.tree_leaves(host),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tx = make_optimizer(jh)
    jstep = jax.jit(_make_single_step_core(jm, jh, None, tx))
    jstate2, _ = jstep(jstate, {n: jnp.asarray(v) for n, v in b0.items()},
                       jax.random.fold_in(root, 1))
    tstate2, _ = make_train_step(tm, th, device="cpu")(
        tstate, b0, prng.fold_in(prng.key(3), 1))
    assert tstate2.step == 2
    _tree_close(jax.device_get(jstate2.params), params_to_jax(
        tstate2.params), atol=PARAM_ATOL, what="params ")
    del b1


def test_train_loop_keys_and_rows():
    """train() derives step s's key as fold_in(root, s) with root, init =
    split(key(seed)): its rows equal hand-driven steps from the same
    state and the same batches."""
    _, th, _, tm, _, tp = _models()
    tl, _ = tloader.synthetic_loader(th, num=24, seed=4)
    # the mesh-less steps, as JAX's tests do (tests/test_bucketed.py:361)
    rows = []
    state = train(th, tl, seed=9, num_steps=2, params=tp, device="cpu",
                  use_mesh=False, history=rows)
    assert [r["step"] for r in rows] == [0, 1] and state.step == 2
    assert all(np.isfinite(r["loss"]) for r in rows)
    tl2, _ = tloader.synthetic_loader(th, num=24, seed=4)
    root = prng.split(prng.key(9), 2)[0]
    st = make_train_state(tp)
    step = make_train_step(tm, th, device="cpu")
    for s in range(2):
        st, met = step(st, tl2.next_batch(), prng.fold_in(root, s))
        assert float(met["loss"]) == rows[s]["loss"]


def _one_step_trains(th, seed=0):
    """One CPU step of ``th`` on its loader's ``next_batch`` (a bucketed
    one when ``th`` has ``bucket_edges``): finite metrics, every
    parameter moved. Returns the batch."""
    tm = SketchRNN(th)
    tp = tm.init_params(torch.Generator().manual_seed(seed), device="cpu")
    tl, _ = tloader.synthetic_loader(th, num=24, seed=seed)
    batch = tl.next_batch()
    state, met = make_train_step(tm, th, device="cpu")(
        make_train_state(tp), batch, prng.key(1))
    assert all(np.isfinite(float(v)) for v in met.values())
    for (_, a), (_, b) in zip(tree_items(tp), tree_items(state.params)):
        assert not torch.equal(a, b)
    return batch


@pytest.mark.parametrize("over,match", [
    ("use_input_dropout=true", "later slice"),
    ("use_output_dropout=true", "later slice"),
    ("bucket_edges=4", "later slice")])
def test_unserved_training_requests_raise_by_name(over, match):
    """Input dropout, output dropout and length buckets, which the port
    once refused by name (``match``), now train: one step each, and no
    entry point raises ``match`` any more. (The name is kept from the
    refusal tests; ``tests/test_torch_dropout.py`` and
    ``tests/test_torch_bucketed.py`` hold the features against JAX.)"""
    _, th = _pair(max_seq_len=16)
    th = th.parse(over)
    batch = _one_step_trains(th)
    if th.bucket_edges:
        assert batch["strokes"].shape[1] - 1 in (4, 16)


@pytest.mark.parametrize("over", ["compute_dtype=bfloat16",
                                  "fused_residual_dtype=bfloat16",
                                  "dec_model=lstm", "fused_rnn=false",
                                  "steps_per_call=2", "transfer_dtype=int16",
                                  "transfer_dtype=bfloat16"])
def test_formerly_refused_requests_now_train(over):
    """bfloat16 compute, bfloat16 residuals, the lstm decoder (its
    fused_lstm kernel), the plain cell path (``fused_rnn=false``, the
    presets' default), K steps a call (``steps_per_call``; the K call
    itself is ``tests/test_torch_multi_step.py``'s) and the int16 and
    bfloat16 transfer dtypes (fed a real batch of that dtype from the
    port's feeder; ``tests/test_torch_prefetch.py`` holds them against
    JAX) are served: a step on the CPU gives finite metrics and moves
    every parameter."""
    jh, th = _pair()
    th = th.parse(over)
    tm = SketchRNN(th)
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(jh)
    if th.transfer_dtype != "float32":
        tl, _ = tloader.synthetic_loader(th, num=24, integer_grid=255.0)
        with prefetch_batches(tl, "cpu", 0,
                              transfer_dtype=th.transfer_dtype) as feeder:
            batch = feeder.get()
        assert batch["strokes"].dtype == getattr(torch, th.transfer_dtype)
    state, met = make_train_step(tm, th, device="cpu")(
        make_train_state(tp), batch, prng.key(1))
    assert all(np.isfinite(float(v)) for v in met.values())
    for (_, a), (_, b) in zip(tree_items(tp), tree_items(state.params)):
        assert a.dtype == b.dtype == torch.float32
        assert not torch.equal(a, b)


@pytest.mark.parametrize("over", ["", "vae", "uncond_lstm",
                                  "quickdraw345_dp"])
def test_presets_trainable_on_the_fused_path(over):
    """The presets the port trains, as ``sketch_rnn_tpu/cli.py`` spells
    them (the 345 classes of ``quickdraw345_dp`` aside): one CPU step
    each."""
    presets = {"": "", "vae": "conditional=true,dec_model=lstm",
               "uncond_lstm": "conditional=false,dec_model=lstm",
               "quickdraw345_dp": "conditional=true,dec_model=layer_norm,"
                                  "compute_dtype=bfloat16,fused_rnn=true,"
                                  "fused_residual_dtype=bfloat16,remat=true"}
    _, th = _pair()
    _one_step_trains(th.parse(presets[over]) if over else th)


def test_train_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, th, _, tm, _, tp = _models()
    tl, _ = tloader.synthetic_loader(th, num=8)
    host = (params_to_jax(tp), ((), ((np.int32(0), params_to_jax(tp),
                                      params_to_jax(tp)), (np.int32(0),))),
            np.int32(0))
    for call in (lambda: make_train_step(tm, th),
                 lambda: train(th, tl, num_steps=1, params=tp),
                 lambda: train_state_from_jax(host)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert train_state_from_jax(host, device="cpu").step == 0


def test_train_refuses_later_slice_options():
    """Each option of the JAX package's ``train`` that the port does not
    serve yet raises, naming its ROADMAP queue 1 item."""
    _, th = _pair()
    tl, _ = tloader.synthetic_loader(th, num=8)
    for kw, item in ((dict(profile=True), "7b"), (dict(trace_dir="t"), "7c"),
                     (dict(watchdog=True), "7b"),
                     (dict(halt_on_anomaly=True), "7b"),
                     (dict(coordinator=object()), "7d"),
                     (dict(model=object()), "6")):
        with pytest.raises(NotImplementedError,
                           match=f"later slice.*item {item}\\)"):
            train(th, tl, num_steps=1, device="cpu", **kw)


def test_train_signature_is_the_jax_packages():
    """``train()`` takes the JAX package's parameters, by name, in its
    order and with its defaults; the port's own extras are keyword-only
    and come after them. It returns the state; ``history`` collects the
    rows only when the caller passes a list."""
    import inspect

    from sketch_rnn_tpu.train.loop import train as jtrain

    jsig, tsig = inspect.signature(jtrain), inspect.signature(train)
    jparams = list(jsig.parameters.values())
    tparams = list(tsig.parameters.values())
    extras = [p for p in tparams if p.kind is p.KEYWORD_ONLY]
    assert [p.name for p in extras] == ["params", "device", "history"]
    shared = tparams[:len(tparams) - len(extras)]
    assert [p.name for p in shared] == [p.name for p in jparams]
    assert [p.default for p in shared] == [p.default for p in jparams]
    assert all(p.kind is p.POSITIONAL_OR_KEYWORD for p in shared)
    _, th = _pair()
    tl, _ = tloader.synthetic_loader(th, num=8, seed=1)
    rows = []
    state = train(th, tl, None, None, 1.0, None, 0, 1, False, device="cpu",
                  history=rows)
    assert state.step == 1 and [r["step"] for r in rows] == [0]
