"""The input pipeline of the port against the JAX package, on the CPU.

``sketch_rnn_tpu_torch/data/prefetch.py`` and the int16 and bfloat16
transfer paths, the port's counterparts of ``tests/test_prefetch.py``:

- the batches, with both packages' native batchers switched off so both
  take the numpy path (``tests/test_torch_native_batcher.py`` holds the
  native ones): the int16 strokes and their
  ``transfer_scale`` bitwise JAX's ``random_batch(int16_scale=)`` and
  JAX's int16 feed, unaugmented and augmented; the bfloat16 strokes'
  16-bit patterns JAX's (ml_dtypes rounds to nearest even, and so does
  torch's cast, on drawn bit patterns and on exact ties too); a stacked
  ``[K, ...]`` feed equal to K single draws;
- the feeder: depth 0 and depth 2 give the same sequence, a producer
  error is raised again, ``close()`` unblocks a full queue, a bad
  ``stack``, a bad dtype and a float-natured corpus at int16 are refused
  with JAX's text, a stacked feed of a bucketed loader is JAX's
  ``next_stack`` feed bit for bit; the int16
  feed of an augmented or non-integer corpus is within half a raw data
  unit of the float32 one;
- the step: the model's entry at int16 is bit for bit its float32 entry
  on an unaugmented integer-origin batch (loss and gradients equal), and
  the port's loss and gradients at int16 and at bfloat16 are JAX's at the
  same transfer dtype within ``tests/test_torch_train.py``'s tolerances
  (``rtol=1e-5, atol=1e-6``);
- ``train(device="cpu")`` at depth 0 and at depth 2 ends on the same
  state bit for bit, at K=1 and K=2, with a workdir and a kill and
  resume; unaugmented at int16 it ends on the float32 run's state.
"""

import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.data import prefetch as jprefetch
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.data import loader as tloader
from sketch_rnn_tpu_torch.data import prefetch as tprefetch
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.train import checkpoint as tc
from sketch_rnn_tpu_torch.train import loop as tloop
from sketch_rnn_tpu_torch.train.state import states_equal
from sketch_rnn_tpu_torch.utils import prng

TINY = dict(batch_size=4, max_seq_len=16, enc_rnn_size=8, dec_rnn_size=16,
            z_size=4, num_mixture=3, conditional=True,
            dec_model="layer_norm", num_classes=3, class_embed_size=4,
            fused_rnn=True)
RTOL, ATOL = 1e-5, 1e-6
FILES = ("cat.npz", "dog.npz", "owl.npz")
LEAVES = ("strokes", "seq_len", "labels", "transfer_scale")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_path(monkeypatch):
    """Both packages' native batchers off: both assemble on the numpy
    path and draw the same augmentation."""
    monkeypatch.setattr(jloader.NB, "assemble_batch_aug",
                        lambda *a, **k: None)
    monkeypatch.setattr(jloader.NB, "assemble_batch_aug_i16",
                        lambda *a, **k: None)
    monkeypatch.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")


def _pair(**over):
    kw = dict(TINY, **over)
    return JHParams(**kw), HParams(**kw)


def _loaders(augment=False, grid=255.0, seed=3, num=30, **over):
    """The same synthetic corpus in both packages (integer-origin at
    ``grid``)."""
    jh, th = _pair(max_seq_len=40, batch_size=6, **over)
    kw = dict(num=num, seed=seed, augment=augment, integer_grid=grid)
    return (jloader.synthetic_loader(jh, **kw)[0],
            tloader.synthetic_loader(th, **kw)[0])


def _np(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.detach().numpy()
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v


def _same(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = _np(a[k]), _np(b[k])
        assert x.dtype == y.dtype, f"{what} {k}: {x.dtype} vs {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


def _take(feeder, n):
    with feeder:
        return [feeder.get() for _ in range(n)]


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("way", ["random_batch", "feeder"])
def test_int16_batches_bitwise_jax(numpy_path, augment, way):
    jl, tl = _loaders(augment)
    assert jl.scale_factor == tl.scale_factor >= 5.0
    if way == "random_batch":
        want = [jl.random_batch(int16_scale=jl.scale_factor)
                for _ in range(3)]
        got = [tl.random_batch(int16_scale=tl.scale_factor)
               for _ in range(3)]
    else:
        want = _take(jprefetch.prefetch_batches(
            jl, mesh=None, depth=2, transfer_dtype="int16"), 3)
        got = _take(tprefetch.prefetch_batches(
            tl, None, depth=2, transfer_dtype="int16"), 3)
    for i, (a, b) in enumerate(zip(want, got)):
        assert sorted(b) == sorted(LEAVES)
        assert b["strokes"].dtype == np.int16
        assert b["transfer_scale"].dtype == np.float32
        _same(a, b, f"batch {i}")


@pytest.mark.parametrize("stack", [1, 3])
def test_bf16_strokes_bit_patterns_match_jax(stack):
    jl, tl = _loaders(grid=None)
    want = _take(jprefetch.prefetch_batches(
        jl, mesh=None, depth=1, stack=stack, transfer_dtype="bfloat16"), 2)
    got = _take(tprefetch.prefetch_batches(
        tl, None, depth=1, stack=stack, transfer_dtype="bfloat16"), 2)
    for i, (a, b) in enumerate(zip(want, got)):
        assert b["strokes"].dtype == torch.bfloat16
        assert b["strokes"].shape[:1] == ((stack,) if stack > 1 else (6,))
        _same(a, b, f"batch {i}")


def test_bf16_cast_rounds_to_nearest_even_as_ml_dtypes():
    """torch's float32 -> bfloat16 cast against ml_dtypes' ``astype`` on
    drawn finite bit patterns and on exact ties (the low 16 bits 0x8000),
    where round to nearest even decides."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64)
    bits = bits.astype(np.uint32)
    ties = (bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    x = np.concatenate([bits, ties]).view(np.float32)
    x = x[np.isfinite(x)]
    x = np.concatenate([x, np.float32([0.0, -0.0, 1.0, 3.0e38, -3.0e38,
                                       1e-40, -1e-40])])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16"])
def test_stacked_feed_is_k_single_draws(dtype):
    _, tl = _loaders(seed=5)
    _, ref = _loaders(seed=5)
    (got,) = _take(tprefetch.prefetch_batches(
        tl, None, depth=1, stack=3, transfer_dtype=dtype), 1)
    singles = _take(tprefetch.prefetch_batches(
        ref, None, depth=0, transfer_dtype=dtype), 3)
    assert sorted(got) == sorted(singles[0])
    for k in got:
        assert got[k].shape == (3,) + tuple(singles[0][k].shape)
        for i in range(3):
            np.testing.assert_array_equal(_np(got[k][i]), _np(singles[i][k]))


@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16"])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_depth_0_and_depth_2_give_the_same_sequence(dtype, device):
    _, a = _loaders(augment=True, seed=7)
    _, b = _loaders(augment=True, seed=7)
    sync = tprefetch.prefetch_batches(a, device, depth=0, stack=2,
                                      transfer_dtype=dtype)
    pre = tprefetch.prefetch_batches(b, device, depth=2, stack=2,
                                     transfer_dtype=dtype)
    assert isinstance(sync, tprefetch.SyncFeeder)
    assert isinstance(pre, tprefetch.Prefetcher)
    want, got = _take(sync, 5), _take(pre, 5)
    for i, (x, y) in enumerate(zip(want, got)):
        _same(x, y, f"batch {i}")
        if device == "cpu":
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                       for v in y.values())
    for f in (sync, pre):
        t = f.timings
        assert t["gets"] == 5 and t["batches"] >= 5
        assert min(t["assemble_s"], t["wait_s"]) > 0


def test_producer_error_is_raised_again():
    calls = {"n": 0}

    def producer():
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("loader exploded")
        return calls["n"]

    with tprefetch.Prefetcher(producer, depth=1) as feeder:
        assert feeder.get() == 1
        assert feeder.get() == 2
        with pytest.raises(RuntimeError, match="loader exploded"):
            feeder.get()


def test_close_unblocks_a_full_queue():
    feeder = tprefetch.Prefetcher(lambda: 0, depth=1)
    assert feeder.get() == 0
    t0 = time.perf_counter()
    feeder.close()
    assert time.perf_counter() - t0 < 5.0
    feeder.close()
    with pytest.raises(RuntimeError, match="closed"):
        feeder.get()
    assert not feeder._thread.is_alive()


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


class _NoScale:
    pass


def test_refusals_carry_the_jax_text():
    jl, tl = _loaders(grid=None)         # float-natured: scale ~0.3
    assert tl.scale_factor < 5.0
    cases = [dict(stack=0), dict(transfer_dtype="int8"),
             dict(transfer_dtype="int16")]
    for kw in cases:
        want = _raised(lambda: jprefetch.prefetch_batches(jl, None, 1, **kw))
        got = _raised(lambda: tprefetch.prefetch_batches(tl, None, 1, **kw))
        assert got == want, kw
    want = _raised(lambda: jprefetch.prefetch_batches(
        _NoScale(), None, 1, transfer_dtype="int16"))
    assert _raised(lambda: tprefetch.prefetch_batches(
        _NoScale(), None, 1, transfer_dtype="int16")) == want
    for scale in (0.0, -2.0):
        want = _raised(lambda: jl.random_batch(int16_scale=scale))
        assert _raised(lambda: tl.random_batch(int16_scale=scale)) == want
    # a stacked feed of a bucketed loader (once refused by name) is the
    # bucket-run scheduler's next_stack, JAX's stacked feed bit for bit
    jb, tb = _loaders(bucket_edges=(8, 16))
    with jprefetch.prefetch_batches(jb, None, 0, stack=2) as jf, \
            tprefetch.prefetch_batches(tb, None, 0, stack=2) as tf:
        for _ in range(6):
            a, b = jf.get(), tf.get()
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]), err_msg=k)


@pytest.mark.parametrize("corpus", ["augmented", "non_integer"])
def test_int16_error_is_within_half_a_data_unit(corpus):
    if corpus == "augmented":
        _, tl = _loaders(augment=True, seed=9)
        _, ref = _loaders(augment=True, seed=9)
    else:
        _, tl = _loaders(grid=None, seed=9)
        _, ref = _loaders(grid=None, seed=9)
        for loader in (tl, ref):       # undo, then normalize at 8.0
            loader.normalize(1.0 / loader.scale_factor)
            loader.normalize(8.0)
    scale = tl.scale_factor
    (got,) = _take(tprefetch.prefetch_batches(
        tl, None, depth=1, stack=3, transfer_dtype="int16"), 1)
    want = np.stack([ref.next_batch()["strokes"] for _ in range(3)])
    sc = got["transfer_scale"]
    assert sc.shape == want.shape[:2]
    deq = got["strokes"].astype(np.float32)
    deq[..., :2] /= sc[..., None, None]
    err = np.abs(deq[..., :2] - want[..., :2])
    assert 0 < err.max() <= 0.5 / scale + 1e-6
    np.testing.assert_array_equal(deq[..., 2:], want[..., 2:])


def _models(**over):
    jh, th = _pair(**over)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jp = jm.init_params(jax.random.key(5))
    return jh, th, jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def _batch(th, dtype, augment=False, seed=1):
    tl, _ = tloader.synthetic_loader(th, num=24, seed=seed, augment=augment,
                                     integer_grid=255.0)
    (b,) = _take(tprefetch.prefetch_batches(tl, "cpu", 0,
                                            transfer_dtype=dtype), 1)
    return b


def _loss_and_grads(tm, tp, batch, train_mode=True):
    flat = [x.detach().requires_grad_(True)
            for x in jax.tree_util.tree_leaves(tp)]
    live = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                        flat)
    tot, met = tm.loss(live, batch, prng.key(11), 0.37, train=train_mode)
    return met, torch.autograd.grad(tot, flat)


@pytest.mark.parametrize("train_mode", [True, False])
def test_int16_entry_is_bitwise_the_float32_entry(train_mode):
    """An unaugmented integer-origin batch: the model's int16 entry
    (reversal on the raw int16 strokes, then the division) gives the
    float32 entry's streams, so the loss and every gradient are equal bit
    for bit."""
    _, th, _, tm, _, tp = _models()
    f32, i16 = _batch(th, "float32"), _batch(th, "int16")
    assert i16["strokes"].dtype == torch.int16
    mp_f = tm._forward(tp, f32, prng.key(3), train_mode)
    mp_q = tm._forward(tp, i16, prng.key(3), train_mode)
    assert torch.equal(mp_f[1], mp_q[1])          # x_target
    (mf, gf), (mq, gq) = (_loss_and_grads(tm, tp, b, train_mode)
                          for b in (f32, i16))
    for k in mf:
        assert torch.equal(mf[k], mq[k]), k
    assert all(torch.equal(a, b) for a, b in zip(gf, gq))


@pytest.mark.parametrize("dtype", ["int16", "bfloat16"])
def test_loss_and_gradients_at_the_transfer_dtype_match_jax(numpy_path, dtype):
    """The port's loss and gradients on its ``dtype`` batch against JAX's
    on JAX's own batch of the same draws (numpy path both)."""
    jh, th, jm, tm, jp, tp = _models()
    augment = dtype == "int16"
    jl, _ = jloader.synthetic_loader(jh, num=24, seed=1, augment=augment,
                                     integer_grid=255.0)
    (jb,) = _take(jprefetch.prefetch_batches(jl, None, 1,
                                             transfer_dtype=dtype), 1)
    tb = _batch(th, dtype, augment=augment)
    _same(jb, tb)

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in jb.items()},
                       jax.random.key(11), 0.37, train=True)

    (_, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tmet, tg = _loss_and_grads(tm, tp, tb)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].detach().numpy(),
                                   np.asarray(jmet[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("npz"))
    for i, name in enumerate(FILES):
        jloader.write_synthetic_npz(os.path.join(d, name), num_train=10,
                                    num_valid=5, num_test=4, class_id=i,
                                    seed=i, max_len=14, integer_grid=255.0)
    return d


@pytest.mark.parametrize("spc", [1, 2])
def test_train_at_depth_0_and_2_is_bitwise_with_a_resume(corpus, tmp_path,
                                                         spc):
    """``train()`` at int16 from ``.npz`` files (the augmented train
    split): depth 0 straight to step 5 against depth 2 with a workdir,
    killed at its step-2 save and resumed to 5 with fresh loaders."""
    th = HParams(**dict(TINY, data_set=FILES, save_every=2, log_every=2,
                        eval_every=10 ** 9, steps_per_call=spc,
                        transfer_dtype="int16"))
    params = SketchRNN(th).init_params(torch.Generator().manual_seed(2),
                                       device="cpu")

    def run(depth, steps, workdir=None):
        h = th.replace(prefetch_depth=depth)
        tr, va, te, scale = tloader.load_dataset(h, corpus)
        assert scale >= 5.0
        rows = []
        state = tloop.train(h, tr, scale_factor=scale, workdir=workdir,
                            seed=4, num_steps=steps, params=params,
                            device="cpu", history=rows)
        return state, rows

    base, rows0 = run(0, 5)
    d = str(tmp_path / "w")
    run(2, 2, d)
    assert tc.latest_checkpoint(d) == 2
    resumed, rows2 = run(2, 5, d)
    assert resumed.step == 5
    assert states_equal(base, resumed)
    assert rows2[-1] == rows0[-1]


@pytest.mark.parametrize("spc", [1, 2])
def test_train_at_int16_unaugmented_is_the_float32_run(spc):
    """Unaugmented integer-origin data: ``train()`` at int16 and depth 2
    ends on the float32 run's state at depth 0, bit for bit."""
    _, th = _pair(steps_per_call=spc, log_every=1)
    params = SketchRNN(th).init_params(torch.Generator().manual_seed(3),
                                       device="cpu")

    def run(dtype, depth):
        h = th.replace(transfer_dtype=dtype, prefetch_depth=depth)
        tl, _ = tloader.synthetic_loader(h, num=24, seed=2,
                                         integer_grid=255.0)
        rows = []
        state = tloop.train(h, tl, seed=1, num_steps=3, params=params,
                            device="cpu", history=rows)
        return state, rows

    (a, ra), (b, rb) = run("float32", 0), run("int16", 2)
    assert states_equal(a, b)
    assert ra == rb
