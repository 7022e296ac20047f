"""The port's native batcher against the JAX package's, on the CPU.

``g++`` builds both libraries here: the port's
``sketch_rnn_tpu_torch/data/native/batcher.cc`` into ``build/native/``
and the JAX package's own copy beside its source. On the same inputs:

- each assembler (``assemble_batch``, ``assemble_batch_aug``,
  ``assemble_batch_aug_i16``) bit for bit the JAX package's, augmentation
  off and on, float32 and int16, several seeds, ``n_threads`` 1 and 4, at
  ``max_seq_len`` and at bucket edges; an empty batch gives the numpy
  layout's empty arrays and an overlong row raises (the JAX binding
  returns None there and its loader falls back);
- the properties of ``tests/test_native_batcher.py`` on the port's side:
  numpy equality unaugmented, determinism, thread-count invariance, what
  point dropout and scale jitter keep, the int16 rounding;
- the loader's default (native) streams bit for bit the JAX loader's
  default (native) streams: the augmented train split of ``load_dataset``
  over ``.npz`` files written by the JAX package's
  ``write_synthetic_npz``, through ``next_batch``, ``random_batch(
  int16_scale=)``, the feeder's int16 and bfloat16 transfer, buckets on
  with ``next_stack``, the eval batches and ``filter_by_label``;
- three ``train()`` steps from augmented native batches against the JAX
  package's steps on its own native batches, within
  ``tests/test_torch_train.py``'s tolerances;
- the build: no fallback (a compiler that fails, or cannot be run,
  raises with its text; the numpy path only through
  ``SKETCH_RNN_TPU_TORCH_NO_NATIVE=1``), a wrong ABI raises, concurrent
  builders end on one library; and the call counters.
"""

import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.data import native_batcher as JNB
from sketch_rnn_tpu.data import prefetch as jprefetch
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.train.state import TrainState as JTrainState
from sketch_rnn_tpu.train.state import make_optimizer
from sketch_rnn_tpu.train.step import _make_single_step_core
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax, params_to_jax
from sketch_rnn_tpu_torch.data import loader as tloader
from sketch_rnn_tpu_torch.data import native_batcher as NB
from sketch_rnn_tpu_torch.data import prefetch as tprefetch
from sketch_rnn_tpu_torch.train.loop import train

FILES = ("a.npz", "b.npz", "c.npz")
TINY = dict(batch_size=6, max_seq_len=40, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, conditional=True,
            dec_model="layer_norm", num_classes=3, class_embed_size=4,
            fused_rnn=True, data_set=FILES)
RTOL, ATOL = 1e-5, 1e-6          # tests/test_torch_train.py's
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    """Both packages on their default native path whatever the
    environment says."""
    monkeypatch.delenv(NB.NO_NATIVE_ENV, raising=False)
    monkeypatch.delenv("SKETCH_RNN_TPU_NO_NATIVE", raising=False)
    assert JNB.available() and NB.available()


def _seqs(n=40, seed=3, min_len=5, max_len=60):
    seqs, _ = jloader.make_synthetic_strokes(n, min_len=min_len,
                                             max_len=max_len, seed=seed)
    return [np.asarray(s, np.float32) for s in seqs]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# -- the assemblers against the JAX package's ---------------------------------

@pytest.mark.parametrize("max_len", [64, 96])
def test_assemble_batch_matches_jax(max_len):
    seqs = _seqs()
    got = NB.assemble_batch(seqs, max_len)
    _equal(got, JNB.assemble_batch(seqs, max_len))
    _equal(got, JNB.pad_batch_numpy(seqs, max_len))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 63 - 1])
@pytest.mark.parametrize("aug", [(0.0, 0.0), (0.15, 0.1), (0.3, 0.5)])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_augmenting_assemblers_match_jax(dtype, aug, seed, threads):
    """96 sequences, so ``n_threads=4`` runs four threads."""
    seqs = _seqs(n=96, seed=seed % 1000)
    scale, drop = aug
    if dtype == "float32":
        got = NB.assemble_batch_aug(seqs, 64, scale, drop, seed=seed,
                                    n_threads=threads)
        want = JNB.assemble_batch_aug(seqs, 64, scale, drop, seed=seed,
                                      n_threads=threads)
    else:
        got = NB.assemble_batch_aug_i16(seqs, 64, scale, drop, seed=seed,
                                        quant=12.25, n_threads=threads)
        want = JNB.assemble_batch_aug_i16(seqs, 64, scale, drop, seed=seed,
                                          quant=12.25, n_threads=threads)
    _equal(got, want)


@pytest.mark.parametrize("edge", [16, 24, 60])
def test_bucket_edges_match_jax(edge):
    """Padded only to a bucket edge that the rows fit: every assembler."""
    seqs = [s for s in _seqs(n=60, min_len=3, max_len=60) if len(s) <= edge]
    assert seqs
    _equal(NB.assemble_batch(seqs, edge), JNB.assemble_batch(seqs, edge))
    _equal(NB.assemble_batch_aug(seqs, edge, 0.15, 0.1, seed=5),
           JNB.assemble_batch_aug(seqs, edge, 0.15, 0.1, seed=5))
    _equal(NB.assemble_batch_aug_i16(seqs, edge, 0.15, 0.1, seed=5,
                                     quant=3.5),
           JNB.assemble_batch_aug_i16(seqs, edge, 0.15, 0.1, seed=5,
                                      quant=3.5))


def test_empty_and_overlong_batches():
    """An empty batch is the numpy layout's empty arrays; an overlong row
    raises with ``to_big_strokes``'s text (the JAX binding returns None
    for both and its loader falls back to numpy)."""
    want = JNB.pad_batch_numpy([], 8)
    for got in (NB.assemble_batch([], 8),
                NB.assemble_batch_aug([], 8, 0.1, 0.1, seed=1),
                NB.assemble_batch_aug_i16([], 8, 0.1, 0.1, seed=1,
                                          quant=2.0)):
        assert got[0].shape == want[0].shape and got[1].shape == (0,)
    long = [np.zeros((3, 3), np.float32), np.zeros((10, 3), np.float32)]
    assert JNB.assemble_batch(long, 5) is None
    for call in (lambda: NB.assemble_batch(long, 5),
                 lambda: NB.assemble_batch_aug(long, 5, 0.1, 0.1, seed=1),
                 lambda: NB.assemble_batch_aug_i16(long, 5, 0.1, 0.1,
                                                   seed=1, quant=2.0),
                 lambda: NB.pad_batch_numpy(long, 5)):
        with pytest.raises(ValueError,
                           match="sequence of length 10 exceeds max_len 5"):
            call()
    with pytest.raises(ValueError, match="quant must be positive"):
        NB.assemble_batch_aug_i16(long[:1], 5, 0.0, 0.0, seed=0, quant=0.0)


def test_stream_batches_matches_jax():
    seqs = _seqs(n=23, min_len=1, max_len=50)
    seqs.insert(5, np.zeros((0, 3), np.float32))
    items = [(i % 3, s) for i, s in enumerate(seqs)]
    got = list(NB.stream_batches(iter(items), 4, 40))
    want = list(JNB.stream_batches(iter(items), 4, 40))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        _equal([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])


# -- the properties of tests/test_native_batcher.py, on the port's side --------

def test_native_matches_numpy():
    seqs = _seqs(n=8, min_len=5, max_len=60)
    _equal(NB.assemble_batch(seqs, 64), NB.pad_batch_numpy(seqs, 64))


def test_loader_native_and_numpy_paths_agree_unaugmented(monkeypatch):
    """Unaugmented batches (eval and train) are the same bits on either
    path, at float32 and int16."""
    th = HParams(batch_size=4, max_seq_len=48)
    seqs, labels = jloader.make_synthetic_strokes(8, min_len=5, max_len=40,
                                                  seed=1)

    def batches():
        ld = tloader.DataLoader([np.array(s) for s in seqs], th,
                                labels=labels, seed=7)
        ld.normalize(4.5)
        return [ld.get_batch(0), ld.next_batch(),
                ld.random_batch(int16_scale=ld.scale_factor)]

    native = batches()
    monkeypatch.setenv(NB.NO_NATIVE_ENV, "1")
    numpy_path = batches()
    for a, b in zip(native, numpy_path):
        assert sorted(a) == sorted(b)
        _equal([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])


def test_aug_no_op_matches_plain():
    seqs = _seqs(n=32, min_len=20)
    _equal(NB.assemble_batch_aug(seqs, 64, 0.0, 0.0, seed=1),
           NB.assemble_batch(seqs, 64))


def test_aug_deterministic_and_seed_dependent():
    seqs = _seqs(n=32, min_len=20)
    a = NB.assemble_batch_aug(seqs, 64, 0.15, 0.1, seed=42)
    _equal(a, NB.assemble_batch_aug(seqs, 64, 0.15, 0.1, seed=42))
    assert not np.array_equal(
        a[0], NB.assemble_batch_aug(seqs, 64, 0.15, 0.1, seed=43)[0])


def test_aug_thread_count_invariant():
    seqs = _seqs(n=96, min_len=20)
    _equal(NB.assemble_batch_aug(seqs, 64, 0.15, 0.1, seed=9, n_threads=1),
           NB.assemble_batch_aug(seqs, 64, 0.15, 0.1, seed=9, n_threads=4))


def test_aug_dropout_preserves_drawing():
    seqs = _seqs(n=48, min_len=20)
    out, lens = NB.assemble_batch_aug(seqs, 64, 0.0, 0.3, seed=11)
    orig = np.array([len(s) for s in seqs])
    assert (lens <= orig).all() and (lens < orig).any()
    for i, s in enumerate(seqs):
        got = out[i, 1:1 + lens[i]]
        np.testing.assert_allclose(got[:, :2].sum(0), s[:, :2].sum(0),
                                   rtol=1e-5, atol=1e-5)
        assert int(got[:, 3].sum()) == int(s[:, 2].sum())


def test_aug_scale_is_per_axis_uniform():
    seqs = _seqs(n=64, min_len=20)
    f = 0.15
    out, lens = NB.assemble_batch_aug(seqs, 64, f, 0.0, seed=3)
    scales = []
    for i, s in enumerate(seqs):
        got = out[i, 1:1 + lens[i], :2]
        per_axis = []
        for ax in (0, 1):
            nz = np.abs(s[:, ax]) > 1e-6
            k = np.median(got[nz, ax] / s[nz, ax])
            np.testing.assert_allclose(got[:, ax], s[:, ax] * k, rtol=1e-4,
                                       atol=1e-6)
            assert 1 - f - 1e-5 <= k <= 1 + f + 1e-5
            per_axis.append(k)
        scales.append(per_axis)
    assert np.array(scales).std(0).min() > 0.01


def test_aug_length_reduction_tracks_prob():
    rng = np.random.default_rng(0)
    n, length = 64, 60
    seqs = []
    for _ in range(n):
        s = np.zeros((length, 3), np.float32)
        s[:, :2] = rng.normal(size=(length, 2)).astype(np.float32)
        s[-1, 2] = 1.0
        seqs.append(s)
    _, lens = NB.assemble_batch_aug(seqs, length, 0.0, 0.25, seed=17)
    rate = (length - lens).sum() / ((length - 3) * n)
    assert abs(rate - 0.25) < 0.05


def test_loader_train_batch_uses_native_aug():
    th = HParams(batch_size=16, max_seq_len=64, augment_stroke_prob=0.2,
                 random_scale_factor=0.15)
    seqs, labels = jloader.make_synthetic_strokes(32, min_len=20,
                                                  max_len=60, seed=2)
    ld = tloader.DataLoader([np.array(s) for s in seqs], th, labels=labels,
                            augment=True, seed=3)
    NB.reset_call_counts()
    b = ld.random_batch()
    assert NB.call_counts() == {"assemble_batch": 0, "assemble_batch_aug": 1,
                                "assemble_batch_aug_i16": 0,
                                "pad_batch_numpy": 0}
    assert b["strokes"].shape == (16, 65, 5)
    assert np.isfinite(b["strokes"]).all()
    onehot = b["strokes"][:, :, 2:].sum(-1)
    np.testing.assert_array_equal(onehot, np.ones_like(onehot))
    assert (b["seq_len"] >= 1).all() and (b["seq_len"] <= 64).all()
    assert not np.array_equal(b["strokes"], ld.random_batch()["strokes"])


def test_i16_assembler_matches_numpy_quantization():
    """The int16 assembler is the float32 one quantized by the loader's
    numpy ``quantize_int16`` (both round half to even), unaugmented and
    augmented with the same seed."""
    seqs = _seqs(n=24, seed=5, min_len=10, max_len=40)
    for sf, dp, seed in ((0.0, 0.0, 0), (0.15, 0.2, 99)):
        f32, lens_f = NB.assemble_batch_aug(seqs, 48, sf, dp, seed=seed)
        i16, lens_q = NB.assemble_batch_aug_i16(seqs, 48, sf, dp,
                                                seed=seed, quant=12.25)
        np.testing.assert_array_equal(lens_f, lens_q)
        assert i16.dtype == np.int16
        np.testing.assert_array_equal(i16,
                                      tloader.quantize_int16(f32, 12.25))


# -- the loader's default streams against the JAX loader's -----------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("npz"))
    for i, name in enumerate(FILES):
        jloader.write_synthetic_npz(os.path.join(d, name), num_train=14,
                                    num_valid=5, num_test=4, class_id=i,
                                    seed=i, max_len=36, integer_grid=255.0)
    return d


def _pair(**over):
    kw = dict(TINY, **over)
    return JHParams(**kw), HParams(**kw)


def _np(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v


def _same(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = _np(a[k]), _np(b[k])
        assert x.dtype == y.dtype, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


def _splits(corpus, **over):
    jh, th = _pair(**over)
    return jloader.load_dataset(jh, corpus), tloader.load_dataset(th, corpus)


def test_load_dataset_default_streams_match_jax(corpus):
    """The augmented train split's ``next_batch`` and
    ``random_batch(int16_scale=)`` streams, interleaved, and every eval
    batch of the valid split: the JAX loader's default (native) stream,
    and every batch went through the port's library."""
    (jtr, jva, _, jscale), (ttr, tva, _, tscale) = _splits(corpus)
    assert jscale == tscale >= 5.0 and ttr.augment
    NB.reset_call_counts()
    for i in range(4):
        _same(jtr.next_batch(), ttr.next_batch(), f"next_batch {i}")
        _same(jtr.random_batch(int16_scale=jscale),
              ttr.random_batch(int16_scale=tscale), f"int16 {i}")
    for i in range(tva.num_eval_batches):
        _same(jva.get_batch(i), tva.get_batch(i), f"eval {i}")
    assert NB.call_counts() == {"assemble_batch": tva.num_eval_batches,
                                "assemble_batch_aug": 4,
                                "assemble_batch_aug_i16": 4,
                                "pad_batch_numpy": 0}


@pytest.mark.parametrize("run_len", [0, 3])
def test_bucketed_streams_match_jax(corpus, run_len):
    """Buckets on: ``next_batch`` and ``next_stack`` (float32 and int16)
    across an epoch boundary, and the eval batches at their bucket pads."""
    over = dict(bucket_edges=(12, 24), bucket_run_len=run_len,
                bucket_shuffle_window=4)
    (jtr, jva, _, scale), (ttr, tva, _, _) = _splits(corpus, **over)
    for i in range(9):
        _same(jtr.next_batch(), ttr.next_batch(), f"next_batch {i}")
    for i in range(6):
        q = scale if i % 2 else None
        _same(jtr.next_stack(3, int16_scale=q), ttr.next_stack(3,
                                                               int16_scale=q),
              f"next_stack {i}")
    for i in range(tva.num_eval_batches):
        _same(jva.get_batch(i), tva.get_batch(i), f"eval {i}")


@pytest.mark.parametrize("dtype,stack,bucketed", [
    ("int16", 1, False), ("int16", 2, True), ("bfloat16", 1, False),
    ("bfloat16", 2, True), ("float32", 3, True)])
def test_feeder_transfer_paths_match_jax(corpus, dtype, stack, bucketed):
    """``prefetch_batches`` over the augmented train split at each
    transfer dtype, stacked and through the bucket-run scheduler: the JAX
    feeder's batches on its native path."""
    over = (dict(bucket_edges=(12, 24), bucket_run_len=3) if bucketed
            else {})
    (jtr, _, _, _), (ttr, _, _, _) = _splits(corpus, **over)
    jf = jprefetch.prefetch_batches(jtr, mesh=None, depth=2, stack=stack,
                                    transfer_dtype=dtype)
    tf = tprefetch.prefetch_batches(ttr, None, depth=2, stack=stack,
                                    transfer_dtype=dtype)
    with jf, tf:
        for i in range(4):
            _same(jf.get(), tf.get(), f"batch {i}")


def test_filter_by_label_matches_jax(corpus):
    (jtr, jva, _, _), (ttr, tva, _, _) = _splits(corpus)
    for label in range(3):
        j, t = jva.filter_by_label(label), tva.filter_by_label(label)
        assert len(j) == len(t) > 0 and not t.augment
        np.testing.assert_array_equal(t.labels, label)
        assert j.num_eval_batches == t.num_eval_batches
        for i in range(t.num_eval_batches):
            _same(j.get_batch(i), t.get_batch(i), f"class {label} {i}")
        _same(jtr.filter_by_label(label).next_batch(),
              ttr.filter_by_label(label).next_batch(), f"train {label}")
    striped = tloader.load_dataset(_pair(batch_size=2)[1], corpus,
                                   host_id=1, num_hosts=2)[1]
    with pytest.raises(RuntimeError, match="host-striped loader"):
        striped.filter_by_label(0)


def test_three_train_steps_on_native_batches_match_jax(corpus):
    """``train()`` fed by its default feed (the augmented train split,
    native, prefetched at depth 2) against three jitted JAX steps on the
    JAX loader's native batches, with the keys ``train()`` derives."""
    jh, th = _pair(max_seq_len=40)
    jm = JSketchRNN(jh)
    jp = jm.init_params(jax.random.key(5))
    tp = params_from_jax(jax.device_get(jp), "cpu")
    jtr = jloader.load_dataset(jh, corpus)[0]
    ttr = tloader.load_dataset(th, corpus)[0]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        NB.reset_call_counts()
        rows = []
        state = train(th, ttr, seed=6, num_steps=3, params=tp,
                      device="cpu", use_mesh=False, history=rows)
    finally:
        torch.set_num_threads(n)
    counts = NB.call_counts()
    assert counts["assemble_batch_aug"] >= 3 and counts["pad_batch_numpy"] == 0
    tx = make_optimizer(jh)
    step = jax.jit(_make_single_step_core(jm, jh, None, tx))
    jstate = JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    root = jax.random.split(jax.random.key(6))[0]
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in jtr.next_batch().items()}
        jstate, met = step(jstate, batch, jax.random.fold_in(root, s))
        assert rows[s]["step"] == s
        for k in met:
            np.testing.assert_allclose(rows[s][k], float(met[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {s} {k}")
    assert state.step == int(jstate.step) == 3
    want = jax.tree_util.tree_leaves(jax.device_get(jstate.params))
    got = jax.tree_util.tree_leaves(params_to_jax(state.params))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)


# -- the build: no fallback, the ABI, concurrent builders ---------------------

def _fresh(monkeypatch, tmp_path):
    """The binding as at a process's start, building into ``tmp_path``."""
    monkeypatch.setattr(NB, "_lib", None)
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path / "native")


def test_a_failed_build_raises_with_the_compilers_text(monkeypatch,
                                                       tmp_path):
    """A compiler that cannot be run, and one that fails, raise with
    their text; the loader raises too rather than falling back. The numpy
    path is taken only when asked for, and then nothing is built."""
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(NB, "CXX", "g++-not-a-compiler")
    with pytest.raises(RuntimeError, match="g\\+\\+-not-a-compiler.*could "
                                           "not run.*No such file"):
        NB.load()
    monkeypatch.setattr(NB, "CXX", "g++")
    monkeypatch.setattr(NB, "CXX_FLAGS",
                        NB.CXX_FLAGS + ["-fno-such-option-anywhere"])
    with pytest.raises(RuntimeError, match="build failed.*"
                                           "-fno-such-option-anywhere") as e:
        NB.load()
    assert "error" in str(e.value)          # g++'s own complaint
    th = HParams(batch_size=2, max_seq_len=16)
    ld = tloader.DataLoader(_seqs(n=4, min_len=3, max_len=16), th,
                            augment=True)
    with pytest.raises(RuntimeError, match="build failed"):
        ld.next_batch()
    monkeypatch.setenv(NB.NO_NATIVE_ENV, "1")
    assert not NB.available()
    NB.reset_call_counts()
    assert ld.next_batch()["strokes"].shape == (2, 17, 5)
    assert NB.call_counts()["pad_batch_numpy"] == 1
    assert not (tmp_path / "native").exists() or not list(
        (tmp_path / "native").glob("*.so"))


def test_a_library_of_another_abi_is_refused(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(NB, "ABI_VERSION", NB.ABI_VERSION + 1)
    with pytest.raises(RuntimeError, match="reports ABI version 4, this "
                                           "binding needs 5"):
        NB.load()


def test_concurrent_builders_end_on_one_library(monkeypatch, tmp_path):
    """Four builders at once (as xdist workers or torchrun ranks would
    be): each writes its own temp file and renames it into place, so all
    end on the one library, which loads, and no temp file is left."""
    _fresh(monkeypatch, tmp_path)
    paths, errors = [], []

    def one():
        try:
            paths.append(NB.build())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [
        paths[0].name]
    assert paths[0].name.startswith(f"batcher-v{NB.ABI_VERSION}-")
    seqs = _seqs(n=4)
    _equal(NB.assemble_batch(seqs, 64), JNB.assemble_batch(seqs, 64))
