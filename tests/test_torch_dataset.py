"""The port's ``.npz`` datasets against the JAX package's, on the CPU.

Three single-class ``.npz`` files written by the JAX package's
``write_synthetic_npz`` (``integer_grid=255``, QuickDraw's integer
deltas) in a temporary directory, read by both packages'
``load_dataset``:

- the scale factor, the length of every split, the train split's
  augmented ``next_batch`` stream (both packages' native batchers
  switched off, so both take the numpy path), ``num_eval_batches`` and
  every ``get_batch`` of the valid and test splits with its ``weights``:
  all bitwise;
- ``fast_forward`` aligns a fresh loader's stream with one that drew the
  batches, as ``tests/test_train.py::test_loader_fast_forward_aligns_stream``
  pins for the JAX package;
- a missing file, an unreadable ``.npz``, a missing split array, an
  empty split and a corrupt record fail with the same one-line text in
  both packages, and ``skip_bad_records`` skips the record in both;
- the port's writer gives the same arrays as the JAX one.
"""

import os

import numpy as np
import pytest

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.data import loader as tloader

FILES = ("cat.npz", "dog.npz", "owl.npz")
TINY = dict(batch_size=5, max_seq_len=40, data_set=FILES, num_classes=3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("npz")
    for i, name in enumerate(FILES):
        jloader.write_synthetic_npz(str(d / name), num_train=17,
                                    num_valid=7, num_test=6, class_id=i,
                                    seed=10 * i, max_len=36,
                                    integer_grid=255.0)
    return str(d)


def _pair(**over):
    kw = dict(TINY, **over)
    return JHParams(**kw), HParams(**kw)


def _same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_load_dataset_bitwise(corpus, monkeypatch):
    monkeypatch.setattr(jloader.NB, "assemble_batch_aug",
                        lambda *a, **k: None)
    monkeypatch.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")    # the port's numpy path
    jh, th = _pair()
    jsplits = jloader.load_dataset(jh, corpus)
    tsplits = tloader.load_dataset(th, corpus)
    assert jsplits[3] == tsplits[3]
    for name, j, t in zip(("train", "valid", "test"), jsplits, tsplits):
        assert len(j) == len(t) > 0, name
        assert j.augment == t.augment == (name == "train")
        np.testing.assert_array_equal(j.labels, t.labels)
        assert j.num_eval_batches == t.num_eval_batches, name
    for i in range(4):
        _same(jsplits[0].next_batch(), tsplits[0].next_batch(), f"train {i}")
    for j, t in zip(jsplits[1:3], tsplits[1:3]):
        # the last batch wraps: its tail rows repeat the start at weight 0
        assert len(j) % th.batch_size
        for i in range(t.num_eval_batches):
            assert j.eval_pad_len(i) == t.eval_pad_len(i) == th.max_seq_len
            _same(j.get_batch(i), t.get_batch(i), f"eval batch {i}")
        last = t.get_batch(t.num_eval_batches - 1)["weights"]
        assert last.sum() == len(t) % th.batch_size
    with pytest.raises(IndexError):
        tsplits[1].get_batch(tsplits[1].num_eval_batches)


def _with_bad_record(d):
    rng = np.random.default_rng(0)
    good = [np.rint(rng.normal(0, 9, (n, 3))).astype(np.float32) % 2
            * np.float32([7, -3, 1]) for n in (4, 5)]
    bad = np.array(good[:1] + [np.ones((4, 2), np.float32)] + good[1:],
                   dtype=object)
    np.savez(os.path.join(d, "badrec.npz"), train=bad,
             valid=np.array(good, dtype=object),
             test=np.array(good, dtype=object))


def test_given_scale_factor_and_skip_bad_records(corpus, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(jloader.NB, "assemble_batch_aug",
                        lambda *a, **k: None)
    monkeypatch.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")    # the port's numpy path
    jh, th = _pair()
    j = jloader.load_dataset(jh, corpus, scale_factor=3.25)
    t = tloader.load_dataset(th, corpus, scale_factor=3.25)
    assert j[3] == t[3] == 3.25
    _same(j[1].get_batch(0), t[1].get_batch(0), "valid at a given scale")
    _with_bad_record(str(tmp_path))
    jh, th = _pair(data_set=("badrec.npz",), num_classes=0)
    j = jloader.load_dataset(jh, str(tmp_path), skip_bad_records=True)
    t = tloader.load_dataset(th, str(tmp_path), skip_bad_records=True)
    assert len(j[0]) == len(t[0]) == 2 and j[3] == t[3]
    _same(j[0].get_batch(0), t[0].get_batch(0), "train without the bad")


def test_fast_forward_aligns_stream(corpus):
    _, th = _pair()
    a = tloader.load_dataset(th, corpus)[0]
    b = tloader.load_dataset(th, corpus)[0]
    for _ in range(3):
        a.next_batch()
    b.fast_forward(3)
    for _ in range(2):
        _same(a.next_batch(), b.next_batch(), "after fast_forward")
    with pytest.raises(ValueError, match="n_batches"):
        b.fast_forward(-1)


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def test_load_errors_have_the_same_text(tmp_path):
    d = str(tmp_path)
    np.savez(os.path.join(d, "novalid.npz"),
             train=np.array([np.zeros((3, 3), np.float32)], dtype=object),
             test=np.array([np.zeros((3, 3), np.float32)], dtype=object))
    with open(os.path.join(d, "torn.npz"), "wb") as f:
        f.write(b"PK\x03\x04 not a zip archive")
    jloader.write_synthetic_npz(os.path.join(d, "long.npz"), num_train=4,
                                num_valid=2, num_test=2, min_len=30,
                                max_len=36)
    _with_bad_record(d)
    cases = {"missing.npz": {}, "torn.npz": {}, "novalid.npz": {},
             "long.npz": {"max_seq_len": 20}, "badrec.npz": {}}
    for name, over in cases.items():
        jh, th = _pair(data_set=(name,), num_classes=0, **over)
        want = _message(lambda: jloader.load_dataset(jh, d))
        got = _message(lambda: tloader.load_dataset(th, d))
        assert got == want, name


def test_multi_host_loading_is_refused_by_name(corpus):
    """The coordinated global plan (the elastic runtime's) is refused by
    name: asked for, or picked as the JAX package picks it (buckets on a
    striped corpus)."""
    _, th = _pair()
    _, tb = _pair(bucket_edges=(20,))
    for h, kw in ((th, dict(coordinated=True)), (th, dict(emit_global=True)),
                  (tb, dict(num_hosts=2, host_id=1))):
        with pytest.raises(NotImplementedError, match="later slice") as e:
            tloader.load_dataset(h, corpus, **kw)
        assert "ROADMAP queue 1 item 7" in str(e.value)


@pytest.mark.parametrize("host_id,num_hosts", [(0, 2), (1, 2), (2, 3),
                                               (1, 1)])
def test_striped_loading_matches_jax(corpus, host_id, num_hosts,
                                     monkeypatch):
    """A stripe of every split, bitwise the JAX package's: the rows, the
    stripe's seed (its augmented stream), the scale factor of the whole
    train split, the eval batch count from the corpus before striping
    and every eval batch."""
    monkeypatch.setattr(jloader.NB, "assemble_batch_aug",
                        lambda *a, **k: None)
    monkeypatch.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")    # the port's numpy path
    jh, th = _pair(batch_size=2)
    kw = dict(host_id=host_id, num_hosts=num_hosts)
    j, t = jloader.load_dataset(jh, corpus, **kw), \
        tloader.load_dataset(th, corpus, **kw)
    assert j[3] == t[3]
    for a, b in zip(j[:3], t[:3]):
        assert len(a) == len(b)
        assert a.num_eval_batches == b.num_eval_batches
        for i in range(a.num_eval_batches):
            _same_batch(a.get_batch(i), b.get_batch(i))
    for _ in range(3):
        _same_batch(j[0].next_batch(), t[0].next_batch())
    if num_hosts > 1:
        # each rank would plan its own bucket geometries
        with pytest.raises(RuntimeError, match="host-striped"):
            tloader.load_dataset(th.replace(bucket_edges=(20,)), corpus,
                                 coordinated=False, **kw)


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_writer_matches_jax(tmp_path):
    kw = dict(num_train=9, num_valid=4, num_test=3, class_id=4, seed=7,
              max_len=30, integer_grid=255.0)
    jloader.write_synthetic_npz(str(tmp_path / "j.npz"), **kw)
    tloader.write_synthetic_npz(str(tmp_path / "t.npz"), **kw)
    with np.load(tmp_path / "j.npz", allow_pickle=True) as a, \
            np.load(tmp_path / "t.npz", allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for split in a.files:
            assert len(a[split]) == len(b[split])
            for x, y in zip(a[split], b[split]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
