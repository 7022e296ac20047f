"""Checkpoint format 1 in the port against the JAX package, on the CPU.

One tiny flagship-shaped JAX ``TrainState`` after one jitted step (so the
counts are non-zero), carried into the port with
``convert.train_state_from_jax``:

- the hand-written msgpack (``utils/msgpack.py``) packs every width
  boundary byte for byte as msgpack-python does and reads its bytes
  back; the port's checkpoint bytes equal ``flax.serialization.to_bytes``
  of the same state, and the two packages' sidecars parse equal;
- a JAX ``save_checkpoint`` restores in the port bitwise against
  ``train_state_from_jax``, and a port save restores in the JAX
  ``restore_checkpoint`` (and passes its ``validate_checkpoint``)
  bitwise, from the synchronous and the background writer alike;
- the rejections of ``tests/test_train.py`` (a future version, a missing
  version read as 1, truncation and garbage, pruning, orphans) and the
  rest of ``validate_checkpoint``'s (torn pairs, a bad sidecar, a shape
  mismatch naming the field, non-finite parameters) give the same
  one-line text in both packages on the same files; where the msgpack
  does not decode, the text is the same up to the decoder's own error.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import msgpack as msgpack_python
import numpy as np
import pytest
import torch
from flax import serialization

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.train import checkpoint as jc
from sketch_rnn_tpu.train.state import TrainState as JTrainState
from sketch_rnn_tpu.train.state import make_optimizer
from sketch_rnn_tpu.train.state import make_train_state as j_make_state
from sketch_rnn_tpu.train.step import _make_single_step_core
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import train_state_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.train import checkpoint as tc
from sketch_rnn_tpu_torch.train.async_ckpt import AsyncCheckpointer
from sketch_rnn_tpu_torch.train.state import make_train_state, states_equal
from sketch_rnn_tpu_torch.utils import msgpack

TINY = dict(batch_size=4, max_seq_len=8, enc_rnn_size=6, dec_rnn_size=8,
            z_size=3, num_mixture=2, dec_model="layer_norm", num_classes=3,
            class_embed_size=2, fused_rnn=True)


@pytest.fixture(scope="module")
def stepped():
    """``(jh, th, jax state after one step, its port counterpart)``."""
    jh, th = JHParams(**TINY), HParams(**TINY)
    jm = JSketchRNN(jh)
    p = jm.init_params(jax.random.key(0))
    tx = make_optimizer(jh)
    st = JTrainState(p, tx.init(p), jnp.zeros((), jnp.int32))
    loader, _ = jloader.synthetic_loader(jh, num=16, seed=0)
    st, _ = jax.jit(_make_single_step_core(jm, jh, None, tx))(
        st, loader.random_batch(), jax.random.key(1))
    host = jax.device_get(st)
    return jh, th, host, train_state_from_jax(host, device="cpu")


def _template(th):
    return make_train_state(SketchRNN(th).init_params(
        torch.Generator().manual_seed(3), device="cpu"))


_EDGES = [None, True, False, 0, 127, 128, 255, 256, 2 ** 16 - 1, 2 ** 16,
          2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
          -2 ** 15, -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1, -2 ** 63,
          "", "a" * 31, "a" * 32, "é" * 200, "a" * 2 ** 16, b"",
          b"b" * 255, b"b" * 256, b"b" * 2 ** 16, [], list(range(15)),
          list(range(16)), list(range(2 ** 16)), {},
          {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
          {str(i): [i] for i in range(2 ** 16)}]


@pytest.mark.parametrize("i", range(len(_EDGES)))
def test_msgpack_matches_msgpack_python(i):
    obj = _EDGES[i]
    ours = msgpack.packb(obj)
    assert ours == msgpack_python.packb(obj, use_bin_type=True)
    assert msgpack.unpackb(ours) == msgpack_python.unpackb(
        ours, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 8, 14, 16, 17, 255, 256,
                               2 ** 16])
def test_msgpack_ext_widths(n):
    data = bytes(range(256)) * (n // 256) + bytes(n % 256)
    ours = msgpack.packb(msgpack.ExtType(1, data))
    assert ours == msgpack_python.packb(msgpack_python.ExtType(1, data))
    assert msgpack.unpackb(ours) == msgpack.ExtType(1, data)


def test_msgpack_rejects_truncated_and_trailing_bytes():
    raw = msgpack.packb({"a": [1, 2, b"xyz"]})
    for bad in (raw[:-1], raw + b"\x00", b"\xc1"):
        with pytest.raises(msgpack.UnpackError):
            msgpack.unpackb(bad)


def test_numpy_scalar_ext_reads_back():
    raw = serialization.msgpack_serialize({"s": np.float32(2.5)})
    got = msgpack.unpack_state(raw)["s"]
    assert isinstance(got, np.float32) and got == np.float32(2.5)


def test_bytes_equal_flax_and_sidecars_parse_equal(stepped, tmp_path):
    jh, th, host, ts = stepped
    assert ts.step == 1 and ts.opt_state.adam.count == 1
    assert tc.host_bytes(ts) == serialization.to_bytes(host)
    jpath = jc.save_checkpoint(str(tmp_path / "j"), host, 2.5, jh)
    tpath = tc.save_checkpoint(str(tmp_path / "t"), ts, 2.5, th)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    side = [json.load(open(p[:-len(".msgpack")] + ".json"))
            for p in (jpath, tpath)]
    assert side[0] == side[1]
    assert side[1]["format_version"] == tc.FORMAT_VERSION == 1


def test_jax_checkpoint_restores_in_port_bitwise(stepped, tmp_path):
    jh, th, host, ts = stepped
    d = str(tmp_path)
    jc.save_checkpoint(d, host, 3.5, jh)
    assert tc.latest_checkpoint(d) == 1
    got, scale, meta = tc.restore_checkpoint(d, _template(th), device="cpu")
    assert scale == 3.5 and meta["step"] == 1
    assert HParams.from_json(json.dumps(meta["hps"])) == th
    assert states_equal(got, ts)


@pytest.mark.parametrize("background", [False, True])
def test_port_checkpoint_restores_in_jax_bitwise(stepped, tmp_path,
                                                 background):
    jh, th, host, ts = stepped
    d = str(tmp_path)
    if background:
        ck = AsyncCheckpointer(d)
        ck.save(ts, 1.25, th)
        ck.wait()
        assert ck.failure is None
        assert sorted(os.listdir(d)) == ["ckpt_00000001.json",
                                         "ckpt_00000001.msgpack"]
    else:
        tc.save_checkpoint(d, ts, 1.25, th)
    template = j_make_state(JSketchRNN(jh), jh, jax.random.key(9))
    got, scale, _ = jc.restore_checkpoint(d, template)
    jc.validate_checkpoint(os.path.join(d, "ckpt_00000001.msgpack"),
                           template)
    assert scale == 1.25
    fa = jax.tree_util.tree_flatten_with_path(host)[0]
    fb = jax.tree_util.tree_leaves(got)
    assert len(fa) == len(fb)
    for (path, a), b in zip(fa, fb):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def _damage(kind, d, jh, host):
    """Write a JAX checkpoint into ``d`` and damage it as ``kind`` says;
    returns the hparams of the template to restore against."""
    state = host._replace(step=np.asarray(4, np.int32))
    if kind == "nonfinite":
        params = dict(state.params, out_b=np.full_like(
            state.params["out_b"], np.nan))
        state = state._replace(params=params)
    path = jc.save_checkpoint(d, state, 2.0, jh)
    meta_path = path[:-len(".msgpack")] + ".json"
    meta = json.load(open(meta_path))
    raw = open(path, "rb").read()
    if kind == "future":
        meta["format_version"] = jc.FORMAT_VERSION + 1
    elif kind == "noscale":
        del meta["scale_factor"]
    if kind in ("future", "noscale"):
        json.dump(meta, open(meta_path, "w"))
    elif kind == "badjson":
        open(meta_path, "w").write("{\"step\": 4,")
    elif kind == "truncated":
        open(path, "wb").write(raw[:len(raw) // 3])
    elif kind == "garbage":
        open(path, "wb").write(b"\x00garbage\xff" * 100)
    elif kind == "nosidecar":
        os.remove(meta_path)
    elif kind == "shape":
        return dict(TINY, dec_rnn_size=TINY["dec_rnn_size"] + 4)
    return TINY


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("kind", ["future", "noscale", "badjson",
                                  "nosidecar", "shape", "nonfinite",
                                  "truncated", "garbage"])
def test_rejections_have_the_same_text(stepped, tmp_path, kind):
    jh, _, host, _ = stepped
    d = str(tmp_path)
    kw = _damage(kind, d, jh, host)
    jh2, th2 = JHParams(**kw), HParams(**kw)
    path = os.path.join(d, "ckpt_00000004.msgpack")
    jtmpl = j_make_state(JSketchRNN(jh2), jh2, jax.random.key(0))
    want = _message(lambda: jc.validate_checkpoint(path, jtmpl))
    got = _message(lambda: tc.validate_checkpoint(path, _template(th2),
                                                  device="cpu"))
    assert want[0] == got[0] == "CheckpointValidationError"
    if kind in ("truncated", "garbage"):
        # the text names each decoder's own error after "bytes: "
        cut = want[1].index("bytes: ") + len("bytes: ")
        assert got[1][:cut] == want[1][:cut]
        assert "msgpack corrupt or truncated" in got[1]
    else:
        assert got == want
    if kind == "shape":
        assert "field params/dec/wx has shape" in got[1]


def test_missing_msgpack_and_missing_version(stepped, tmp_path):
    jh, th, host, _ = stepped
    d = str(tmp_path)
    _damage("ok", d, jh, host)
    meta_path = os.path.join(d, "ckpt_00000004.json")
    meta = json.load(open(meta_path))
    del meta["format_version"]                 # read as version 1
    json.dump(meta, open(meta_path, "w"))
    got, scale, _ = tc.restore_checkpoint(d, _template(th), device="cpu")
    assert got.step == 4 and scale == 2.0
    os.remove(os.path.join(d, "ckpt_00000004.msgpack"))
    path = os.path.join(d, "ckpt_00000004.json")
    jtmpl = j_make_state(JSketchRNN(jh), jh, jax.random.key(0))
    assert _message(lambda: jc.validate_checkpoint(path, jtmpl)) == \
        _message(lambda: tc.validate_checkpoint(path, _template(th),
                                                device="cpu"))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tc.restore_checkpoint(d, _template(th), device="cpu")


def _prune_and_orphans(pkg, d, state_at, hps):
    for s in (1, 2, 3, 4, 5):
        pkg.save_checkpoint(d, state_at(s), 1.0, hps, keep=2)
    open(os.path.join(d, "ckpt_00000009.msgpack"), "wb").write(b"junk")
    open(os.path.join(d, "ckpt_00000011.json"), "w").write("{}")
    latest = pkg.latest_checkpoint(d)
    open(os.path.join(d, "ckpt_00000007.msgpack.tmp"), "wb").write(b"junk")
    pkg.save_checkpoint(d, state_at(6), 1.0, hps, keep=2)
    return latest, sorted(os.listdir(d))


def test_prune_and_orphans_match(stepped, tmp_path):
    jh, th, host, ts = stepped
    j = _prune_and_orphans(
        jc, str(tmp_path / "j"),
        lambda s: host._replace(step=np.asarray(s, np.int32)), jh)
    t = _prune_and_orphans(tc, str(tmp_path / "t"),
                           lambda s: ts._replace(step=s), th)
    assert j == t == (5, ["ckpt_00000005.json", "ckpt_00000005.msgpack",
                          "ckpt_00000006.json", "ckpt_00000006.msgpack"])
    for name in t[1]:
        a = open(tmp_path / "j" / name, "rb").read()
        b = open(tmp_path / "t" / name, "rb").read()
        assert a == b, name


def test_commit_retries_a_transient_failure(stepped, tmp_path,
                                            monkeypatch):
    _, th, _, ts = stepped
    real, calls = os.replace, []

    def flaky(src, dst):
        calls.append(dst)
        if len(calls) == 1:
            raise OSError("transient")
        return real(src, dst)

    monkeypatch.setattr(tc.os, "replace", flaky)
    path = tc.save_checkpoint(str(tmp_path), ts, 1.0, th, retries=2,
                              retry_backoff_s=0.0)
    assert os.path.exists(path) and len(calls) == 3
    calls.clear()
    monkeypatch.setattr(tc.os, "replace",
                        lambda s, d: (_ for _ in ()).throw(OSError("dead")))
    shutil.rmtree(tmp_path / "x", ignore_errors=True)
    with pytest.raises(OSError, match="dead"):
        tc.save_checkpoint(str(tmp_path / "x"), ts, 1.0, th, retries=1,
                           retry_backoff_s=0.0)


def test_background_failure_raises_on_wait(stepped, tmp_path):
    _, th, _, ts = stepped
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker / "ckpt"))
    ck.save(ts, 1.0, th.replace(ckpt_retries=0))
    ck.join()
    assert ck.failure is not None
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ck.wait()
    assert ck.failure is None
