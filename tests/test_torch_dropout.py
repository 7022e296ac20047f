"""Input and output dropout in the port against the JAX package, on the
CPU.

``SketchRNN.decode``'s two masks (the JAX package's ``decode``: ``krec,
kin, kout = split(kdec, 3)``; the input mask ``bernoulli(kin, keep, [T,
B, D + E])`` over the stream ``[x; z; class embedding]``, which then
feeds the RNN with no per-example gate bias; the output mask
``bernoulli(kout, keep, [T, B, H])`` on ``hs``), at the tiny widths of
``tests/test_torch_train.py`` (JAX-made weights carried across with
``convert.py``; the JAX package's fused kernels in interpret mode, the
port's through their plain versions):

- the keys and masks bit for bit ``jax.random``'s, the dropped values
  bit for bit JAX's ``x * mask / keep`` at float32 and bfloat16, and the
  keys' trip through the staged row (``packed_draws``) exact;
- ``loss(train=True)`` and its gradients against JAX's with input,
  output and both dropouts, for the ``lstm``, ``layer_norm`` and
  ``hyper`` decoders, fused and plain, at float32 (``rtol=1e-5,
  atol=1e-6``) and, in ``tests/test_torch_dropout_bf16.py``, at bfloat16
  compute (metrics ``rtol=1e-4, atol=1e-6``, gradients ``rtol=1e-3,
  atol=1e-4``: the tolerances ``tests/test_torch_train.py`` holds each
  dtype to);
- three train steps with both dropouts against three jitted JAX steps
  (metrics as above, parameters within 2e-5);
- a K=3 call with both dropouts bit for bit three single steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.train.state import TrainState as JTrainState
from sketch_rnn_tpu.train.state import make_optimizer
from sketch_rnn_tpu.train.step import _make_single_step_core
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_to_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN, _dropout
from sketch_rnn_tpu_torch.train import step as tstep
from sketch_rnn_tpu_torch.train.loop import stack_batches
from sketch_rnn_tpu_torch.train.state import make_train_state, states_equal
from sketch_rnn_tpu_torch.utils import prng
from tests._torch_dropout_common import (ATOL, CELLS, DROPOUTS, PARAM_ATOL,
                                         RTOL, TINY, _np, _tree_close,
                                         check_loss_and_gradients)
from tests._torch_dropout_common import models as _models


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keys_masks_and_dropped_values_bitwise(dtype):
    _, th = JHParams(**TINY), HParams(**TINY)
    tm = SketchRNN(th)
    key = prng.fold_in(prng.key(3), 17)
    jkey = jax.random.fold_in(jax.random.key(3), 17)
    d = tm.draws(key, 4, True)
    _, _, jkdec = jax.random.split(jkey, 3)
    _, jkin, jkout = jax.random.split(jkdec, 3)
    np.testing.assert_array_equal(_np(d["kin"]).astype(np.uint32),
                                  np.asarray(jax.random.key_data(jkin)))
    np.testing.assert_array_equal(_np(d["kout"]).astype(np.uint32),
                                  np.asarray(jax.random.key_data(jkout)))
    # the keys cross in the staged row exactly
    row = tm.packed_draws(key[None], 4, True)[0]
    back = tm.unpack_draws(row, 4, True)
    for name in ("kin", "kout"):
        assert torch.equal(back[name], d[name])
    rng = np.random.default_rng(0)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    for (jk, tk, keep, shape) in ((jkin, d["kin"], 0.8, (8, 4, 19)),
                                  (jkout, d["kout"], 0.7, (8, 4, 16))):
        mask = jax.random.bernoulli(jk, keep, shape)
        np.testing.assert_array_equal(
            _np(prng.bernoulli(tk, keep, shape)), np.asarray(mask))
        x = rng.normal(size=shape).astype(np.float32)
        want = jnp.asarray(x).astype(jdt) * mask / keep
        got = _dropout(torch.from_numpy(x).to(getattr(torch, dtype)), tk,
                       keep)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            _np(got.float()), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dropout", list(DROPOUTS))
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_gradients_match_jax(dropout, cell, fused):
    """float32; bfloat16 compute in ``tests/test_torch_dropout_bf16.py``."""
    check_loss_and_gradients(dropout, cell, fused, "float32")


def test_three_train_steps_with_dropout_match_jax():
    jh, th, jm, tm, jp, tp = _models()
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=1)
    batches = [loader.random_batch() for _ in range(3)]
    tx = make_optimizer(jh)
    jstep = jax.jit(_make_single_step_core(jm, jh, None, tx))
    jstate = JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    step = tstep.make_train_step(tm, th, device="cpu")
    state = make_train_state(tp)
    for s, b in enumerate(batches):
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v) for n, v in
                                      b.items()},
                             jax.random.fold_in(jax.random.key(7), s))
        state, met = step(state, b, prng.fold_in(prng.key(7), s))
        for k in jmet:
            np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    _tree_close(jax.device_get(jstate.params),
                jax.tree_util.tree_leaves(params_to_jax(state.params)),
                atol=PARAM_ATOL, rtol=0.0, what="params ")


@pytest.mark.parametrize("fused", [True, False])
def test_k3_call_with_dropout_is_its_single_steps_bitwise(fused):
    _, th, _, tm, _, tp = _models(fused_rnn=fused, steps_per_call=3)
    loader = jloader.synthetic_loader(JHParams(**TINY), num=24, seed=2)[0]
    batches = [loader.random_batch() for _ in range(3)]
    multi = tstep.make_multi_train_step(tm, th, device="cpu")
    got, met = multi(make_train_state(tp), stack_batches(batches),
                     prng.key(9))
    single = tstep.make_train_step(tm, th, device="cpu")
    st, per = make_train_state(tp), []
    for i, b in enumerate(batches):
        st, m = single(st, b, prng.fold_in(prng.key(9), i))
        per.append(m)
    want = tstep.replay_window_metrics(per)
    assert states_equal(got, st)
    assert all(torch.equal(met[k], want[k]) for k in want)
