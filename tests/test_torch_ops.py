"""The port's ops and model pieces against the JAX package, float32.

Same numpy-made inputs and JAX-made weights (carried across with
``convert.params_from_jax``) through ``layer_norm``, both cells' step,
``get_mixture_params``, the bidirectional encoder with ragged lengths
(then mu/presig), ``decoder_initial_carry`` and ``decode_step``, held at
``atol=1e-5``. Measured gap at these shapes: 8.9e-8 on the encoder's
mu after its 12-step recurrences (float32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.ops import cells as jcells
from sketch_rnn_tpu.ops import linear as jlinear
from sketch_rnn_tpu.ops import mdn as jmdn
from sketch_rnn_tpu.ops.rnn import length_reverse_indices as j_rev
from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import cells, linear, mdn
from sketch_rnn_tpu_torch.ops.rnn import length_reverse_indices

ATOL = 1e-5
TINY = dict(batch_size=4, max_seq_len=32, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3)
RNG = np.random.default_rng(0)


def _close(a, b):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_layer_norm():
    x = RNG.normal(0, 3, (5, 32)).astype(np.float32)
    g = RNG.normal(1, 0.1, (32,)).astype(np.float32)
    b = RNG.normal(0, 0.1, (32,)).astype(np.float32)
    _close(jlinear.layer_norm(x, g, b), linear.layer_norm(_t(x), _t(g),
                                                          _t(b)))


@pytest.mark.parametrize("kind", ["lstm", "layer_norm"])
def test_cell_step(kind):
    jcell = jcells.make_cell(kind, 16)
    cell = cells.make_cell(kind, 16)
    jp = jcell.init_params(jax.random.key(1), 9)
    p = params_from_jax(jax.device_get(jp), device="cpu")
    x = RNG.normal(size=(4, 9)).astype(np.float32)
    c, h = (RNG.normal(size=(4, 16)).astype(np.float32) for _ in range(2))
    (jc, jh), jout = jcell(jp, (c, h), x)
    (tc, th), tout = cell(p, (_t(c), _t(h)), _t(x))
    for a, b in ((jc, tc), (jh, th), (jout, tout)):
        _close(a, b)
    assert cell.carry_size == jcell.carry_size == 32


def test_hyper_cell_refused_by_name():
    with pytest.raises(NotImplementedError, match="later slice"):
        cells.make_cell("hyper", 16)


def test_get_mixture_params():
    raw = RNG.normal(0, 2, (3, 4, 6 * 5 + 3)).astype(np.float32)
    jmp = jmdn.get_mixture_params(jnp.asarray(raw), 5)
    tmp = mdn.get_mixture_params(_t(raw), 5)
    for a, b in zip(jmp, tmp):
        _close(a, b)
    with pytest.raises(ValueError, match="trailing dim"):
        mdn.get_mixture_params(_t(raw), 4)


def _model_pair(dec_model, num_classes=0):
    kw = dict(TINY, conditional=True, dec_model=dec_model,
              num_classes=num_classes)
    jm = JSketchRNN(JHParams(**kw))
    jp = jm.init_params(jax.random.key(2))
    return jm, jp, SketchRNN(HParams(**kw)), params_from_jax(
        jax.device_get(jp), device="cpu")


def test_length_reverse_indices():
    sl = np.asarray([5, 1, 3, 7], np.int32)
    np.testing.assert_array_equal(np.asarray(j_rev(7, jnp.asarray(sl))),
                                  length_reverse_indices(7, _t(sl)).numpy())


def test_encoder_with_ragged_lengths():
    """bidirectional_rnn over padded strokes with ragged seq_len, then
    the mu/presig heads (``SketchRNN.encode``)."""
    jm, jp, m, p = _model_pair("layer_norm")
    x = RNG.normal(0, 1.5, (12, 4, 5)).astype(np.float32)
    sl = np.asarray([12, 3, 7, 1], np.int32)
    jmu, jps = jm.encode(jp, jnp.asarray(x), jnp.asarray(sl))
    tmu, tps = m.encode(p, _t(x), _t(sl))
    _close(jmu, tmu)
    _close(jps, tps)
    eps = RNG.normal(size=jmu.shape).astype(np.float32)
    _close(np.asarray(jmu) + np.exp(np.asarray(jps) / 2.0) * eps,
           m.sample_z(tmu, tps, _t(eps)))


@pytest.mark.parametrize("dec_model,ncls", [("lstm", 0), ("layer_norm", 3)])
def test_decoder_initial_carry_and_step(dec_model, ncls):
    jm, jp, m, p = _model_pair(dec_model, ncls)
    z = RNG.normal(size=(4, 6)).astype(np.float32)
    jc = jm.decoder_initial_carry(jp, jnp.asarray(z), 4)
    tc = m.decoder_initial_carry(p, _t(z), 4)
    for a, b in zip(jc, tc):
        _close(a, b)
    x = RNG.normal(size=(4, 5)).astype(np.float32)
    labels = np.asarray([0, 2, 1, 2]) if ncls else None
    (jc2, jraw) = jm.decode_step(jp, jc, jnp.asarray(x), jnp.asarray(z),
                                 None if labels is None
                                 else jnp.asarray(labels))
    (tc2, traw) = m.decode_step(p, tc, _t(x), _t(z),
                                None if labels is None else _t(labels))
    for a, b in zip(jc2, tc2):
        _close(a, b)
    _close(jraw, traw)
