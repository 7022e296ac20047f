"""The cuDNN-layout LSTM of the port against the JAX package, on the CPU.

``ops/cuda_lstm.py::lstm_seq`` (the counterpart of
``sketch_rnn_tpu/ops/pallas_lstm.py::lstm_seq``) runs its plain PyTorch
versions on CPU tensors; the JAX function runs its Pallas kernels in
interpret mode. Same inputs, made with numpy from a seed, at the shapes
of ``tests/test_pallas_lstm.py`` (T=6, B=8, H=128, D=16), weights from
the JAX ``LSTMCell`` carried across with ``convert.py``.

- the forward (``hs``, ``cT``, ``hT``), masks off and on, zero and
  nonzero carries, at ``rtol=2e-5, atol=2e-6`` (the two sum the
  128-term ``h @ wh`` products in other orders);
- all four gradients (``xp``, ``wh``, ``c0``, ``h0``) of a weighted loss
  through the custom VJPs, at ``rtol=2e-5, atol=2e-5``: tighter than
  ``tests/test_pallas_lstm.py``'s ``5e-4 / 5e-5`` (that test holds the
  kernel against the scan's autodiff; here both sides run the same
  reverse-time recurrence from the same reserve, measured gap ~1e-6 on
  gradients up to ~3);
- ``lstm_seq`` against the port's own ``run_rnn(hoist=True)`` (the plain
  scan it fuses) and its autodiff;
- ``make_dropout_masks`` and ``prng.bernoulli`` bitwise JAX's;
- one more case of the forward and gradient tests at a ragged H=40 and
  B=1 (the card's loops cut H into uneven slices, B into tiles);
- the A/B helpers (``lstm_seq_fwd_entries``, ``lstm_seq_bwd_entries``)
  refuse CPU tensors: the path to the row-block design has no plain
  fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.ops.cells import LSTMCell as JLSTMCell
from sketch_rnn_tpu.ops.pallas_lstm import lstm_seq as jlstm_seq
from sketch_rnn_tpu.ops.rnn import make_dropout_masks as jmasks
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.ops import cuda_lstm as cl
from sketch_rnn_tpu_torch.ops.cells import LSTMCell
from sketch_rnn_tpu_torch.ops.rnn import make_dropout_masks, run_rnn
from sketch_rnn_tpu_torch.utils import prng

T, B, H, D = 6, 8, 128, 16
FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed=0, carry=False, masks=False, h=H, b=B):
    """numpy operands: the JAX cell's weights, ``xp`` from its
    ``precompute_inputs``, carries, masks (keep 0.8), cotangents."""
    cell = JLSTMCell(h)
    params = jax.device_get(cell.init_params(jax.random.key(seed), D))
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, b, D)).astype(np.float32)
    xp = np.asarray(cell.precompute_inputs(params, jnp.asarray(xs)))
    c0, h0 = ((rng.normal(size=(b, h)) * 0.5).astype(np.float32)
              if carry else np.zeros((b, h), np.float32) for _ in range(2))
    m = np.asarray(jmasks(jax.random.key(9), 0.8, T, b, h)) if masks \
        else None
    cot = [(rng.normal(size=s) * 0.1).astype(np.float32)
           for s in ((T, b, h), (b, h), (b, h))]
    return params, xs, xp, c0, h0, m, cot


def _cases(pairs):
    """``(carry, masks)`` pairs at the module's H and B, ids as before,
    then the ragged case: H=40, B=1, carries and masks."""
    return ([pytest.param(c, m, H, B, id=f"{c}-{m}") for c, m in pairs]
            + [pytest.param(True, True, 40, 1, id="H40-B1")])


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("carry,masks,h,b", _cases(
    [(False, False), (False, True), (True, False), (True, True)]))
def test_forward_matches_jax(carry, masks, h, b):
    params, _, xp, c0, h0, m, _ = _inputs(carry=carry, masks=masks, h=h,
                                          b=b)
    jhs, (jc, jh) = jlstm_seq(*map(jnp.asarray, (xp, params["wh"], c0, h0)),
                              1.0, None if m is None else jnp.asarray(m))
    hs, (cT, hT) = cl.lstm_seq(*map(_t, (xp, params["wh"], c0, h0)), 1.0,
                               _t(m))
    for a, b in ((jhs, hs), (jc, cT), (jh, hT)):
        np.testing.assert_allclose(_np(b), np.asarray(a), **FWD)


@pytest.mark.parametrize("carry,masks,h,b", _cases(
    [(False, True), (True, False), (True, True)]))
def test_gradients_match_jax(carry, masks, h, b):
    params, _, xp, c0, h0, m, (w_hs, w_c, w_h) = _inputs(
        carry=carry, masks=masks, h=h, b=b)
    jm = None if m is None else jnp.asarray(m)

    def jloss(*a):
        hs, (cT, hT) = jlstm_seq(*a, 1.0, jm)
        return jnp.sum(hs * w_hs) + jnp.sum(cT * w_c) + jnp.sum(hT * w_h)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (xp, params["wh"], c0, h0)))
    leaves = [_t(a).requires_grad_(True) for a in (xp, params["wh"], c0,
                                                    h0)]
    hs, (cT, hT) = cl.lstm_seq(*leaves, 1.0, _t(m))
    loss = ((hs * _t(w_hs)).sum() + (cT * _t(w_c)).sum()
            + (hT * _t(w_h)).sum())
    tg = torch.autograd.grad(loss, leaves)
    for n, a, b in zip(("dxp", "dwh", "dc0", "dh0"), jg, tg):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=n, **GRAD)


def test_ab_helpers_refuse_cpu_tensors():
    """The A/B helpers drive the C entries (the loops and the row-block
    design) and have no plain version: CPU tensors raise, and no launch
    is counted."""
    params, _, xp, c0, h0, m, (dhs, dcT, dhT) = _inputs(carry=True,
                                                        masks=True)
    xp, wh, c0, h0, m = map(_t, (xp, params["wh"], c0, h0, m))
    hs, _, _, gates, cs = cl.lstm_seq_fwd(xp, wh, c0, h0, 1.0, m)
    before = cl.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cl.lstm_seq_fwd_entries(xp, wh, c0, h0, 1.0, m)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cl.lstm_seq_bwd_entries(wh, gates, cs, hs, h0, m,
                                *map(_t, (dhs, dcT, dhT)))
    assert cl.launch_counts() == before


def test_masks_get_no_gradient():
    params, _, xp, c0, h0, m, _ = _inputs(masks=True)
    mt = _t(m).requires_grad_(True)
    wh = _t(params["wh"]).requires_grad_(True)
    hs, _ = cl.lstm_seq(_t(xp), wh, _t(c0), _t(h0), 1.0, mt)
    hs.sum().backward()
    assert mt.grad is None and wh.grad is not None


@pytest.mark.parametrize("masks", [False, True])
def test_matches_the_plain_hoisted_scan(masks):
    """``lstm_seq`` over ``precompute_inputs`` is ``run_rnn(hoist=True)``
    of the port's own LSTM cell, forward and gradients (which reach the
    cell's parameters through ``xp`` in one case and step by step in the
    other)."""
    params, xs, _, c0, h0, m, (w_hs, w_c, w_h) = _inputs(carry=True,
                                                         masks=masks)
    cell = LSTMCell(H)
    out = {}
    for fused in (True, False):
        p = {k: v.requires_grad_(True) for k, v in
             params_from_jax(params, device="cpu").items()}
        if fused:
            hs, (cT, hT) = cl.lstm_seq(cell.precompute_inputs(p, _t(xs)),
                                       p["wh"], _t(c0), _t(h0), 1.0, _t(m))
        else:
            (cT, hT), hs = run_rnn(cell, p, _t(xs), (_t(c0), _t(h0)),
                                   rdrop_masks=_t(m), hoist=True)
        loss = ((hs * _t(w_hs)).sum() + (cT * _t(w_c)).sum()
                + (hT * _t(w_h)).sum())
        out[fused] = [hs, cT, hT, *torch.autograd.grad(
            loss, [p["wx"], p["b"], p["wh"]])]
    for a, b in zip(out[True], out[False]):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD)


@pytest.mark.parametrize("keep,shape", [(0.9, (6, 8, 128)), (0.5, (3, 5)),
                                        (0.8, (250, 4, 7))])
def test_bernoulli_and_dropout_masks_bitwise(keep, shape):
    for seed in (0, 9, 12345):
        jb = np.asarray(jax.random.bernoulli(jax.random.key(seed), keep,
                                             shape))
        tb = prng.bernoulli(prng.key(seed), keep, shape)
        assert tb.dtype == torch.bool
        np.testing.assert_array_equal(tb.numpy(), jb)
    if len(shape) == 3:
        jm = np.asarray(jmasks(jax.random.key(4), keep, *shape))
        tm = make_dropout_masks(prng.key(4), keep, *shape)
        assert tm.dtype == torch.float32
        np.testing.assert_array_equal(tm.numpy().view(np.uint32),
                                      jm.view(np.uint32))
