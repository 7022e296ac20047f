"""The port's probe kernels' plain versions against the JAX probes.

``sketch_rnn_tpu_torch/scripts/probe_dual_encoder.py::dual_seq_fwd`` and
``probe_bf16_gates.py::seq_fwd`` run their plain PyTorch versions on CPU
tensors; the JAX probes' Pallas kernels (``scripts/probe_dual_encoder.py
::dual_seq_fwd``, ``scripts/probe_bf16_gates.py::seq_fwd``) run in
interpret mode. Same numpy-made inputs at T=4, B=8, H=16, D=5, bfloat16
weights ``N(0, 0.1)`` as the probes draw them, bfloat16 outputs, held at
``rtol=1e-2, atol=1e-3`` (a bfloat16
ulp is 2**-8 relative; the bf16-gates arm rounds at every gate op in
torch, while XLA may keep a fused chain of bfloat16 ops in float32, so
an intermediate can differ by an ulp). Also: the plain dual
forward is bit for bit two plain ``fused_lstm_seq`` forwards, and the
float32-gates arm of ``seq_fwd`` is the plain ``fused_lstm_seq`` forward,
and an unknown gate form is refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.probe_bf16_gates import seq_fwd as j_seq_fwd
from scripts.probe_dual_encoder import dual_seq_fwd as j_dual_seq_fwd
from sketch_rnn_tpu.ops.pallas_fused import _batch_tile_seq
from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as PB
from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as PD

T, B, H, D = 4, 8, 16, 5
TOL = dict(rtol=1e-2, atol=1e-3)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, B, D)).astype(np.float32)
    w = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)
    return (xs, np.flip(xs, 0).copy(), w(D, 4 * H), w(4 * H), w(H, 4 * H),
            w(D, 4 * H), w(4 * H), w(H, 4 * H))


def _jax(a, i):
    """Weights (``wx``/``wh``: positions 2, 4, 5, 7) in bfloat16."""
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if i in (2, 4, 5, 7) else x


def _torch(a, i):
    x = torch.from_numpy(a)
    return x.to(torch.bfloat16) if i in (2, 4, 5, 7) else x


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      np.asarray(a, np.float32), np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_dual_seq_fwd_matches_jax(seed):
    args = _inputs(seed)
    want = j_dual_seq_fwd(*(_jax(a, i) for i, a in enumerate(args)))
    got = PD.dual_seq_fwd(*(_torch(a, i) for i, a in enumerate(args)))
    for a, b in zip(want, got):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(b), _f32(a), **TOL)


def test_dual_plain_is_two_plain_sequence_forwards():
    args = [_torch(a, i) for i, a in enumerate(_inputs(2))]
    got = PD.dual_seq_fwd_plain(*args)
    z = torch.zeros((B, H))
    pair = (*CF.lstm_seq_fwd(args[0], *args[2:5], z, z,
                             residual_dtype=torch.bfloat16),
            *CF.lstm_seq_fwd(args[1], *args[5:], z, z,
                             residual_dtype=torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(got, pair))


@pytest.mark.parametrize("bf16_gates", [False, True])
def test_seq_fwd_matches_jax(bf16_gates):
    """Each gate form against the JAX probe's arm."""
    xs, _, wx, b, wh = _inputs(3)[:5]
    want = j_seq_fwd(jnp.asarray(xs), _jax(wx, 2), jnp.asarray(b),
                     _jax(wh, 4), bf16_gates, _batch_tile_seq(B, H))
    hs, cs = PB.seq_fwd(torch.from_numpy(xs), _torch(wx, 2),
                        torch.from_numpy(b), _torch(wh, 4), bf16_gates)
    assert hs.dtype == cs.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(hs), _f32(want), **TOL)
    if bf16_gates is False:
        z = torch.zeros((B, H))
        same = CF.lstm_seq_fwd(torch.from_numpy(xs), _torch(wx, 2),
                               torch.from_numpy(b), _torch(wh, 4), z, z,
                               residual_dtype=torch.bfloat16)
        assert torch.equal(hs, same[0]) and torch.equal(cs, same[1])


def test_seq_fwd_refuses_an_unknown_gate_form():
    xs, _, wx, b, wh = (_torch(a, i) for i, a in enumerate(_inputs(4)[:5]))
    with pytest.raises(ValueError, match="bf16_gates"):
        PB.seq_fwd(xs, wx, b, wh, "fp8")
