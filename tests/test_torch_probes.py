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


# -- the probe loop's plan (csrc/probe_seq.cu, scripts/_probe.py) ----------

def _owners(plan, b, h, dirs):
    """How many blocks own each (direction, row, unit): the windows, tiles
    and slices of ``plan`` as ``probe_loop_kernel`` and
    ``launch_probe_loop`` cut them."""
    from sketch_rnn_tpu_torch.scripts import _probe as P

    count = np.zeros((dirs, b, h), np.int32)
    for w in range(plan.windows):
        r0 = w * b // plan.windows
        nr = (w + 1) * b // plan.windows - r0
        tiles = min(nr, plan.tiles)
        assert P.probe_seq_smem(h, 5, plan.chunk, -(-nr // tiles)) <= \
            plan.smem
        for blk in range(dirs * plan.slices * tiles):
            d, rest = divmod(blk, plan.slices * tiles)
            bt, sl = divmod(rest, plan.slices)
            b0 = r0 + bt * nr // tiles
            nb = (bt + 1) * nr // tiles - bt * nr // tiles
            j0 = sl * P.PS_UNITS
            count[d, b0:b0 + nb, j0:j0 + min(P.PS_UNITS, h - j0)] += 1
    return count


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("b", [1, 100, 4096, 8192])
@pytest.mark.parametrize("h", [8, 24, 256, 512])
def test_probe_seq_plan_owns_every_row_and_unit_once(h, b, dirs):
    """Every (direction, row, unit) belongs to exactly one block of one
    window; a block's shared memory fits an H100's 232,448 bytes; the
    blocks of a window fit on the card's 132 SMs, one each."""
    from sketch_rnn_tpu_torch.scripts import _probe as P

    plan = P.probe_seq_plan(b, h, 5, dirs)
    assert plan.smem <= 232_448
    assert plan.blocks(dirs) <= 132
    assert plan.chunk in P.PS_CHUNKS and 1 <= plan.windows <= b
    assert (_owners(plan, b, h, dirs) == 1).all()


def test_probe_seq_plan_at_the_probes_shape():
    """B=4096, H=256: 128 blocks in one window, both ways; the dual's
    tiles of 512 rows and the single direction's of 256 in chunks of 64."""
    from sketch_rnn_tpu_torch.scripts import _probe as P

    assert P.probe_seq_plan(4096, 256, 5, 2) == P.ProbeSeqPlan(
        8, 8, 64, 1, 225_280)
    assert P.probe_seq_plan(4096, 256, 5, 1) == P.ProbeSeqPlan(
        8, 16, 64, 1, 192_512)


def test_probe_seq_plan_refuses_what_it_cannot_hold():
    from sketch_rnn_tpu_torch.scripts import _probe as P

    with pytest.raises(ValueError, match="even at one row"):
        P.probe_seq_plan(8, 512, 400, 1)
    with pytest.raises(ValueError, match="SMs"):
        P.probe_seq_plan(8, 512, 5, 2, sms=16)
    for bad in (dict(dirs=3), dict(h=513), dict(b=0)):
        kw = dict(dict(b=8, h=16, d=5, dirs=1), **bad)
        with pytest.raises(ValueError):
            P.probe_seq_plan(**kw)


def test_probe_loop_lanes_gather_the_four_gates_of_one_row_and_unit():
    """The epilogue's gather: an m16n8 accumulator gives lane l columns
    2 (l % 4), + 1 of rows l / 4 (c0, c1) and l / 4 + 8 (c2, c3). With
    the columns ordered [unit][gate] and one swap with lane l ^ 1 (even
    lanes send c2, c3, odd lanes c0, c1), lane l holds gates 0..3 of row
    l / 4 + 8 (l & 1) and unit (l >> 1) & 1, and the 32 lanes cover the
    tile's 16 rows x 2 units once."""
    def acc(lane):        # (row, column) of each accumulator element
        r, c = lane // 4, 2 * (lane % 4)
        return [(r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1)]

    seen = set()
    for lane in range(32):
        v, o = acc(lane), acc(lane ^ 1)
        odd = lane & 1
        got = ([o[2], o[3], v[2], v[3]] if odd else
               [v[0], v[1], o[0], o[1]])
        row, unit = lane // 4 + 8 * odd, (lane >> 1) & 1
        assert got == [(row, unit * 4 + g) for g in range(4)]
        seen.add((row, unit))
    assert len(seen) == 32
