"""The HyperLSTM backward's design, held on the CPU.

``srt_hyper_bwd`` (``sketch_rnn_tpu_torch/csrc/fused_hyper.cu``) runs on
the card only; what it is built from is held here: the loop's plan
(``cuda_fused.hyper_bwd_plan``, the grid, windows and shared memory the
kernel checks before any launch), the exact scratch the wrapper allocates
(``hyper_scratch_bytes``), and stage 1's plain version
(``hyper_recompute_reference``: every step's forward up to the gate block
recomputed for all row-steps at once from the stored residuals) against
the step-by-step recompute of ``hyper_lstm_bwd_reference`` and against
``pallas_fused._hyper_recompute``, the function the JAX package's
backward kernel runs at every step (plain jnp on the CPU, as its
interpret-mode kernel runs it), on the same stored residuals.

Tolerances. Against the step-by-step recompute: 1e-6 relative at
float32 (the same products over the same rows, batched), 1e-2 at bfloat16
(an operand rounded to bfloat16 on either side of a boundary moves by one
ulp, 2**-8). Against JAX: the Pallas tests' ``rtol=2e-5, atol=2e-6`` at
float32 and ``rtol=1e-2, atol=1e-3`` at bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.ops import pallas_fused as PF
from sketch_rnn_tpu_torch.ops import cuda_fused as CF

T, B, D = 4, 5, 5
F32, BF16 = torch.float32, torch.bfloat16
RTOL, ATOL = 2e-5, 2e-6
BF_RTOL, BF_ATOL = 1e-2, 1e-3
# (H, HH, e): the auxiliary LSTM wider than the main one, and narrower
SHAPES = ((16, 32, 8), (40, 8, 4))


# -- the loop's plan and the scratch ------------------------------------------


@pytest.mark.parametrize("b,h,hh,e,want", [
    # the hyper preset: LN slices of 16 units, 32 slices x 4 tiles = 128
    # blocks on 132 SMs, one window; the transposed products split in two
    # (the wh and wxh_h rows of 16 units do not fit at float beside the
    # rest): each block holds 8 units' rows for the rows of 2 tiles
    (100, 512, 256, 32, (16, 2, 32, 4, 1, 3, 194_624)),
    (5, 16, 32, 8, (16, 1, 2, 5, 1, 2, 46_784)),
    (5, 40, 8, 4, (16, 1, 3, 5, 1, 6, 30_792)),
    (6, 24, 24, 3, (16, 1, 2, 6, 1, 2, 34_848)),
    # three rows cannot take two tiles of a split: 8 units, no split
    (3, 512, 256, 32, (8, 1, 64, 2, 1, 3, 211_520))])
def test_hyper_bwd_plan_at_the_preset_and_narrow_shapes(b, h, hh, e, want):
    p = CF.hyper_bwd_plan(b, h, hh, e)
    assert tuple(p) == want
    assert p.slices * p.tiles <= CF.HYPER_SMS
    assert p.tiles % p.split == 0
    assert p.smem <= CF.HYPER_SMEM_MAX
    # the slices cover both unit sets, neither wider than a slice's units
    assert -(-h // p.slices) <= p.units and -(-hh // p.slices) <= p.units
    assert p == CF.hyper_bwd_plan(b, h, hh, e, torch.bfloat16)


def test_hyper_bwd_plan_takes_the_fewest_windows_that_fit():
    """B=8192 at the preset's widths: a tile's partial sums exceed a
    block's shared memory in one window; the plan takes the least number
    of windows whose tiles fit, and one window fewer would not."""
    b, h, hh, e = 8192, 512, 256, 32
    p = CF.hyper_bwd_plan(b, h, hh, e)
    assert p.windows == 23 and (p.units, p.split, p.slices, p.tiles) == (
        16, 2, 32, 4)

    def smem(windows):
        rows = -(-b // windows)
        return CF.hyper_bwd_smem(p.units, p.split, p.slices,
                                 -(-rows // p.tiles), h, hh, e, p.parts)
    assert smem(p.windows) == p.smem <= CF.HYPER_SMEM_MAX
    assert smem(p.windows - 1) > CF.HYPER_SMEM_MAX


@pytest.mark.parametrize("kw,err", [
    (dict(b=100, h=512, hh=256, e=32, sms=16), ValueError),  # no grid fits
    (dict(b=100, h=512, hh=256, e=32, smem_max=64_000), ValueError),
    (dict(b=4, h=16, hh=16, e=300), ValueError),   # dz rows outgrow smem
    (dict(b=0, h=16, hh=16, e=4), ValueError),
    (dict(b=4, h=600, hh=16, e=4), ValueError),
    (dict(b=4, h=16, hh=16, e=4, dtype=torch.float16), TypeError)])
def test_hyper_bwd_plan_refuses_a_shape_it_cannot_hold(kw, err):
    with pytest.raises(err):
        CF.hyper_bwd_plan(**kw)


def test_hyper_scratch_bytes_is_what_the_wrapper_allocates():
    """At the preset: the streams, the work on the plan's slices and the
    largest product's partials; within the 1.6 GB the design allows."""
    t, b, d, h, hh, e = 250, 100, 5, 512, 256, 32
    p = CF.hyper_bwd_plan(b, h, hh, e)
    streams = t * b * (20 * h + 4 * hh + 24 * e + hh)
    work = (-(-b * (14 * h + 4 * hh + 8 * e) // 4) * 4 + b * p.slices * 10
            + t * b * 10 + 4 * b * h + b * p.slices * 12 * e + b * (h + hh))
    parts = max(CF._wg_plan(t * b, dx, m, n, 0, F32).slices * (dx + m)
                * (-(-n // 4) * 4)
                for dx, m, n, _ in CF.hyper_products(d, h, hh, e))
    assert CF.hyper_stream_floats(t, b, h, hh, e) == streams
    assert CF.hyper_work_floats(t, b, h, hh, e, p.slices) == work
    assert CF.hyper_wg_floats(t, b, d, h, hh, e, F32) == parts
    total = CF.hyper_scratch_bytes(t, b, d, h, hh, e)
    assert total == 4 * (streams + work + parts) == 1_289_680_448
    assert total <= 1.6e9
    # eleven products: three on the main rows, three w_hz, twelve zd blocks
    prods = CF.hyper_products(d, h, hh, e)
    assert len(prods) == 18 and sum(not r for *_, r in prods) == 12


# -- stage 1: the hoisted recompute -------------------------------------------


def _operands(h, hh, e, wdt, biases, seed=0):
    """Seeded weights and a forward's stored residuals (the plain forward,
    which ``test_torch_hyper`` holds against the Pallas forward)."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *s, sc=1.0: torch.randn(s, generator=g) * sc
    w = CF.HyperWeights(
        wx=f(D, 4 * h, sc=0.4), b=f(4 * h, sc=0.1), wh=f(h, 4 * h, sc=0.25),
        wxh_x=f(D, 4 * hh, sc=0.4), wxh_h=f(h, 4 * hh, sc=0.25),
        bh=f(4 * hh, sc=0.1), whh=f(hh, 4 * hh, sc=0.25),
        w_hz_x=f(hh, 4 * e, sc=0.2), b_hz_x=1 + f(4 * e, sc=0.1),
        w_hz_h=f(hh, 4 * e, sc=0.2), b_hz_h=1 + f(4 * e, sc=0.1),
        w_hz_b=f(hh, 4 * e, sc=0.2), zd_x=0.1 / e + f(4, e, h, sc=0.05),
        zd_h=0.1 / e + f(4, e, h, sc=0.05), zd_b=f(4, e, h, sc=0.05),
        ln_gamma=1 + f(4, h, sc=0.1), ln_beta=f(4, h, sc=0.1),
        lnc_gamma=1 + f(h, sc=0.1), lnc_beta=f(h, sc=0.1))
    w = w._replace(**{n: getattr(w, n).to(wdt) for n in CF.HYPER_MATRICES})
    xs = f(T, B, D)
    h0, hh0 = f(B, h, sc=0.3), f(B, hh, sc=0.3)
    xb = (f(B, 4 * h, sc=0.3), f(B, 4 * hh, sc=0.3)) if biases else (None,
                                                                     None)
    rdt = None if wdt == F32 else wdt
    hs, cs, hycs, hyhs = CF.hyper_lstm_fwd_reference(
        xs, w, f(B, h, sc=0.3), h0, f(B, hh, sc=0.3), hh0, 1.0,
        dropout_seed=123, keep_prob=0.9, x_bias=xb[0], x_bias_hyper=xb[1],
        residual_dtype=rdt)[:4]
    return xs, w, h0, hh0, hs, cs, hycs, hyhs, xb


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wdt,biases", [(F32, True), (F32, False),
                                        (BF16, True)])
def test_hyper_recompute_reference_matches_the_step_by_step_recompute(
        shape, wdt, biases):
    """Every stream of stage 1 against ``_HyperStep`` (what
    ``hyper_lstm_bwd_reference`` recomputes at each step) on the stored
    residuals, h_{t-1} and hh_{t-1} read as the backward reads them."""
    h, hh, e = shape
    xs, w, h0, hh0, hs, cs, hycs, hyhs, xb = _operands(h, hh, e, wdt, biases)
    r = CF.hyper_recompute_reference(xs, w, h0, hh0, hs, hycs, hyhs, 1.0,
                                     *xb)
    step = CF._HyperStep(w, 1.0, *xb)
    tol = 1e-6 if wdt == F32 else 1e-2
    for s in range(T):
        hp = (hs[s - 1] if s else h0.to(hs.dtype)).float()
        hhp = (hyhs[s - 1] if s else hh0.to(hyhs.dtype)).float()
        ln, aux = step(xs[s], hp, cs[s].float(), hycs[s].float(), hhp, None)
        hi, hg, hf, ho, nhc, nhh, xp, hpp, zx, zh, zb, sx, sh = aux
        sb = CF._block_scale(zb, w.zd_b)
        want = {"hyper_h": CF._rnd(nhh, wdt), "xp": xp, "hp": hpp,
                "z": torch.cat([zx, zh, zb], -1), "sx": sx, "sh": sh,
                "pre": sx * xp + sh * hpp + sb + w.b}
        for k, v in want.items():
            assert _rel(r[k][s], v) <= tol, (k, s)
        gates = CF._lstm_gates(r["hyper_pre"][s], hycs[s].float(), None, 1.0)
        assert _rel(gates[4], nhc) <= tol


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wdt", [F32, BF16])
def test_hyper_recompute_reference_matches_the_pallas_recompute(shape, wdt):
    """Stage 1 against ``pallas_fused._hyper_recompute`` (the step the JAX
    backward kernel recomputes), given all row-steps at once: the same
    stored residuals as numpy, the matrices in the weight dtype."""
    h, hh, e = shape
    xs, w, h0, hh0, hs, cs, hycs, hyhs, xb = _operands(h, hh, e, wdt, True)
    r = CF.hyper_recompute_reference(xs, w, h0, hh0, hs, hycs, hyhs, 1.0,
                                     *xb)
    jdt = jnp.float32 if wdt == F32 else jnp.bfloat16
    jw = {n: jnp.asarray(_np(getattr(w, n))) for n in CF.HyperWeights._fields}
    for n in CF.HYPER_MATRICES:
        jw[n] = jw[n].astype(jdt)
    vec = lambda n: jw[n][None]          # a bias ref: [1, N]
    flat = lambda v: jnp.asarray(_np(v).reshape(T * B, -1))
    h_prev = torch.cat([h0.to(hs.dtype)[None], hs[:-1]]).float()
    hh_prev = torch.cat([hh0.to(hyhs.dtype)[None], hyhs[:-1]]).float()
    tile = lambda v: jnp.asarray(np.tile(_np(v), (T, 1)))
    ln, aux = PF._hyper_recompute(
        flat(xs), flat(h_prev), flat(cs), flat(hycs), flat(hh_prev),
        jw["wx"], vec("b"), jw["wh"], jw["wxh_x"], jw["wxh_h"], vec("bh"),
        jw["whh"], jw["w_hz_x"], vec("b_hz_x"), jw["w_hz_h"],
        vec("b_hz_h"), jw["w_hz_b"], jw["zd_x"], jw["zd_h"], jw["zd_b"],
        jw["ln_gamma"], jw["ln_beta"], vec("lnc_gamma"), vec("lnc_beta"),
        None, 1.0, want_residuals=False, xb=tile(xb[0]), xbh=tile(xb[1]))
    hi, hg, hf, ho, nhc, nhh, xp, hp, zx, zh, zb, sx, sh = aux
    sb = PF._block_scale(zb, jw["zd_b"])
    want = {"hyper_h": nhh.astype(jdt), "xp": xp, "hp": hp,
            "z": jnp.concatenate([zx, zh, zb], -1), "sx": sx, "sh": sh,
            "pre": sx * xp + sh * hp + sb + vec("b")}
    rtol, atol = (RTOL, ATOL) if wdt == F32 else (BF_RTOL, BF_ATOL)
    for k, v in want.items():
        np.testing.assert_allclose(_np(r[k]).reshape(T * B, -1),
                                   np.asarray(v, np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)
