"""The LayerNorm ladder's plain versions against the JAX probes' arms.

``sketch_rnn_tpu_torch/scripts/probe_dec_bwd_split.py::fwd_arm``/``bwd_arm``
and ``probe_ln_stats.py::bwd_fake`` run their plain PyTorch versions on
CPU tensors. The JAX probes' Pallas kernels (``make_fwd_kernel(arm)``,
``make_bwd_kernel(arm)``, ``_bwd_kernel_fake``) run in interpret mode,
called with the probes' own specs, as ``tests/test_probe_kernels.py``
calls them. One case per arm, on the same numpy-made inputs at B=256,
T=3, H=512, D=5 (the backward's Pallas batch tile is 128, so two tiles
exercise the dropout mask's counter): bfloat16 weights ``wx ~ N(0, 0.3)``
and ``wh ~ N(0, 0.05)``, ``xs`` rounded to bfloat16, ``x_bias``, nonzero
carries and carry cotangents, bfloat16 residuals from the JAX production
forward, in-kernel dropout (seed 5, keep 0.9), and the layer-norm
parameters both as the probes set them (ones and zeros) and drawn away
from them, so that a parameter mix-up shows. A bfloat16 ulp is 2**-8
relative, and the two sides round the same values at the same places
(the products' operands, the stored ``hs``/``cs``, ``d_pre`` before the
transposed and weight-gradient products), parting only where float32
sums taken in another order straddle a rounding boundary. The forward
arms are held at ``rtol=1e-2, atol=1e-3``. The backward's outputs are
sums of up to 2,048 (``dxs``, ``dh0``) or 768 (``dwx``, ``dwh``)
bfloat16 products, where one flipped operand moves a cancelling sum by
~4e-3 absolute, so they are held at ``rtol=1e-2`` with ``atol`` 1e-2 of
each output's largest magnitude (``chip_smoke.py``'s bfloat16 measure).
Measured here: at most 1.1e-3 of the largest magnitude (``dh0`` of
``no_gates``), 4.9e-4 for the arms with the gate block.

Also: the plain ``prod`` arms are the plain production functions, an
unknown arm is refused, and CPU tensors never reach a kernel launch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scripts.probe_dec_bwd_split import make_bwd_kernel, make_fwd_kernel
from scripts.probe_ln_stats import _bwd_kernel_fake
from sketch_rnn_tpu.ops import pallas_fused as PF
from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.scripts import _probe
from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as PS
from sketch_rnn_tpu_torch.scripts import probe_ln_stats as PL

B, T, H, D = 256, 3, 512, 5
SEED, KEEP = 5, 0.9
TOL = dict(rtol=1e-2, atol=1e-3)
SCALED = 1e-2
BWD_OUTS = ("dxs", "dxb", "dwx", "dwh", "dgam", "dbet", "dgc", "dbc", "dc0",
            "dh0")


def _bf16(a):
    """``a`` rounded to bfloat16, as float32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _inputs(probe_params):
    """numpy operands; the LN parameters the probes' (ones, zeros) or
    drawn away from them."""
    rng = np.random.default_rng(11 if probe_params else 12)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    d = dict(xs=_bf16(f(T, B, D)), wx=_bf16(f(D, 4 * H, sc=0.3)),
             wh=_bf16(f(H, 4 * H, sc=0.05)), x_bias=f(B, 4 * H, sc=0.1),
             c0=f(B, H, sc=0.3), h0=f(B, H, sc=0.3), dhs=_bf16(f(T, B, H)),
             dcT=f(B, H, sc=0.1), dhT=f(B, H, sc=0.1))
    if probe_params:
        d.update(ln_gamma=np.ones((4, H), np.float32),
                 ln_beta=np.zeros((4, H), np.float32),
                 lnc_gamma=np.ones(H, np.float32),
                 lnc_beta=np.zeros(H, np.float32))
    else:
        d.update(ln_gamma=1 + f(4, H, sc=0.2), ln_beta=f(4, H, sc=0.2),
                 lnc_gamma=1 + f(H, sc=0.2), lnc_beta=f(H, sc=0.2))
    j = {k: jnp.asarray(v) for k, v in d.items()}
    j["wx"], j["wh"] = j["wx"].astype(jnp.bfloat16), j["wh"].astype(
        jnp.bfloat16)
    j["xs"], j["dhs"] = j["xs"].astype(jnp.bfloat16), j["dhs"].astype(
        jnp.bfloat16)
    hs, _, _, cs = PF._lnlstm_fwd_call(
        j["xs"], j["wx"], j["wh"], j["ln_gamma"], j["ln_beta"],
        j["lnc_gamma"], j["lnc_beta"], j["c0"], j["h0"], 1.0, None,
        jnp.asarray(SEED, jnp.int32), KEEP, jnp.bfloat16, j["x_bias"])
    j["hs"], j["cs"] = hs, cs
    return d, j


def _torch(probe_params):
    d, j = _inputs(probe_params)
    t = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    bf = torch.bfloat16
    t["wx"], t["wh"], t["dhs"] = (t[k].to(bf) for k in ("wx", "wh", "dhs"))
    for k in ("hs", "cs"):
        t[k] = torch.from_numpy(np.array(j[k].astype(jnp.float32))).to(bf)
    t["dropout_seed"] = torch.tensor(SEED, dtype=torch.int32)
    return t


def _jax_fwd(kernel_fn, j):
    seed = jnp.asarray(SEED, jnp.int32)
    bt = PF._batch_tile(B, H)
    mode, mask_arg, seed_arg = PF._mask_args(None, seed)
    step, tile, whole, mask_spec, seed_spec = PF._specs(
        bt, H, mode, mask_arg.shape)
    xb_mode, xb_arg, xb_spec = PF._xb_args(j["x_bias"], bt, tile, whole)
    gam, bet = j["ln_gamma"], j["ln_beta"]
    gc2, bc2 = j["lnc_gamma"][None], j["lnc_beta"][None]
    kern = functools.partial(kernel_fn, forget_bias=1.0, mask_mode=mode,
                             keep_prob=KEEP, xb_mode=xb_mode)
    return pl.pallas_call(
        kern, grid=(B // bt, T),
        in_specs=[step((bt, D)), xb_spec, whole(j["wx"].shape),
                  whole(j["wh"].shape), whole(gam.shape), whole(bet.shape),
                  whole(gc2.shape), whole(bc2.shape), tile((bt, H)),
                  tile((bt, H)), mask_spec, seed_spec],
        out_specs=(step((bt, H)), step((bt, H)), tile((bt, H)),
                   tile((bt, H))),
        out_shape=(jax.ShapeDtypeStruct((T, B, H), jnp.bfloat16),
                   jax.ShapeDtypeStruct((T, B, H), jnp.bfloat16),
                   jax.ShapeDtypeStruct((B, H), jnp.float32),
                   jax.ShapeDtypeStruct((B, H), jnp.float32)),
        scratch_shapes=[pltpu.VMEM((bt, H), jnp.float32),
                        pltpu.VMEM((bt, H), jnp.float32)],
        interpret=True,
    )(j["xs"], xb_arg, j["wx"], j["wh"], gam, bet, gc2, bc2, j["c0"],
      j["h0"], mask_arg, seed_arg)


def _jax_bwd(kernel_fn, j):
    seed = jnp.asarray(SEED, jnp.int32)
    bt = PF._batch_tile(B, H, xb_bwd=True)
    mode, mask_arg, seed_arg = PF._mask_args(None, seed)
    step, tile, whole, mask_spec, seed_spec = PF._specs(
        bt, H, mode, mask_arg.shape)
    rstep, rprev, rmask = PF._rev_specs(T, bt, H, mode, mask_arg.shape)
    xb_mode, xb_arg, xb_spec = PF._xb_args(j["x_bias"], bt, tile, whole)
    gam, bet = j["ln_gamma"], j["ln_beta"]
    gc2, bc2 = j["lnc_gamma"][None], j["lnc_beta"][None]
    kern = functools.partial(kernel_fn, forget_bias=1.0, mask_mode=mode,
                             keep_prob=KEEP, xb_mode=xb_mode)
    f32 = jnp.float32
    shapes = ((T, B, D), xb_arg.shape, j["wx"].shape, j["wh"].shape,
              gam.shape, bet.shape, gc2.shape, bc2.shape, (B, H), (B, H))
    return pl.pallas_call(
        kern, grid=(B // bt, T),
        in_specs=[rstep((bt, D)), xb_spec, whole(j["wx"].shape),
                  whole(j["wh"].shape), whole(gam.shape), whole(bet.shape),
                  whole(gc2.shape), whole(bc2.shape), rstep((bt, H)),
                  rprev((bt, H)), tile((bt, H)), rmask, seed_spec,
                  rstep((bt, H)), tile((bt, H)), tile((bt, H))],
        out_specs=(rstep((bt, D)), xb_spec, whole(j["wx"].shape),
                   whole(j["wh"].shape), whole(gam.shape), whole(bet.shape),
                   whole(gc2.shape), whole(bc2.shape), tile((bt, H)),
                   tile((bt, H))),
        out_shape=tuple(jax.ShapeDtypeStruct(s, f32) for s in shapes),
        scratch_shapes=[pltpu.VMEM((bt, H), f32), pltpu.VMEM((bt, H), f32)],
        interpret=True,
    )(j["xs"], xb_arg, j["wx"], j["wh"], gam, bet, gc2, bc2, j["cs"],
      j["hs"], j["h0"].astype(j["hs"].dtype), mask_arg, seed_arg, j["dhs"],
      j["dcT"], j["dhT"])


def _close(want, got, what, scaled=False):
    """Within TOL; ``scaled``: ``atol`` is SCALED of ``want``'s largest
    magnitude."""
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.detach().float().numpy().reshape(w.shape)
    tol = dict(TOL, atol=SCALED * np.abs(w).max()) if scaled else TOL
    np.testing.assert_allclose(g, w, err_msg=what, **tol)


def _fwd_kw(t):
    keys = ("xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma", "lnc_beta",
            "c0", "h0", "x_bias", "dropout_seed")
    return {k: t[k] for k in keys}


def _bwd_kw(t):
    keys = ("xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma", "lnc_beta",
            "h0", "hs", "cs", "dhs", "dcT", "dhT", "x_bias", "dropout_seed")
    return {k: t[k] for k in keys}


@pytest.mark.parametrize("arm", PS.FWD_ARMS)
def test_fwd_arm_matches_pallas(arm):
    for probe_params in (True, False):
        _, j = _inputs(probe_params)
        want = _jax_fwd(make_fwd_kernel(arm), j)
        got = PS.fwd_arm(arm, keep_prob=KEEP, **_fwd_kw(_torch(probe_params)))
        assert got[0].dtype == got[1].dtype == torch.bfloat16
        for name, a, b in zip(("hs", "cs", "cT", "hT"), want, got):
            _close(a, b, f"{arm} {name} (probe params {probe_params})")


@pytest.mark.parametrize("arm", [*PS.ARMS, "fake"])
def test_bwd_arm_matches_pallas(arm):
    """Each backward arm, and probe_ln_stats' fake-stats backward."""
    kernel = _bwd_kernel_fake if arm == "fake" else make_bwd_kernel(arm)
    run = PL.bwd_fake if arm == "fake" else functools.partial(PS.bwd_arm,
                                                              arm)
    for probe_params in (True, False):
        _, j = _inputs(probe_params)
        want = _jax_bwd(kernel, j)
        got = run(keep_prob=KEEP, **_bwd_kw(_torch(probe_params)))
        for name, a, b in zip(BWD_OUTS, want, got):
            assert b.dtype == torch.float32, name
            _close(a, b, f"{arm} {name} (probe params {probe_params})",
                   scaled=True)


@pytest.mark.parametrize("way", ["fwd", "bwd"])
def test_plain_prod_arms_are_the_production_references(way):
    t = _torch(False)
    if way == "fwd":
        got = PS.fwd_arm("prod", keep_prob=KEEP, **_fwd_kw(t))
        want = CF.ln_lstm_fwd_reference(
            keep_prob=KEEP, residual_dtype=torch.bfloat16, **_fwd_kw(t))
        # at float32 residuals, stepped from the stored carries of the
        # free run, every step is the same step
        f32 = dict(keep_prob=KEEP, residual_dtype=torch.float32)
        free = CF.ln_lstm_fwd_reference(**f32, **_fwd_kw(t))
        forced = PS.fwd_plain("prod", teacher=free[:2], **f32, **_fwd_kw(t))
        assert all(torch.equal(a, b) for a, b in zip(forced, free))
    else:
        got = PS.bwd_arm("prod", keep_prob=KEEP, **_bwd_kw(t))
        want = list(CF.ln_lstm_bwd_reference(keep_prob=KEEP, **_bwd_kw(t)))
        # the production backward rounds dwx/dwh to the weights' dtype
        got = list(got)
        got[2:4] = (g.to(torch.bfloat16) for g in got[2:4])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_unknown_arm_is_refused():
    t = _torch(True)
    with pytest.raises(ValueError, match="arm"):
        PS.fwd_arm("no_lnbwd", **_fwd_kw(t))
    with pytest.raises(ValueError, match="arm"):
        PS.bwd_arm("fake", **_bwd_kw(t))      # probe_ln_stats' arm
    with pytest.raises(ValueError, match="arm"):
        PS.bwd_plain("no_gate", **_bwd_kw(t))


def test_cpu_tensors_never_launch(monkeypatch):
    """On CPU tensors the wrappers take their plain versions: no launch,
    no count."""
    def no_launch(*a, **k):
        raise AssertionError("a kernel launch on CPU tensors")

    monkeypatch.setattr(_probe, "launch", no_launch)
    PS.reset_launch_counts()
    PL.reset_launch_counts()
    t = _torch(True)
    small = lambda kw: {k: (v[:1] if k in ("xs", "hs", "cs", "dhs") else v)
                        for k, v in kw.items()}
    for arm in PS.FWD_ARMS:
        PS.fwd_arm(arm, **small(_fwd_kw(t)))
    for arm in PS.ARMS:
        PS.bwd_arm(arm, **small(_bwd_kw(t)))
    PL.bwd_fake(**small(_bwd_kw(t)))
    assert not any(PS.launch_counts().values())
    assert PL.launch_counts() == {"bwd_fake": 0}


def test_glue_step_flips_the_streams():
    hs = torch.arange(2 * T * 3, dtype=torch.float32).reshape(T, 2, 3)
    h0 = torch.full((2, 3), -1.0)
    (hs2, cs, dhs, dxs), hp = PS.glue_step((hs, hs + 1, hs + 2, hs + 3), h0)
    assert torch.equal(hs2, hs)
    assert torch.equal(cs, torch.flip(hs + 1, dims=(0,)))
    assert torch.equal(dxs, torch.flip(hs + 3, dims=(0,)))
    assert torch.equal(hp[-1], h0) and torch.equal(hp[0], hs[-2])
