"""The training kernels' plain versions against the JAX package's kernels.

``sketch_rnn_tpu_torch/ops/cuda_fused.py`` holds ``fused_lstm_seq`` and
``fused_ln_lstm`` as ``torch.autograd.Function``s whose CPU path is their
plain PyTorch forward and step-by-step backward. Here the same numpy-made
inputs go through them and through the JAX package's custom-VJP Pallas
kernels (run in interpret mode on the CPU, as the JAX package's own tests
run them): forward values and every gradient, with dropout off, with
streamed masks and with an in-kernel dropout seed, with ``x_bias`` on and
off, and with a batch of three Pallas tiles (B=24 at H=16 gives tile 8;
the mask counter must not depend on the tiling). The tolerance is the
JAX kernels' own, ``rtol=2e-5, atol=2e-6``
(``tests/test_pallas_fused.py``). The plain backward is also held against
autograd of the plain forward, and ``prng_mask`` bitwise against
``pallas_fused._prng_mask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.ops import pallas_fused as PF
from sketch_rnn_tpu_torch.ops import cuda_fused as CF

T, B, D, H = 5, 8, 5, 16
KEEP = 0.9
RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny shapes gain nothing from intra-op threads; one thread
    keeps the torch side from competing for cores with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cell, b=B, seed=0, x_bias=False):
    """Weights and inputs from numpy: xavier-ish weights, LN params near
    (1, 0), carries ~N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    d = {"xs": f(T, b, D), "wx": f(D, 4 * H, sc=0.4),
         "wh": f(H, 4 * H, sc=0.25), "c0": f(b, H, sc=0.3),
         "h0": f(b, H, sc=0.3), "w_out": f(T, b, H, sc=0.1)}
    if cell == "lstm":
        d["b"] = f(4 * H, sc=0.1)
    else:
        d.update(ln_gamma=1 + f(4, H, sc=0.1), ln_beta=f(4, H, sc=0.1),
                 lnc_gamma=1 + f(H, sc=0.1), lnc_beta=f(H, sc=0.1))
        if x_bias:
            d["x_bias"] = f(b, 4 * H, sc=0.3)
    return d


def _masks(b, seed=9):
    m = np.random.default_rng(seed).random((T, b, H)) < KEEP
    return (m / np.float32(KEEP)).astype(np.float32)


def _close(a, b, what):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=what)


def _dropout_args(mode, b):
    """(masks, seed) for the JAX call and for the port's."""
    if mode == "masks":
        m = _masks(b)
        return (jnp.asarray(m), None), (torch.from_numpy(m), None)
    if mode == "seed":
        return (None, jnp.int32(123457)), (None, torch.tensor(123457,
                                                              dtype=torch.int32))
    return (None, None), (None, None)


def _torch_leaves(d, names):
    return {k: torch.from_numpy(d[k]).requires_grad_(True) for k in names}


@pytest.mark.parametrize("mode,b", [("none", B), ("masks", B), ("seed", B),
                                    ("seed", 24)])
def test_lstm_seq_matches_pallas(mode, b):
    d = _inputs("lstm", b)
    (jm, js), (tm, ts) = _dropout_args(mode, b)
    keep = KEEP if mode == "seed" else 1.0
    wout = jnp.asarray(d["w_out"])

    def jloss(wx, bb, wh):
        hs = PF.fused_lstm_seq(jnp.asarray(d["xs"]), wx, bb, wh,
                               jnp.asarray(d["c0"]), jnp.asarray(d["h0"]),
                               1.0, jm, js, keep)
        return jnp.sum(hs * wout), hs

    (_, jhs), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(
        jnp.asarray(d["wx"]), jnp.asarray(d["b"]), jnp.asarray(d["wh"]))
    p = _torch_leaves(d, ("xs", "wx", "b", "wh", "c0", "h0"))
    hs = CF.fused_lstm_seq(p["xs"], p["wx"], p["b"], p["wh"], p["c0"],
                           p["h0"], 1.0, tm, ts, keep)
    (hs * torch.from_numpy(d["w_out"])).sum().backward()
    _close(jhs, hs, "hs")
    for name, g in zip(("wx", "b", "wh"), jg):
        _close(g, p[name].grad, f"d{name}")
    for name in ("xs", "c0", "h0"):      # zero by definition
        assert not p[name].grad.any(), name


@pytest.mark.parametrize("mode,xb,b", [
    ("none", False, B), ("none", True, B), ("masks", True, B),
    ("seed", False, B), ("seed", True, B), ("seed", True, 24)])
def test_ln_lstm_matches_pallas(mode, xb, b):
    d = _inputs("layer_norm", b, x_bias=xb)
    (jm, js), (tm, ts) = _dropout_args(mode, b)
    keep = KEEP if mode == "seed" else 1.0
    names = ["xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
             "lnc_beta", "c0", "h0"] + (["x_bias"] if xb else [])
    wout = jnp.asarray(d["w_out"])

    def jloss(*args):
        kw = dict(zip(names, args))
        hs, (cT, hT) = PF.fused_ln_lstm(
            kw["xs"], kw["wx"], kw["wh"], kw["ln_gamma"], kw["ln_beta"],
            kw["lnc_gamma"], kw["lnc_beta"], kw["c0"], kw["h0"], 1.0, jm,
            js, keep, jnp.float32, kw.get("x_bias"))
        loss = jnp.sum(hs * wout) + jnp.sum(cT) + 0.5 * jnp.sum(hT)
        return loss, (hs, cT, hT)

    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(d[n]) for n in names))
    p = _torch_leaves(d, names)
    hs, (cT, hT) = CF.fused_ln_lstm(
        p["xs"], p["wx"], p["wh"], p["ln_gamma"], p["ln_beta"],
        p["lnc_gamma"], p["lnc_beta"], p["c0"], p["h0"], 1.0, tm, ts, keep,
        None, p.get("x_bias"))
    loss = (hs * torch.from_numpy(d["w_out"])).sum() + cT.sum() \
        + 0.5 * hT.sum()
    loss.backward()
    for name, a, t in zip(("hs", "cT", "hT"), jout, (hs, cT, hT)):
        _close(a, t, name)
    for name, g in zip(names, jg):
        _close(g, p[name].grad, f"d{name}")


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
@pytest.mark.parametrize("mode", ["none", "seed"])
def test_plain_backward_matches_autograd_of_plain_forward(cell, mode):
    """The step-by-step backward against torch.autograd through the plain
    forward (float64, so only the algebra is compared)."""
    d = _inputs(cell, x_bias=True)
    seed = torch.tensor(77, dtype=torch.int32) if mode == "seed" else None
    keep = KEEP if seed is not None else 1.0
    p = {k: torch.from_numpy(v).double().requires_grad_(True)
         for k, v in d.items()}
    dhs = p.pop("w_out").detach()
    if cell == "lstm":
        args = (p["xs"], p["wx"], p["b"], p["wh"], p["c0"], p["h0"])
        hs, cs = CF.lstm_seq_fwd_reference(*args, 1.0, None, seed, keep)
        (hs * dhs).sum().backward()
        got = CF.lstm_seq_bwd_reference(
            p["xs"].detach(), p["wx"].detach(), p["b"].detach(),
            p["wh"].detach(), p["h0"].detach(), hs.detach(), cs.detach(),
            dhs, 1.0, None, seed, keep)
        want = (p["wx"].grad, p["b"].grad, p["wh"].grad)
    else:
        names = ("xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
                 "lnc_beta", "c0", "h0")
        hs, cs, cT, hT = CF.ln_lstm_fwd_reference(
            *(p[n] for n in names), 1.0, None, seed, keep, p["x_bias"])
        ((hs * dhs).sum() + cT.sum() + 0.5 * hT.sum()).backward()
        det = {n: p[n].detach() for n in p}
        got = CF.ln_lstm_bwd_reference(
            *(det[n] for n in ("xs", "wx", "wh", "ln_gamma", "ln_beta",
                               "lnc_gamma", "lnc_beta", "h0")),
            hs.detach(), cs.detach(), dhs, torch.ones_like(cT),
            torch.full_like(hT, 0.5), 1.0, None, seed, keep, det["x_bias"])
        want = tuple(p[n].grad for n in ("xs", "x_bias", "wx", "wh",
                                         "ln_gamma", "ln_beta", "lnc_gamma",
                                         "lnc_beta", "c0", "h0"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("b,h,bt", [(8, 16, 8), (24, 16, 8), (6, 4, 6)])
def test_prng_mask_bitwise(b, h, bt):
    """Every step's mask, tile by tile from the Pallas helper, equals the
    port's whole-batch mask bit for bit."""
    for seed in (0, 123457, 2 ** 31 - 2):
        sref = jnp.asarray([[seed]], jnp.int32)
        for t in (0, 1, 7, 249):
            want = np.concatenate([np.asarray(PF._prng_mask(
                sref, jnp.int32(t), jnp.int32(ib), b // bt, (bt, h), KEEP))
                for ib in range(b // bt)])
            got = CF.prng_mask(seed, t, b, h, KEEP).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            assert set(np.unique(got)) <= {0.0, np.float32(1 / KEEP)}


def test_wrappers_refuse_what_they_do_not_take():
    d = {k: torch.from_numpy(v) for k, v in _inputs("lstm").items()}
    args = (d["xs"], d["wx"], d["b"], d["wh"], d["c0"], d["h0"])
    with pytest.raises(ValueError, match="not both"):
        CF.fused_lstm_seq(*args, 1.0, torch.ones(T, B, H), 3, 0.9)
    with pytest.raises(NotImplementedError, match="next slice"):
        CF.fused_lstm_seq(*args, residual_dtype=torch.bfloat16)
