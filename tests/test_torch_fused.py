"""The training kernels' plain versions against the JAX package's kernels.

``sketch_rnn_tpu_torch/ops/cuda_fused.py`` holds ``fused_lstm_seq``,
``fused_lstm`` and ``fused_ln_lstm`` as ``torch.autograd.Function``s whose
CPU path is their plain PyTorch forward and step-by-step backward. Here
the same numpy-made inputs go through them and through the JAX package's
custom-VJP Pallas kernels (run in interpret mode on the CPU, as the JAX
package's own tests run them): forward values and every gradient, with
dropout off, with streamed masks and with an in-kernel dropout seed, with
``x_bias`` on and off, nonzero initial carries, and with a batch of three
Pallas tiles (B=24 at H=16 gives tile 8; the mask counter must not depend
on the tiling). The tolerance is the JAX kernels' own, ``rtol=2e-5,
atol=2e-6`` (``tests/test_pallas_fused.py``).

At bfloat16 weights and residuals (the flagship preset's setting) the
same comparison holds at ``rtol=1e-2, atol=1e-3``: one bfloat16 ulp is
2**-8 relative, and both sides round the same float32 values at the same
places (each product's activation operand, the stored ``hs``/``cs``,
``d_pre`` for the transposed and weight-gradient products, the weight
gradients once at the end), so they part only where float32 sums taken
in another order straddle a rounding boundary. Measured at these shapes:
largest gap 1.95e-3 (one bfloat16 ulp of an LN-LSTM weight gradient),
every bfloat16 ``hs`` element bitwise equal (the test asks for 90%).

The plain backward is also held against autograd of the plain forward,
and ``prng_mask`` bitwise against ``pallas_fused._prng_mask``.
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


def _slice_sums(v, h):
    """Row sums over the last axis of ``v [..., H]`` as the LN backward's
    loop takes them: a partial per slice of ``CF.LN_UNITS`` units (slice
    ``sl`` holds units ``sl * H // slices`` up to the next slice's), the
    partials added in slice order."""
    slices = -(-h // CF.LN_UNITS)
    out = torch.zeros(v.shape[:-1], dtype=v.dtype)
    for sl in range(slices):
        out = out + v[..., sl * h // slices:(sl + 1) * h // slices].sum(-1)
    return out[..., None]


def _ln_bwd_partition(xs, wx, wh, gam, bet, gc, bc, h0, hs, cs, dhs, dcT,
                      dhT, forget_bias, masks, seed, keep, x_bias):
    """The LN backward's partition (``srt_ln_lstm_bwd``) in plain PyTorch:
    the pre-activations of every step and their layer-norm statistics
    hoisted out of the loop, then per step the cell norm's row sums and
    the gate norms' row sums as slice partials summed in slice order (the
    loop's exchanges (a) and (b)), d_pre, and dh through wh; dxs and the
    weight gradients after the loop. Returns ``ln_lstm_bwd``'s outputs
    with the weight gradients in float32."""
    t, b, _ = xs.shape
    h = wh.shape[0]
    h_prev = torch.cat([h0[None], hs[:-1]])
    pre = xs @ wx + h_prev @ wh
    if x_bias is not None:
        pre = pre + x_bias
    pg = pre.view(t, b, 4, h)
    mean = pg.mean(-1, keepdim=True)
    rs = torch.rsqrt(((pg - mean) ** 2).mean(-1, keepdim=True) + 1e-6)
    xhat = (pg - mean) * rs
    y = xhat * gam + bet
    i, gu = torch.sigmoid(y[:, :, 0]), torch.tanh(y[:, :, 1])
    f, o = torch.sigmoid(y[:, :, 2] + forget_bias), torch.sigmoid(y[:, :, 3])
    m = torch.stack([CF._step_mask(masks, seed, s, b, h, keep)
                     if masks is not None or seed is not None
                     else torch.ones(b, h) for s in range(t)])
    nc = cs * f + i * (gu * m)
    cmean = nc.mean(-1, keepdim=True)
    crs = torch.rsqrt(((nc - cmean) ** 2).mean(-1, keepdim=True) + 1e-6)
    xhat_c = (nc - cmean) * crs
    tanh_yc = torch.tanh(xhat_c * gc + bc)
    dh = dhT if dhT is not None else torch.zeros(b, h)
    dc = dcT if dcT is not None else torch.zeros(b, h)
    dgam, dbet = torch.zeros(4, h), torch.zeros(4, h)
    dgc, dbc = torch.zeros(h), torch.zeros(h)
    d_pre = torch.empty(t, b, 4 * h)
    for s in range(t - 1, -1, -1):
        dh_tot = dh + dhs[s]
        do = dh_tot * tanh_yc[s]
        dyc = dh_tot * o[s] * (1.0 - tanh_yc[s] ** 2)
        dgc += (dyc * xhat_c[s]).sum(0)
        dbc += dyc.sum(0)
        dxh_c = dyc * gc
        dcv = dc + crs[s] * (dxh_c - _slice_sums(dxh_c, h) / h
                             - xhat_c[s] * (_slice_sums(dxh_c * xhat_c[s], h)
                                            / h))
        dy = torch.stack([dcv * (gu[s] * m[s]) * i[s] * (1.0 - i[s]),
                          dcv * i[s] * m[s] * (1.0 - gu[s] ** 2),
                          dcv * cs[s] * f[s] * (1.0 - f[s]),
                          do * o[s] * (1.0 - o[s])], 1)
        dgam += (dy * xhat[s]).sum(0)
        dbet += dy.sum(0)
        dxh = dy * gam
        dp = rs[s] * (dxh - _slice_sums(dxh, h) / h
                      - xhat[s] * (_slice_sums(dxh * xhat[s], h) / h))
        d_pre[s] = dp.reshape(b, 4 * h)
        dh = d_pre[s] @ wh.T
        dc = dcv * f[s]
    dxb = d_pre.sum(0) if x_bias is not None else None
    return (d_pre @ wx.T, dxb,
            torch.einsum("tbd,tbg->dg", xs, d_pre),
            torch.einsum("tbk,tbg->kg", h_prev, d_pre), dgam, dbet, dgc, dbc,
            dc, dh)


@pytest.mark.parametrize("mode", ["masks", "seed"])
def test_ln_bwd_partition_matches_pallas(mode):
    """The plain model of the LN backward's partition at H=40 (three
    slices of 13, 13 and 14 units), B=3, float32, x_bias on, nonzero
    carries and carry cotangents, against the JAX package's fused_ln_lstm
    VJP (its Pallas kernels in interpret mode) and against
    ``ln_lstm_bwd_reference``. The partition only reorders float32 sums,
    so the module's tolerance (the JAX kernels' own) holds."""
    h, b = 40, 3
    rng = np.random.default_rng(11)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    d = {"xs": f(T, b, D), "wx": f(D, 4 * h, sc=0.4),
         "wh": f(h, 4 * h, sc=0.25), "ln_gamma": 1 + f(4, h, sc=0.1),
         "ln_beta": f(4, h, sc=0.1), "lnc_gamma": 1 + f(h, sc=0.1),
         "lnc_beta": f(h, sc=0.1), "c0": f(b, h, sc=0.3),
         "h0": f(b, h, sc=0.3), "x_bias": f(b, 4 * h, sc=0.3)}
    cot = {"dhs": f(T, b, h, sc=0.1), "dcT": f(b, h, sc=0.1),
           "dhT": f(b, h, sc=0.1)}
    if mode == "masks":
        mk = ((rng.random((T, b, h)) < KEEP) / np.float32(KEEP)).astype(
            np.float32)
        (jm, js), (tm, ts) = (jnp.asarray(mk), None), (torch.from_numpy(mk),
                                                       None)
    else:
        (jm, js), (tm, ts) = _dropout_args("seed", b)
    keep = KEEP if mode == "seed" else 1.0
    names = ["xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
             "lnc_beta", "c0", "h0", "x_bias"]

    def jrun(*args):
        kw = dict(zip(names, args))
        hs, (cT, hT) = PF.fused_ln_lstm(
            kw["xs"], kw["wx"], kw["wh"], kw["ln_gamma"], kw["ln_beta"],
            kw["lnc_gamma"], kw["lnc_beta"], kw["c0"], kw["h0"], 1.0, jm,
            js, keep, jnp.float32, kw["x_bias"])
        return hs, cT, hT

    _, vjp = jax.vjp(jrun, *(jnp.asarray(d[n]) for n in names))
    jg = dict(zip(names, vjp(tuple(jnp.asarray(cot[k])
                                   for k in ("dhs", "dcT", "dhT")))))
    t_ = {k: torch.from_numpy(v) for k, v in {**d, **cot}.items()}
    ln = [t_[k] for k in ("ln_gamma", "ln_beta", "lnc_gamma", "lnc_beta")]
    hs, cs, _, _ = CF.ln_lstm_fwd_reference(
        t_["xs"], t_["wx"], t_["wh"], *ln, t_["c0"], t_["h0"], 1.0, tm, ts,
        keep, t_["x_bias"])
    args = (t_["xs"], t_["wx"], t_["wh"], *ln, t_["h0"], hs, cs, t_["dhs"],
            t_["dcT"], t_["dhT"], 1.0, tm, ts, keep, t_["x_bias"])
    got = _ln_bwd_partition(*args)
    out_names = ("xs", "x_bias", "wx", "wh", "ln_gamma", "ln_beta",
                 "lnc_gamma", "lnc_beta", "c0", "h0")
    for name, g, r in zip(out_names, got, CF.ln_lstm_bwd_reference(*args)):
        _close(jg[name], g, f"d{name} vs the JAX VJP")
        _close(r.numpy(), g, f"d{name} vs ln_lstm_bwd_reference")


def _slice_moments(v, h):
    """Each slice's mean and M2 over the last axis of ``v [..., H]`` as the
    LN forward's loop takes them (slices as :func:`_slice_sums` cuts
    them): the slice mean, then the sum of squared deviations from it.
    Returns ``(means, m2s, counts)``, the first two ``[..., slices]``."""
    slices = -(-h // CF.LN_UNITS)
    means, m2s, counts = [], [], []
    for sl in range(slices):
        part = v[..., sl * h // slices:(sl + 1) * h // slices]
        m = part.sum(-1) / part.shape[-1]
        means.append(m)
        m2s.append(((part - m[..., None]) ** 2).sum(-1))
        counts.append(float(part.shape[-1]))
    return torch.stack(means, -1), torch.stack(m2s, -1), counts


def _chan(v, h):
    """A row layer norm's mean and ``rsqrt(var + 1e-6)`` over the last axis
    of ``v`` from its slices' moments, combined in slice order by Chan's
    rule: ``mean = sum n_s m_s / H``, ``M2 = sum (M2_s + n_s (m_s -
    mean)^2)``."""
    means, m2s, counts = _slice_moments(v, h)
    s = torch.zeros(v.shape[:-1])
    for k, n in enumerate(counts):
        s = s + n * means[..., k]
    mean = s / h
    q = torch.zeros(v.shape[:-1])
    for k, n in enumerate(counts):
        q = q + (m2s[..., k] + n * (means[..., k] - mean) ** 2)
    return mean[..., None], torch.rsqrt(q / h + 1e-6)[..., None]


def _ln_fwd_partition(xs, wx, wh, gam, bet, gc, bc, c0, h0, forget_bias,
                      masks, seed, keep, x_bias):
    """The LN forward's partition (``srt_ln_lstm_fwd``) in plain PyTorch:
    per step the products, each gate's slice moments combined in slice
    order (the loop's first exchange), the gate block, the new cell
    state's slice moments combined the same way (the second exchange),
    ``h``. Returns ``ln_lstm_fwd``'s ``(hs, cs, cT, hT)``."""
    t, b, _ = xs.shape
    h = wh.shape[0]
    c, hh = c0, h0
    hs, cs = [], []
    for s in range(t):
        pre = xs[s] @ wx + hh @ wh
        if x_bias is not None:
            pre = pre + x_bias
        pg = pre.view(b, 4, h)
        mean, rs = _chan(pg, h)
        y = (pg - mean) * rs * gam + bet
        i, gu = torch.sigmoid(y[:, 0]), torch.tanh(y[:, 1])
        f, o = torch.sigmoid(y[:, 2] + forget_bias), torch.sigmoid(y[:, 3])
        m = CF._step_mask(masks, seed, s, b, h, keep)
        nc = c * f + i * (gu * m if m is not None else gu)
        cmean, crs = _chan(nc, h)
        cs.append(c)
        c, hh = nc, torch.tanh((nc - cmean) * crs * gc + bc) * o
        hs.append(hh)
    return torch.stack(hs), torch.stack(cs), c, hh


@pytest.mark.parametrize("case", ["masks", "seed", "far_from_zero"])
def test_ln_fwd_partition_matches_pallas(case):
    """The plain model of the LN forward's partition at H=40 (three slices
    of 13, 13 and 14 units), B=3, float32, x_bias on, nonzero carries,
    against the JAX package's fused_ln_lstm forward (its Pallas kernel in
    interpret mode) and against ``ln_lstm_fwd_reference``; in
    ``far_from_zero`` x_bias puts every gate's pre-activations near 12,
    ten times their spread or more, where one-pass sums of x and x**2
    would lose two digits to cancellation and the slices' two-pass
    moments do not (further out the float32 rounding of the
    pre-activations alone, in any order, outgrows the tolerance). The
    partition only reorders float32 sums, so the module's tolerance (the
    JAX kernels' own) holds."""
    h, b = 40, 3
    rng = np.random.default_rng(12)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    d = {"xs": f(T, b, D), "wx": f(D, 4 * h, sc=0.4),
         "wh": f(h, 4 * h, sc=0.25), "ln_gamma": 1 + f(4, h, sc=0.1),
         "ln_beta": f(4, h, sc=0.1), "lnc_gamma": 1 + f(h, sc=0.1),
         "lnc_beta": f(h, sc=0.1), "c0": f(b, h, sc=0.3),
         "h0": f(b, h, sc=0.3), "x_bias": f(b, 4 * h, sc=0.3)}
    if case == "far_from_zero":
        d["x_bias"] = d["x_bias"] + np.float32(12.0)
    if case == "masks":
        mk = ((rng.random((T, b, h)) < KEEP) / np.float32(KEEP)).astype(
            np.float32)
        (jm, js), (tm, ts) = (jnp.asarray(mk), None), (torch.from_numpy(mk),
                                                       None)
    else:
        (jm, js), (tm, ts) = _dropout_args("seed", b)
    keep = KEEP if ts is not None else 1.0
    names = ["xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
             "lnc_beta", "c0", "h0"]
    jhs, (jcT, jhT) = PF.fused_ln_lstm(
        *(jnp.asarray(d[n]) for n in names), 1.0, jm, js, keep, jnp.float32,
        jnp.asarray(d["x_bias"]))
    t_ = {k: torch.from_numpy(v) for k, v in d.items()}
    args = (*(t_[n] for n in names), 1.0, tm, ts, keep, t_["x_bias"])
    got = _ln_fwd_partition(*args)
    if case == "far_from_zero":      # the case is what it says
        pre = (t_["xs"][0] @ t_["wx"] + t_["h0"] @ t_["wh"]
               + t_["x_bias"]).view(b, 4, h)
        assert float(pre.mean(-1).min()) > 8 * float(pre.std(-1).max())
    for name, a, g in zip(("hs", "cT", "hT"), (jhs, jcT, jhT),
                          (got[0], got[2], got[3])):
        _close(a, g, f"{name} vs the JAX kernel")
    for name, r, g in zip(("hs", "cs", "cT", "hT"),
                          CF.ln_lstm_fwd_reference(*args), got):
        _close(r.numpy(), g, f"{name} vs ln_lstm_fwd_reference")


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
    # bfloat16 residuals are served; other storage and weight dtypes, or
    # weights of two dtypes, are refused on every device
    assert CF.fused_lstm_seq(
        *args, residual_dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="residual"):
        CF.fused_lstm_seq(*args, residual_dtype=torch.float16)
    bf = d["wh"].to(torch.bfloat16)
    for wx, wh in ((d["wx"], bf), (d["wx"].half(), d["wh"].half())):
        with pytest.raises(TypeError, match="wx/wh"):
            CF.fused_lstm(d["xs"], wx, d["b"], wh, d["c0"], d["h0"])


@pytest.mark.parametrize("entries", ["lstm_fwd_entries",
                                     "lstm_bwd_entries",
                                     "ln_lstm_fwd_entries",
                                     "ln_lstm_bwd_entries"])
def test_ab_entries_refuse_cpu_tensors(entries):
    """The A/B helpers of the LSTM's and the LayerNorm-LSTM's forward and
    backward C designs take CUDA tensors only: on CPU tensors they raise,
    and no plain version stands in."""
    cell = "layer_norm" if entries.startswith("ln_") else "lstm"
    d = {k: torch.from_numpy(v) for k, v in _inputs(cell).items()}
    res = torch.zeros((T, B, H))
    ln = (d["ln_gamma"], d["ln_beta"], d["lnc_gamma"], d["lnc_beta"]) \
        if cell == "layer_norm" else ()
    if entries == "ln_lstm_bwd_entries":
        args = (d["xs"], d["wx"], d["wh"], *ln, d["h0"], res, res, res)
    elif entries == "ln_lstm_fwd_entries":
        args = (d["xs"], d["wx"], d["wh"], *ln, d["c0"], d["h0"])
    elif entries == "lstm_fwd_entries":
        args = (d["xs"], d["wx"], d["b"], d["wh"], d["c0"], d["h0"])
    else:
        args = (d["xs"], d["wx"], d["b"], d["wh"], d["h0"], res, res, res)
    before = CF.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        getattr(CF, entries)(*args)
    assert CF.launch_counts() == before


def _lstm_jloss(names, jm, js, keep, wout, rd=jnp.float32):
    def jloss(*args):
        kw = dict(zip(names, args))
        hs, (cT, hT) = PF.fused_lstm(
            kw["xs"], kw["wx"], kw["b"], kw["wh"], kw["c0"], kw["h0"], 1.0,
            jm, js, keep, rd, kw.get("x_bias"))
        loss = jnp.sum(hs.astype(jnp.float32) * wout) + jnp.sum(cT) \
            + 0.5 * jnp.sum(hT)
        return loss, (hs, cT, hT)
    return jloss


@pytest.mark.parametrize("mode,xb,b", [
    ("none", False, B), ("none", True, B), ("masks", True, B),
    ("seed", False, B), ("seed", True, B), ("seed", True, 24)])
def test_lstm_matches_pallas(mode, xb, b):
    """``fused_lstm`` (the lstm decoder's kernel) forward and every
    gradient, from nonzero carries, against ``pallas_fused.fused_lstm``."""
    d = _inputs("lstm", b)
    if xb:
        d["x_bias"] = _inputs("layer_norm", b, seed=1, x_bias=True)["x_bias"]
    (jm, js), (tm, ts) = _dropout_args(mode, b)
    keep = KEEP if mode == "seed" else 1.0
    names = ["xs", "wx", "b", "wh", "c0", "h0"] + (["x_bias"] if xb else [])
    jloss = _lstm_jloss(names, jm, js, keep, jnp.asarray(d["w_out"]))
    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(d[n]) for n in names))
    p = _torch_leaves(d, names)
    hs, (cT, hT) = CF.fused_lstm(p["xs"], p["wx"], p["b"], p["wh"], p["c0"],
                                 p["h0"], 1.0, tm, ts, keep, None,
                                 p.get("x_bias"))
    ((hs * torch.from_numpy(d["w_out"])).sum() + cT.sum()
     + 0.5 * hT.sum()).backward()
    for name, a, t in zip(("hs", "cT", "hT"), jout, (hs, cT, hT)):
        _close(a, t, name)
    for name, g in zip(names, jg):
        _close(g, p[name].grad, f"d{name}")


BF_RTOL, BF_ATOL = 1e-2, 1e-3


def _bf_close(a, b, what, stats):
    """bfloat16-level agreement; records the gap and, for hs, the share
    of bitwise-equal elements."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    b = b.detach().float().numpy()
    assert a.shape == b.shape, what
    stats[what] = float(np.max(np.abs(a - b)))
    np.testing.assert_allclose(b, a, rtol=BF_RTOL, atol=BF_ATOL,
                               err_msg=what)


@pytest.mark.parametrize("kernel,wdt,rdt", [
    ("lstm_seq", "bf16", "bf16"), ("lstm", "bf16", "bf16"),
    ("layer_norm", "bf16", "bf16"), ("lstm", "f32", "bf16"),
    ("layer_norm", "bf16", "f32")])
def test_bf16_kernels_match_pallas(kernel, wdt, rdt):
    """Each kernel pair at bfloat16 weights and/or residuals (in-kernel
    dropout, x_bias where the kernel takes it, B over three Pallas tiles)
    against the Pallas kernel at the same settings."""
    b = 24
    d = _inputs("layer_norm" if kernel == "layer_norm" else "lstm", b,
                seed=3, x_bias=True)
    if kernel == "lstm":
        d["x_bias"] = _inputs("layer_norm", b, seed=4, x_bias=True)["x_bias"]
    (jm, js), (tm, ts) = _dropout_args("seed", b)
    wj = jnp.bfloat16 if wdt == "bf16" else jnp.float32
    wt = torch.bfloat16 if wdt == "bf16" else torch.float32
    rj = jnp.bfloat16 if rdt == "bf16" else jnp.float32
    rt = torch.bfloat16 if rdt == "bf16" else torch.float32
    if kernel == "lstm_seq":
        names = ["wx", "b", "wh"]
    elif kernel == "lstm":
        names = ["xs", "wx", "b", "wh", "c0", "h0", "x_bias"]
    else:
        names = ["xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
                 "lnc_beta", "c0", "h0", "x_bias"]
    jin = {n: jnp.asarray(v) for n, v in d.items()}
    jin["wx"], jin["wh"] = jin["wx"].astype(wj), jin["wh"].astype(wj)
    wout = jin["w_out"]

    if kernel == "lstm_seq":
        def jloss(wx, bb, wh):
            hs = PF.fused_lstm_seq(jin["xs"], wx, bb, wh, jin["c0"],
                                   jin["h0"], 1.0, jm, js, KEEP, rj)
            return jnp.sum(hs.astype(jnp.float32) * wout), (hs,)
    elif kernel == "lstm":
        jloss = _lstm_jloss(names, jm, js, KEEP, wout, rj)
    else:
        def jloss(*args):
            kw = dict(zip(names, args))
            hs, (cT, hT) = PF.fused_ln_lstm(
                kw["xs"], kw["wx"], kw["wh"], kw["ln_gamma"], kw["ln_beta"],
                kw["lnc_gamma"], kw["lnc_beta"], kw["c0"], kw["h0"], 1.0, jm,
                js, KEEP, rj, kw["x_bias"])
            loss = jnp.sum(hs.astype(jnp.float32) * wout) + jnp.sum(cT) \
                + 0.5 * jnp.sum(hT)
            return loss, (hs, cT, hT)

    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jin[n] for n in names))
    p = {n: torch.from_numpy(v) for n, v in d.items()}
    p["wx"], p["wh"] = p["wx"].to(wt), p["wh"].to(wt)
    for n in names:
        p[n].requires_grad_(True)
    if kernel == "lstm_seq":
        outs = (CF.fused_lstm_seq(p["xs"], p["wx"], p["b"], p["wh"], p["c0"],
                                  p["h0"], 1.0, tm, ts, KEEP, rt),)
        loss = (outs[0].float() * torch.from_numpy(d["w_out"])).sum()
    else:
        if kernel == "lstm":
            hs, (cT, hT) = CF.fused_lstm(
                p["xs"], p["wx"], p["b"], p["wh"], p["c0"], p["h0"], 1.0,
                tm, ts, KEEP, rt, p["x_bias"])
        else:
            hs, (cT, hT) = CF.fused_ln_lstm(
                *(p[n] for n in names[:-1]), 1.0, tm, ts, KEEP, rt,
                p["x_bias"])
        outs = (hs, cT, hT)
        loss = (hs.float() * torch.from_numpy(d["w_out"])).sum() \
            + cT.sum() + 0.5 * hT.sum()
    loss.backward()
    assert outs[0].dtype == rt
    stats = {}
    for name, a, t in zip(("hs", "cT", "hT"), jout, outs):
        _bf_close(a, t, name, stats)
    same = np.mean(np.asarray(jnp.asarray(jout[0], jnp.float32))
                   == outs[0].detach().float().numpy())
    for name, g in zip(names, jg):
        assert p[name].grad.dtype == p[name].dtype, name
        _bf_close(g, p[name].grad, f"d{name}", stats)
    print(f"\n{kernel} w={wdt} r={rdt}: hs bitwise {same:.4f}, largest "
          f"gaps {sorted(stats.items(), key=lambda kv: -kv[1])[:3]}")
    if rt == torch.bfloat16:
        assert same >= 0.9
