"""The weight pass's plain version and split-K plan (``cuda_fused``).

Every backward kernel of the port ends with the weight pass of
``csrc/weight_grad.cuh``: ``[dwx; dwh; db] = sum over k = t * B + b of
[x; h_{t-1}; 1]^T d_pre[k]`` over the ``d_pre`` scratch its recurrence
left, cut into slices by :func:`cuda_fused.weight_grad_plan` and added in
slice order. Here, on the CPU:

- :func:`cuda_fused.weight_grad_reference` (the one-shot product) against
  the step-by-step plain backwards' ``dwx``/``dwh``/``db``
  (``lstm_bwd_reference``, ``ln_lstm_bwd_reference``,
  ``lstm_seq_bwd_reference`` and ``cuda_lstm``'s ``lstm_seq``), fed the
  ``d_pre`` of every step those backwards computed;
- against the JAX package's ``fused_lstm``, ``fused_ln_lstm`` and
  ``fused_lstm_seq`` weight gradients, their Pallas kernels run in
  interpret mode as ``tests/test_pallas_fused.py`` runs them;
- the plan: it covers ``[0, K)`` once, in order, in whole k steps, reads
  no property of a device, keeps its scratch under its cap as ``K``
  grows, and gives the card several blocks per SM at the smoke's shapes;
- the reference summed over the plan's slices in slice order against the
  unsplit sum.

Tolerances: float32, the JAX kernels' own ``rtol=2e-5, atol=2e-6``; the
sums are taken in another order (per step, or per slice) and part only
by float32 rounding. bfloat16: both sides round the same operands to
bfloat16 and sum exact products in float32, so against the plain
backwards the float32 sums agree as at float32; where a side returns the
gradient rounded to bfloat16 (``lstm_bwd_reference``, the JAX VJP) a sum
near a rounding boundary may land one bfloat16 ulp (2**-8 relative) away:
``rtol=1e-2, atol=1e-3``, as ``tests/test_torch_fused.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.ops import pallas_fused as PF
from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.ops import cuda_lstm as CL

RTOL, ATOL = 2e-5, 2e-6
BF_RTOL, BF_ATOL = 1e-2, 1e-3
KEEP = 0.9
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(t, b, d, h, seed=0):
    """numpy inputs: xavier-ish weights, LN params near (1, 0), carries,
    the output cotangent ``w_out`` and the final carry's cotangents."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return {"xs": f(t, b, d), "wx": f(d, 4 * h, sc=0.4),
            "wh": f(h, 4 * h, sc=0.25), "b": f(4 * h, sc=0.1),
            "c0": f(b, h, sc=0.3), "h0": f(b, h, sc=0.3),
            "ln_gamma": 1 + f(4, h, sc=0.1), "ln_beta": f(4, h, sc=0.1),
            "lnc_gamma": 1 + f(h, sc=0.1), "lnc_beta": f(h, sc=0.1),
            "x_bias": f(b, 4 * h, sc=0.3), "w_out": f(t, b, h, sc=0.1),
            "dcT": f(b, h, sc=0.1), "dhT": f(b, h, sc=0.1)}


@pytest.fixture
def d_pres(monkeypatch):
    """Every ``d_pre`` the plain backwards hand to their products, in the
    order they compute them (time backwards)."""
    seen = []
    products = CF._BwdStep.products

    def record(self, x, h_prev, d_pre, want_dx):
        seen.append(d_pre.detach().clone())
        return products(self, x, h_prev, d_pre, want_dx)

    monkeypatch.setattr(CF._BwdStep, "products", record)
    return seen


def _stacked(seen):
    return torch.stack(seen[::-1])


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy()
    want = np.asarray(want.detach().float().numpy()
                      if isinstance(want, torch.Tensor) else
                      jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# (T, B, D, H): H off the 128-row tile, D = 0 (no x rows) among them
SHAPES = [(6, 5, 5, 8), (4, 3, 3, 24), (5, 4, 0, 8)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wdt", [F32, BF16])
@pytest.mark.parametrize("cell", ["lstm", "layer_norm", "lstm_seq"])
def test_reference_matches_step_by_step_backward(d_pres, cell, wdt, shape):
    t, b, d, h = shape
    n = {k: torch.from_numpy(v) for k, v in _inputs(t, b, d, h).items()}
    wx, wh = n["wx"].to(wdt), n["wh"].to(wdt)
    rd = wdt                       # residuals stored as the flagship does
    seed = torch.tensor(4321, dtype=torch.int32)
    if cell == "layer_norm":
        ln = (n["ln_gamma"], n["ln_beta"], n["lnc_gamma"], n["lnc_beta"])
        hs, cs, _, _ = CF.ln_lstm_fwd_reference(
            n["xs"], wx, wh, *ln, n["c0"], n["h0"], 1.0, None, seed, KEEP,
            n["x_bias"], rd)
        out = CF.ln_lstm_bwd_reference(
            n["xs"], wx, wh, *ln, n["h0"], hs, cs, n["w_out"].to(rd),
            n["dcT"], n["dhT"], 1.0, None, seed, KEEP, n["x_bias"],
            f32_weight_grads=True)
        want, ones = (out[2], out[3], None), 0
    else:
        full = cell == "lstm"
        hs, cs, _, _ = CF.lstm_fwd_reference(
            n["xs"], wx, n["b"], wh, n["c0"], n["h0"], 1.0, None, seed,
            KEEP, n["x_bias"] if full else None, rd)
        if full:
            out = CF.lstm_bwd_reference(
                n["xs"], wx, n["b"], wh, n["h0"], hs, cs, n["w_out"].to(rd),
                n["dcT"], n["dhT"], 1.0, None, seed, KEEP, n["x_bias"])
            want = (out[2], out[4], out[3])
        else:
            dwx, db, dwh = CF.lstm_seq_bwd_reference(
                n["xs"], wx, n["b"], wh, n["h0"], hs, cs, n["w_out"].to(rd),
                1.0, None, seed, KEEP)
            want = (dwx, dwh, db)
        ones = 1
    got = CF.weight_grad_reference(n["xs"], n["h0"], hs, _stacked(d_pres),
                                   d, h, ones, wdt)
    assert all(g.dtype == F32 for g in got if g is not None)
    for name, g, w in zip(("dwx", "dwh", "db"), got, want):
        if w is None:
            assert g is None
        elif w.dtype == BF16:       # summed in float32, then rounded
            _close(g.to(BF16), w, name, BF_RTOL, BF_ATOL)
        else:
            _close(g, w, name)


@pytest.mark.parametrize("h", [8, 24])
def test_reference_matches_hoisted_lstm_seq(h):
    """``cuda_lstm``'s backward (its ``dxp`` is the ``d_pre`` of the weight
    pass, no x rows, no row of ones): ``dwh`` of the plain version."""
    t, b = 6, 5
    rng = np.random.default_rng(h)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32))
    xp, wh, c0, h0 = f(t, b, 4 * h, sc=0.5), f(h, 4 * h, sc=0.25), \
        f(b, h, sc=0.3), f(b, h, sc=0.3)
    dhs, dcT, dhT = f(t, b, h, sc=0.1), f(b, h, sc=0.1), f(b, h, sc=0.1)
    hs, _, _, gates, cs = CL.lstm_seq_fwd(xp, wh, c0, h0)
    dxp, dwh, _, _ = CL.lstm_seq_bwd(wh, gates, cs, hs, h0, None, dhs, dcT,
                                     dhT)
    dwx, got, db = CF.weight_grad_reference(torch.zeros((t, b, 0)), h0, hs,
                                            dxp, 0, h, 0, F32)
    assert dwx.shape == (0, 4 * h) and db is None
    _close(got, dwh, "dwh")


def _jax_grads(kernel, d, wdt):
    """The JAX package's custom-VJP weight gradients (interpret-mode
    Pallas) of ``sum(hs * w_out) [+ sum(cT) + 0.5 sum(hT)]``, in-kernel
    dropout from a seed, bfloat16 residuals with bfloat16 weights."""
    wj = jnp.bfloat16 if wdt == BF16 else jnp.float32
    j = {k: jnp.asarray(v) for k, v in d.items()}
    js = jnp.int32(24680)
    w = {"wx": j["wx"].astype(wj), "wh": j["wh"].astype(wj)}

    if kernel == "lstm_seq":
        def loss(wx, wh, b):
            hs = PF.fused_lstm_seq(j["xs"], wx, b, wh, j["c0"], j["h0"], 1.0,
                                   None, js, KEEP, wj)
            return jnp.sum(hs.astype(jnp.float32) * j["w_out"])
        g = jax.grad(loss, argnums=(0, 1, 2))(w["wx"], w["wh"], j["b"])
    else:
        def loss(wx, wh, b):
            if kernel == "lstm":
                hs, (cT, hT) = PF.fused_lstm(
                    j["xs"], wx, b, wh, j["c0"], j["h0"], 1.0, None, js,
                    KEEP, wj, j["x_bias"])
            else:
                hs, (cT, hT) = PF.fused_ln_lstm(
                    j["xs"], wx, wh, j["ln_gamma"], j["ln_beta"],
                    j["lnc_gamma"], j["lnc_beta"], j["c0"], j["h0"], 1.0,
                    None, js, KEEP, wj, j["x_bias"])
            return (jnp.sum(hs.astype(jnp.float32) * j["w_out"])
                    + jnp.sum(cT) + 0.5 * jnp.sum(hT))
        argn = (0, 1, 2) if kernel == "lstm" else (0, 1)
        g = jax.grad(loss, argnums=argn)(w["wx"], w["wh"], j["b"])
    return g


@pytest.mark.parametrize("wdt", [F32, BF16])
@pytest.mark.parametrize("kernel", ["lstm_seq", "lstm", "layer_norm"])
def test_reference_matches_pallas(d_pres, kernel, wdt):
    """The same inputs through the JAX kernel's VJP and through the port's
    plain backward (autograd Function on the CPU); the ``d_pre`` the
    latter computed, through the reference, gives the JAX package's
    ``dwx``, ``dwh`` (in the weights' dtype) and ``db``."""
    t, b, d, h = 5, 4, 5, 24
    d_np = _inputs(t, b, d, h, seed=7)
    jg = _jax_grads(kernel, d_np, wdt)
    n = {k: torch.from_numpy(v) for k, v in d_np.items()}
    wx = n["wx"].to(wdt).requires_grad_(True)
    wh = n["wh"].to(wdt).requires_grad_(True)
    seed = torch.tensor(24680, dtype=torch.int32)
    if kernel == "lstm_seq":
        hs = CF.fused_lstm_seq(n["xs"], wx, n["b"], wh, n["c0"], n["h0"],
                               1.0, None, seed, KEEP, wdt)
        loss = (hs.float() * n["w_out"]).sum()
    else:
        if kernel == "lstm":
            hs, (cT, hT) = CF.fused_lstm(n["xs"], wx, n["b"], wh, n["c0"],
                                         n["h0"], 1.0, None, seed, KEEP,
                                         wdt, n["x_bias"])
        else:
            hs, (cT, hT) = CF.fused_ln_lstm(
                n["xs"], wx, wh, n["ln_gamma"], n["ln_beta"],
                n["lnc_gamma"], n["lnc_beta"], n["c0"], n["h0"], 1.0, None,
                seed, KEEP, wdt, n["x_bias"])
        loss = (hs.float() * n["w_out"]).sum() + cT.sum() + 0.5 * hT.sum()
    loss.backward()
    ones = 0 if kernel == "layer_norm" else 1
    dwx, dwh, db = CF.weight_grad_reference(n["xs"], n["h0"], hs.detach(),
                                            _stacked(d_pres), d, h, ones,
                                            wdt)
    tol = (RTOL, ATOL) if wdt == F32 else (BF_RTOL, BF_ATOL)
    _close(dwx.to(wdt), jg[0], "dwx", *tol)
    _close(dwh.to(wdt), jg[1], "dwh", *tol)
    if ones:
        _close(db, jg[2], "db", *tol)


# -- the plan ----------------------------------------------------------------

# (T, B, D, H, ones): the smoke's shapes (decoder, encoder, lstm_seq's
# dwh, at B=100 and bench.py's B=4096), odd ones, tiny K, empty K
PLAN_SHAPES = [(250, 100, 5, 512, 0), (250, 100, 5, 512, 1),
               (250, 100, 5, 256, 1), (250, 100, 0, 512, 0),
               (250, 4096, 5, 512, 0), (250, 4096, 5, 256, 1),
               (37, 53, 3, 40, 1), (19, 101, 5, 136, 0), (23, 47, 0, 136, 1),
               (1, 1, 5, 8, 1), (3, 7, 0, 16, 0), (0, 5, 5, 8, 1),
               (250, 8192, 5, 512, 1), (6, 5, 133, 512, 1)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_k_once_in_order(shape, dtype):
    t, b, d, h, ones = shape
    k = t * b
    p = CF.weight_grad_plan(t, b, d, h, ones, dtype)
    assert 1 <= p.slices <= CF.WG_MAX_SLICES
    assert p.kslice >= CF.WG_CHUNK[dtype] and \
        p.kslice % CF.WG_CHUNK[dtype] == 0
    bounds = p.bounds(k)
    assert len(bounds) == p.slices
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0                          # in order, no gap
    if k:
        assert all(lo < hi for lo, hi in bounds)     # none empty
    else:
        assert p.slices == 1


# the card's SMs: the plan may not read them, but it must fill them
H100_SMS = 132


@pytest.mark.parametrize("shape", PLAN_SHAPES[:6])
def test_plan_gives_two_blocks_per_sm_at_the_smoke_shapes(shape):
    t, b, d, h, ones = shape
    for dtype in (F32, BF16):
        p = CF.weight_grad_plan(t, b, d, h, ones, dtype)
        assert CF.weight_grad_tiles(d, h, ones, dtype) * p.slices >= \
            2 * H100_SMS


def test_plan_reads_no_device_property(monkeypatch):
    want = [CF.weight_grad_plan(*s, dt) for s in PLAN_SHAPES
            for dt in (F32, BF16)]

    def boom(*a, **k):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "get_device_capability", "get_device_name",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, boom)
    assert [CF.weight_grad_plan(*s, dt) for s in PLAN_SHAPES
            for dt in (F32, BF16)] == want


@pytest.mark.parametrize("d,h,ones", [(5, 512, 0), (5, 256, 1), (0, 40, 0)])
def test_plan_scratch_stays_under_its_cap(d, h, ones):
    r = d + h + ones
    cap = CF.WG_MAX_SLICES * r * 4 * h
    for b in (1, 100, 4096, 65536, 1 << 22):
        p = CF.weight_grad_plan(250, b, d, h, ones, BF16)
        assert p.slices * r * 4 * h <= cap
        # and never more than a WG_SCRATCH_SHARE-th of d_pre's floats,
        # once K holds a slice at all
        if 250 * b >= CF.WG_SCRATCH_SHARE * r:
            assert p.slices * r * CF.WG_SCRATCH_SHARE <= 250 * b


@pytest.mark.parametrize("d,h,ones,dtype,want", [
    (5, 512, 0, BF16, 16 * 5), (5, 512, 1, BF16, 16 * 5),
    (0, 512, 1, BF16, 16 * 5), (0, 512, 0, BF16, 16 * 4),
    (128, 136, 1, BF16, 5 * 3), (133, 264, 1, BF16, 9 * 5),
    (5, 512, 1, F32, 16 * 4), (7, 136, 1, F32, 5 * 2),
    (8, 136, 1, F32, 5 * 3), (0, 40, 0, F32, 2), (133, 264, 1, F32, 9 * 5)])
def test_weight_grad_tiles_match_the_kernels_grid(d, h, ones, dtype, want):
    """The tiles the plan counts are the kernels' grid (``wg_row_tiles``):
    bfloat16 gives the x rows and ``db`` tiles of their own; float32 folds
    up to WG_FOLD extra rows into the first row tile."""
    assert CF.weight_grad_tiles(d, h, ones, dtype) == want


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError, match="weight dtype"):
        CF.weight_grad_plan(5, 4, 5, 8, 1, torch.float16)


@pytest.mark.parametrize("t,b,d,h,ones,wdt", [
    (40, 50, 3, 8, 1, F32), (40, 50, 3, 8, 1, BF16), (7, 300, 0, 24, 0, F32),
    (7, 300, 5, 24, 1, BF16)])
def test_reference_summed_over_slices_matches_unsplit(t, b, d, h, ones, wdt):
    rng = np.random.default_rng(t * b + h)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32))
    xs, h0, d_pre = f(t, b, d), f(b, h, sc=0.3), f(t, b, 4 * h, sc=0.01)
    hs = f(t, b, h, sc=0.3).to(wdt)
    p = CF.weight_grad_plan(t, b, d, h, ones, wdt)
    assert p.slices > 1
    whole = CF.weight_grad_reference(xs, h0, hs, d_pre, d, h, ones, wdt)
    total = None
    for rng_k in p.bounds(t * b):            # slice order 0 ... S-1
        part = CF.weight_grad_reference(xs, h0, hs, d_pre, d, h, ones, wdt,
                                        k_range=rng_k)
        total = part if total is None else tuple(
            None if a is None else a + q for a, q in zip(total, part))
    for name, a, w in zip(("dwx", "dwh", "db"), total, whole):
        if w is None:
            assert a is None
        else:
            _close(a, w, name)


def test_weight_grad_entries_refuse_cpu_tensors():
    """The A/B helper drives the C entry on CUDA tensors only; no plain
    version stands in, and no launch is counted."""
    t, b, d, h = 3, 2, 5, 8
    before = CF.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        CF.weight_grad_entries(torch.zeros((t, b, d)), torch.zeros((b, h)),
                               torch.zeros((t, b, h)),
                               torch.zeros((t, b, 4 * h)), 1, F32)
    assert CF.launch_counts() == before
