"""The ``hyper`` model family of the port against the JAX package.

The HyperLSTM cell, the plain forward and step-by-step backward behind
``fused_hyper_lstm`` (``sketch_rnn_tpu_torch/ops/cuda_fused.py``: what a
CPU tensor takes, and what the CUDA kernels are held against on the
card), the ``run_rnn(fused=True)`` dispatch, the whole ``hyper`` model
(loss, gradients, 3 train steps, train-state interchange) and serving
through the plain chunk program. The same numpy-made inputs go through
both packages; the JAX side runs as its own tests run it on the CPU (the
Pallas kernel in interpret mode).

Tolerances. The cell step: 1e-5. The kernel's plain versions against
``pallas_fused.fused_hyper_lstm``: the Pallas tests' own ``rtol=2e-5,
atol=2e-6`` at float32 (both sides compute the same per-gate block
projections in the same order, so they part by float32 summation order
only); ``rtol=1e-2, atol=1e-3`` at bfloat16 weights and residuals (one
bfloat16 ulp is 2**-8 relative; both sides round the same values at the
same places). The shapes stay at or below T=6, B=6, H=16: the
interpret-mode Pallas HyperLSTM kernel is slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.ops import cells as jcells
from sketch_rnn_tpu.ops import pallas_fused as PF
from sketch_rnn_tpu.ops import rnn as jrnn
from sketch_rnn_tpu.serve.endpoints import serve_requests as j_serve_requests
from sketch_rnn_tpu.serve.engine import Request as JRequest
from sketch_rnn_tpu.serve.engine import ServeEngine as JServeEngine
from sketch_rnn_tpu.train.state import TrainState as JTrainState
from sketch_rnn_tpu.train.state import make_optimizer
from sketch_rnn_tpu.train.step import _make_single_step_core
from sketch_rnn_tpu_torch import HParams, convert
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import cells, cuda_decode
from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.ops import rnn
from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
from sketch_rnn_tpu_torch.train.state import make_train_state, tree_items
from sketch_rnn_tpu_torch.train.step import make_train_step
from sketch_rnn_tpu_torch.utils import prng

T, B, D, H = 5, 6, 5, 16
KEEP = 0.9
RTOL, ATOL = 2e-5, 2e-6
BF_RTOL, BF_ATOL = 1e-2, 1e-3
# (HH, e): an auxiliary LSTM wider than the main one, and a narrower one
SIZES = {"wide": (32, 4), "narrow": (8, 8)}
W_NAMES = CF.HyperWeights._fields
CARRIES = ("c0", "h0", "hc0", "hh0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    the torch side from competing for cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(hh, e, b=B, seed=0, biases=False, t=T):
    """Weights and inputs from numpy; every projection is dense (the
    cell's zero/constant inits are perturbed) so every gradient is live."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    d = {"xs": f(t, b, D), "wx": f(D, 4 * H, sc=0.4), "b": f(4 * H, sc=0.1),
         "wh": f(H, 4 * H, sc=0.25), "wxh_x": f(D, 4 * hh, sc=0.4),
         "wxh_h": f(H, 4 * hh, sc=0.25), "bh": f(4 * hh, sc=0.1),
         "whh": f(hh, 4 * hh, sc=0.25), "w_hz_x": f(hh, 4 * e, sc=0.2),
         "b_hz_x": 1 + f(4 * e, sc=0.1), "w_hz_h": f(hh, 4 * e, sc=0.2),
         "b_hz_h": 1 + f(4 * e, sc=0.1), "w_hz_b": f(hh, 4 * e, sc=0.2),
         "zd_x": 0.1 / e + f(4, e, H, sc=0.05),
         "zd_h": 0.1 / e + f(4, e, H, sc=0.05), "zd_b": f(4, e, H, sc=0.05),
         "ln_gamma": 1 + f(4, H, sc=0.1), "ln_beta": f(4, H, sc=0.1),
         "lnc_gamma": 1 + f(H, sc=0.1), "lnc_beta": f(H, sc=0.1),
         "c0": f(b, H, sc=0.3), "h0": f(b, H, sc=0.3),
         "hc0": f(b, hh, sc=0.3), "hh0": f(b, hh, sc=0.3),
         "w_out": f(t, b, H, sc=0.1)}
    if biases:
        d["x_bias"] = f(b, 4 * H, sc=0.3)
        d["x_bias_hyper"] = f(b, 4 * hh, sc=0.3)
    return d


def _dropout_args(mode, b, t=T):
    """(masks, seed) for the JAX call and for the port's."""
    if mode == "masks":
        m = np.random.default_rng(9).random((t, b, H)) < KEEP
        m = (m / np.float32(KEEP)).astype(np.float32)
        return (jnp.asarray(m), None), (torch.from_numpy(m), None)
    if mode == "seed":
        return ((None, jnp.int32(123457)),
                (None, torch.tensor(123457, dtype=torch.int32)))
    return (None, None), (None, None)


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    a = np.asarray(a, dtype=np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, dtype=np.float32)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)


CARRY_LOSS = (1.0, 0.5, 0.3, 0.7)     # weights of cT, hT, hcT, hhT


def _jax_run(d, names, jm, js, keep, wdt=jnp.float32, rdt=jnp.float32):
    """Loss, outputs and gradients w.r.t. ``names`` of the Pallas kernel."""
    wout = jnp.asarray(d["w_out"])
    cw = CARRY_LOSS

    def jloss(*args):
        kw = dict(zip(names, args))
        cast = lambda n: kw[n].astype(wdt) if n in CF.HYPER_MATRICES \
            else kw[n]
        hs, ((cT, hT), (hcT, hhT)) = PF.fused_hyper_lstm(
            kw["xs"], *(cast(n) for n in W_NAMES),
            *(kw[n] for n in CARRIES), 1.0, jm, js, keep, rdt,
            kw.get("x_bias"), kw.get("x_bias_hyper"))
        fin = (cT, hT, hcT, hhT)
        loss = jnp.sum(hs.astype(jnp.float32) * wout) + sum(
            w * jnp.sum(x) for w, x in zip(cw, fin))
        return loss, (hs,) + fin

    (_, out), grads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(
        *(jnp.asarray(d[n]) for n in names))
    return out, dict(zip(names, grads))


def _torch_run(d, names, tm, ts, keep, wdt=None, rdt=None):
    p = {k: torch.from_numpy(d[k]).requires_grad_(True) for k in names}
    cast = lambda n: p[n].to(wdt) if wdt is not None \
        and n in CF.HYPER_MATRICES else p[n]
    hs, ((cT, hT), (hcT, hhT)) = CF.fused_hyper_lstm(
        p["xs"], *(cast(n) for n in W_NAMES), *(p[n] for n in CARRIES),
        1.0, tm, ts, keep, rdt, p.get("x_bias"), p.get("x_bias_hyper"))
    fin = (cT, hT, hcT, hhT)
    loss = (hs.float() * torch.from_numpy(d["w_out"])).sum() + sum(
        w * x.sum() for w, x in zip(CARRY_LOSS, fin))
    loss.backward()
    return (hs,) + fin, {n: p[n].grad for n in names}


def _names(biases):
    return ["xs", *W_NAMES, *CARRIES] + (
        ["x_bias", "x_bias_hyper"] if biases else [])


OUT_NAMES = ("hs", "cT", "hT", "hcT", "hhT")


@pytest.mark.parametrize("mode,biases,size", [
    ("none", False, "wide"), ("none", True, "narrow"),
    ("masks", True, "wide"), ("seed", False, "narrow"),
    ("seed", True, "wide")])
def test_fused_hyper_lstm_matches_pallas(mode, biases, size):
    """Forward (hs, four final carries) and all gradients (xs, 12 weights,
    4 biases, 4 LN, 4 carries, both biases) of the autograd Function's
    CPU path against the Pallas kernel pair."""
    hh, e = SIZES[size]
    d = _inputs(hh, e, biases=biases)
    (jm, js), (tm, ts) = _dropout_args(mode, B)
    keep = KEEP if mode == "seed" else 1.0
    names = _names(biases)
    jout, jg = _jax_run(d, names, jm, js, keep)
    tout, tg = _torch_run(d, names, tm, ts, keep)
    for n, a, b in zip(OUT_NAMES, jout, tout):
        _close(a, b, n)
    for n in names:
        _close(jg[n], tg[n], f"d{n}")


def test_fused_hyper_lstm_over_several_pallas_tiles(monkeypatch):
    """B=6 over three Pallas batch tiles of 2: the in-kernel dropout
    counter must not depend on the tiling, and the per-tile gradient
    accumulators must add up to the port's sums over the whole batch."""
    monkeypatch.setattr(PF, "_HYPER_MAX_TILE", 2)
    assert PF._hyper_batch_tile(B) == 2
    hh, e = SIZES["wide"]
    d = _inputs(hh, e, biases=True, seed=3)
    (jm, js), (tm, ts) = _dropout_args("seed", B)
    names = _names(True)
    jout, jg = _jax_run(d, names, jm, js, KEEP)
    tout, tg = _torch_run(d, names, tm, ts, KEEP)
    for n, a, b in zip(OUT_NAMES, jout, tout):
        _close(a, b, n)
    for n in names:
        _close(jg[n], tg[n], f"d{n}")


@pytest.mark.parametrize("size", ["wide", "narrow"])
def test_fused_hyper_lstm_bf16_matches_pallas(size):
    """bfloat16 matrices and residuals: hs comes back bfloat16 and mostly
    bitwise equal, the matrices' gradients bfloat16, everything within a
    bfloat16 ulp of the Pallas kernels' results."""
    hh, e = SIZES[size]
    d = _inputs(hh, e, biases=True, seed=1)
    (jm, js), (tm, ts) = _dropout_args("seed", B)
    names = _names(True)
    jout, jg = _jax_run(d, names, jm, js, KEEP, jnp.bfloat16, jnp.bfloat16)
    tout, tg = _torch_run(d, names, tm, ts, KEEP, torch.bfloat16,
                          torch.bfloat16)
    assert tout[0].dtype == torch.bfloat16 and jout[0].dtype == jnp.bfloat16
    same = np.mean(np.asarray(jout[0], np.float32)
                   == tout[0].detach().float().numpy())
    assert same >= 0.9, f"only {same:.2%} of the bfloat16 hs are bitwise"
    for n, a, b in zip(OUT_NAMES, jout, tout):
        _close(a, b, n, BF_RTOL, BF_ATOL)
    for n in names:
        _close(jg[n], tg[n], f"d{n}", BF_RTOL, BF_ATOL)


def test_plain_forward_residuals_match_pallas_forward():
    """What the forward saves for the backward: the pre-step cell states
    ``cs``/``hycs`` and the post-step ``hyhs``, against the Pallas forward
    call's residuals."""
    hh, e = SIZES["wide"]
    d = _inputs(hh, e, biases=True, seed=2)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    jhs, _, (jcs, jhycs, jhyhs) = PF._hyper_fwd_call(
        j["xs"], *(j[n] for n in W_NAMES), *(j[n] for n in CARRIES), 1.0,
        None, jnp.int32(5), KEEP, jnp.float32, j["x_bias"],
        j["x_bias_hyper"])
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    hs, cs, hycs, hyhs, *_ = CF.hyper_lstm_fwd_reference(
        t["xs"], CF.HyperWeights(*(t[n] for n in W_NAMES)),
        *(t[n] for n in CARRIES), 1.0, None,
        torch.tensor(5, dtype=torch.int32), KEEP, t["x_bias"],
        t["x_bias_hyper"])
    for n, a, b in (("hs", jhs, hs), ("cs", jcs, cs), ("hycs", jhycs, hycs),
                    ("hyhs", jhyhs, hyhs)):
        _close(a, b, n)
    assert torch.equal(cs[0], t["c0"]) and torch.equal(hycs[0], t["hc0"])


@pytest.mark.parametrize("mode,biases", [("none", False), ("seed", True)])
def test_plain_backward_matches_autograd_of_plain_forward(mode, biases):
    """The step-by-step backward against torch.autograd through the plain
    forward (float64, so only the algebra is compared)."""
    hh, e = SIZES["wide"]
    d = _inputs(hh, e, biases=biases)
    seed = torch.tensor(77, dtype=torch.int32) if mode == "seed" else None
    keep = KEEP if seed is not None else 1.0
    p = {k: torch.from_numpy(v).double().requires_grad_(True)
         for k, v in d.items()}
    dhs = p.pop("w_out").detach()
    w = CF.HyperWeights(*(p[n] for n in W_NAMES))
    xb, xbh = p.get("x_bias"), p.get("x_bias_hyper")
    hs, cs, hycs, hyhs, cT, hT, hcT, hhT = CF.hyper_lstm_fwd_reference(
        p["xs"], w, *(p[n] for n in CARRIES), 1.0, None, seed, keep, xb, xbh)
    cw = CARRY_LOSS
    ((hs * dhs).sum() + sum(a * x.sum() for a, x in zip(
        cw, (cT, hT, hcT, hhT)))).backward()
    det = {k: v.detach() for k, v in p.items()}
    dxs, dxb, dxbh, dw, dc0, dh0, dhc0, dhh0 = CF.hyper_lstm_bwd_reference(
        det["xs"], CF.HyperWeights(*(det[n] for n in W_NAMES)), det["h0"],
        det["hh0"], hs.detach(), cs.detach(), hycs.detach(), hyhs.detach(),
        dhs, *(torch.full_like(x, a) for a, x in zip(cw, (cT, hT, hcT, hhT))),
        1.0, None, seed, keep, det.get("x_bias"), det.get("x_bias_hyper"))
    got = {"xs": dxs, "c0": dc0, "h0": dh0, "hc0": dhc0, "hh0": dhh0,
           **dw._asdict()}
    if biases:
        got.update(x_bias=dxb, x_bias_hyper=dxbh)
    else:
        assert dxb is None and dxbh is None
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), p[n].grad.numpy(), rtol=1e-9,
                                   atol=1e-11, err_msg=n)


# -- the cell ---------------------------------------------------------------


def _cell_pair(hh, e, d_in=9, perturb=True):
    jcell = jcells.make_cell("hyper", H, hyper_size=hh, hyper_embed_size=e)
    cell = cells.make_cell("hyper", H, hyper_size=hh, hyper_embed_size=e)
    jp = jcell.init_params(jax.random.key(1), d_in)
    if perturb:     # as tests/test_pallas_fused.py: every gradient live
        for i, k in enumerate(("w_hz_x", "w_hz_h", "w_zd_x", "w_zd_h",
                               "w_zd_b")):
            jp[k] = jp[k] + 0.05 * jax.random.normal(
                jax.random.key(100 + i), jp[k].shape)
    return jcell, cell, jp, convert.params_from_jax(jax.device_get(jp),
                                                    device="cpu")


@pytest.mark.parametrize("size", ["wide", "narrow"])
def test_hyper_cell_init_params(size):
    """Shapes, and the constant inits exactly: embeddings weight 0 / bias
    1, scale blocks ``0.1 / e`` (dynamic-bias blocks 0), LN (1, 0)."""
    hh, e = SIZES[size]
    jcell, cell, jp, _ = _cell_pair(hh, e, perturb=False)
    p = cell.init_params(torch.Generator().manual_seed(0), 9)
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    mine = dict(jax.tree_util.tree_flatten_with_path(
        convert.params_to_jax(p))[0])
    assert sorted(map(str, flat)) == sorted(map(str, mine))
    for path, a in flat.items():
        assert mine[path].shape == a.shape, path
        assert mine[path].dtype == np.float32, path
    for k in ("b", "w_hz_x", "b_hz_x", "w_hz_h", "b_hz_h", "w_zd_x",
              "w_zd_h", "w_zd_b", "ln_gamma", "ln_beta", "lnc_gamma",
              "lnc_beta"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]), k)
    np.testing.assert_array_equal(p["hyper"]["b"].numpy(),
                                  np.asarray(jp["hyper"]["b"]))
    assert float(p["w_zd_x"][0, 0, 0]) == np.float32(0.1 / e)
    assert cell.carry_size == jcell.carry_size == 2 * H + 2 * hh


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("size", ["wide", "narrow"])
def test_hyper_cell_step(size, use_mask):
    hh, e = SIZES[size]
    jcell, cell, jp, p = _cell_pair(hh, e)
    rng = np.random.default_rng(2)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, c, h, hc, hyh = f(4, 9), f(4, H), f(4, H), f(4, hh), f(4, hh)
    m = ((rng.random((4, H)) < KEEP) / np.float32(KEEP)).astype(np.float32) \
        if use_mask else None
    jcarry, jout = jcell(jp, ((c, h), (hc, hyh)), x,
                         rdrop_mask=None if m is None else jnp.asarray(m))
    t = torch.from_numpy
    tcarry, tout = cell(p, ((t(c), t(h)), (t(hc), t(hyh))), t(x),
                        None if m is None else t(m))
    for a, b in zip(jax.tree_util.tree_leaves(jcarry),
                    cell.carry_leaves(tcarry)):
        _close(a, b, "carry", 1e-5, 1e-5)
    _close(jout, tout, "h", 1e-5, 1e-5)
    # the hoisted-input path is the same step
    tcarry2, _ = cell.step_pre(p, ((t(c), t(h)), (t(hc), t(hyh))),
                               cell.precompute_inputs(p, t(x)),
                               None if m is None else t(m))
    for a, b in zip(cell.carry_leaves(tcarry), cell.carry_leaves(tcarry2)):
        assert torch.equal(a, b)


def test_hyper_carry_layout():
    """``unflatten_carry`` cuts (c, h, hc, hh) in tree-leaf order, as the
    JAX cell; leaves and nesting round-trip; ``final_hidden`` finds h."""
    hh, e = SIZES["wide"]
    jcell, cell, _, _ = _cell_pair(hh, e, perturb=False)
    flat = np.random.default_rng(0).normal(
        size=(3, cell.carry_size)).astype(np.float32)
    jc = jcell.unflatten_carry(jnp.asarray(flat))
    tc = cell.unflatten_carry(torch.from_numpy(flat))
    leaves = cell.carry_leaves(tc)
    for a, b in zip(jax.tree_util.tree_leaves(jc), leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert torch.equal(torch.cat(leaves, -1), torch.from_numpy(flat))
    back = cell.carry_from_leaves(leaves)
    assert back[0][1] is leaves[1] and back[1][0] is leaves[2]
    assert rnn.final_hidden(cell, tc) is leaves[1]
    assert np.array_equal(np.asarray(jrnn.final_hidden(jcell, jc)),
                          leaves[1].numpy())
    zero = cell.initial_carry(2, device="cpu")
    assert [tuple(x.shape) for x in cell.carry_leaves(zero)] == [
        (2, H), (2, H), (2, hh), (2, hh)]
    lstm = cells.make_cell("lstm", H)
    assert rnn.final_hidden(lstm, ("c", "h")) == "h"


# -- the dispatch -----------------------------------------------------------


def _rnn_inputs(hh, e, d_in, n_extra, seed=4):
    jcell, cell, jp, p = _cell_pair(hh, e, d_in=d_in + n_extra)
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    xs = f(T, B, d_in)
    extra = f(B, n_extra) if n_extra else None
    carry = ((f(B, H, sc=0.3), f(B, H, sc=0.3)),
             (f(B, hh, sc=0.3), f(B, hh, sc=0.3)))
    return jcell, cell, jp, p, xs, extra, carry


def _tcarry(carry):
    (c, h), (hc, hh) = carry
    t = torch.from_numpy
    return ((t(c), t(h)), (t(hc), t(hh)))


def test_run_rnn_fused_hyper_decoder_with_x_extra():
    """The decoder's dispatch: ``x_extra`` folded into the two per-example
    biases, a nonzero nested carry, in-kernel dropout from a key; outputs
    and the gradients of every parameter against the JAX dispatch."""
    hh, e = SIZES["wide"]
    jcell, cell, jp, p, xs, extra, carry = _rnn_inputs(hh, e, 5, 4)
    wout = np.random.default_rng(8).normal(size=(T, B, H)).astype(np.float32)

    def jloss(params):
        fin, hs = jrnn.run_rnn(jcell, params, jnp.asarray(xs), carry,
                               rdrop_gen=(jax.random.key(3), KEEP),
                               fused=True, x_extra=jnp.asarray(extra))
        return (jnp.sum(hs * wout) + sum(
            0.3 * jnp.sum(x) for x in jax.tree_util.tree_leaves(fin)),
            (fin, hs))

    (_, (jfin, jhs)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [x.requires_grad_(True)
              for x in jax.tree_util.tree_leaves(p)]
    fin, hs = rnn.run_rnn(cell, p, torch.from_numpy(xs), _tcarry(carry),
                          rdrop_gen=(prng.key(3), KEEP), fused=True,
                          x_extra=torch.from_numpy(extra))
    loss = (hs * torch.from_numpy(wout)).sum() + sum(
        0.3 * x.sum() for x in cell.carry_leaves(fin))
    tg = torch.autograd.grad(loss, leaves)
    _close(jhs, hs, "hs")
    for a, b in zip(jax.tree_util.tree_leaves(jfin), cell.carry_leaves(fin)):
        _close(a, b, "final carry")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        _close(a, b, f"grad {path}")


def test_run_rnn_fused_hyper_encoder_reversed():
    """``enc_model=hyper``: no ``x_extra``, zero carries, ``need_final=
    False`` (the final carry goes unused), a reversed pass."""
    hh, e = SIZES["narrow"]
    jcell, cell, jp, p, xs, _, _ = _rnn_inputs(hh, e, 5, 0)
    _, jhs = jrnn.run_rnn(jcell, jp, jnp.asarray(xs), reverse=True,
                          fused=True, need_final=False)
    _, hs = rnn.run_rnn(cell, p, torch.from_numpy(xs), reverse=True,
                        fused=True, need_final=False)
    _close(jhs, hs, "hs")


@pytest.mark.parametrize("use_mask", [False, True])
def test_run_rnn_plain_loop_on_nested_carries(use_mask):
    """The plain path (serving's) on the nested carry, with ``x_extra``
    broadcast and concatenated, against the JAX scan; and the fused path's
    plain version against the port's own plain loop."""
    hh, e = SIZES["wide"]
    jcell, cell, jp, p, xs, extra, carry = _rnn_inputs(hh, e, 5, 3)
    m = None
    if use_mask:
        m = (np.random.default_rng(1).random((T, B, H)) < KEEP) \
            / np.float32(KEEP)
        m = m.astype(np.float32)
    jfin, jhs = jrnn.run_rnn(jcell, jp, jnp.asarray(xs), carry,
                             rdrop_masks=None if m is None
                             else jnp.asarray(m), x_extra=jnp.asarray(extra))
    kw = dict(rdrop_masks=None if m is None else torch.from_numpy(m),
              x_extra=torch.from_numpy(extra))
    fin, hs = rnn.run_rnn(cell, p, torch.from_numpy(xs), _tcarry(carry),
                          **kw)
    ffin, fhs = rnn.run_rnn(cell, p, torch.from_numpy(xs), _tcarry(carry),
                            fused=True, **kw)
    _close(jhs, hs, "hs", 1e-5, 1e-5)
    _close(hs, fhs, "fused vs loop", 1e-5, 1e-5)
    for a, b, c in zip(jax.tree_util.tree_leaves(jfin),
                       cell.carry_leaves(fin), cell.carry_leaves(ffin)):
        _close(a, b, "final carry", 1e-5, 1e-5)
        _close(b, c, "fused final carry", 1e-5, 1e-5)


# -- the whole model --------------------------------------------------------

# the hyper preset (conditional=true, dec_model=hyper) at tiny widths, with
# the fused kernels as the port trains it
TINY = dict(batch_size=4, max_seq_len=6, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, conditional=True, dec_model="hyper",
            hyper_rnn_size=8, hyper_embed_size=4, fused_rnn=True)
PARAM_ATOL = 2e-5


def _models(**over):
    kw = dict(TINY, **over)
    jh, th = JHParams(**kw), HParams(**kw)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jp = jm.init_params(jax.random.key(5))
    # the hyper cell's zero/constant-init projections perturbed, so every
    # gradient is live from the first step
    for cell_name in ("dec", "enc_fwd", "enc_bwd"):
        cp = jp.get(cell_name, {})
        for i, k in enumerate(("w_hz_x", "w_hz_h", "w_zd_x", "w_zd_h",
                               "w_zd_b")):
            if k in cp:
                cp[k] = cp[k] + 0.05 * jax.random.normal(
                    jax.random.key(200 + i), cp[k].shape)
    return jh, th, jm, tm, jp, convert.params_from_jax(
        jax.device_get(jp), "cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _tree_close(a, b, atol, rtol=0.0, what=""):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb)
    for (path, x), y in zip(fa, fb):
        np.testing.assert_allclose(_np(y), np.asarray(x), rtol=rtol,
                                   atol=atol, err_msg=f"{what}{path}")


def _loss_pair(jh, jm, tm, jp, tp, train):
    batch = jloader.synthetic_loader(jh, num=24, seed=0)[0].random_batch()

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(11), 0.37, train=train)

    (_, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    flat = [x.requires_grad_(True) for x in jax.tree_util.tree_leaves(tp)]
    ttot, tmet = tm.loss(
        tp, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        prng.key(11), 0.37, train=train)
    return jmet, jg, tmet, torch.autograd.grad(ttot, flat, allow_unused=True)


def test_hyper_model_loss_and_gradients_match_jax():
    """``SketchRNN.loss`` of the hyper preset at ``fused_rnn=true`` in
    training mode (dropout seeds drawn from the step key in both
    packages): every metric and every parameter's gradient. Held at the
    training slice's ``rtol=1e-5, atol=1e-6``."""
    jh, th, jm, tm, jp, tp = _models()
    assert tm.dec.carry_size == 2 * 16 + 2 * 8
    assert tp["dec_init_w"].shape == (6, 48)
    jmet, jg, tmet, tg = _loss_pair(jh, jm, tm, jp, tp, True)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert all(g is not None for g in tg)
    _tree_close(jg, list(tg), atol=1e-6, rtol=1e-5, what="grad ")


def test_hyper_encoder_model_loss_matches_jax():
    """``enc_model=hyper`` (both encoder directions through
    ``fused_hyper_lstm``, final states picked from ``hs``) with the lstm
    decoder: the evaluation loss."""
    jh, th, jm, tm, jp, tp = _models(enc_model="hyper", dec_model="lstm")
    jmet, _, tmet, _ = _loss_pair(jh, jm, tm, jp, tp, False)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_three_hyper_train_steps_match_jax():
    """3 steps of ``make_train_step`` against the jitted JAX step core, as
    ``test_torch_train.py`` holds the other decoders: metrics at
    ``rtol=1e-5, atol=1e-6``, parameters and Adam moments at 2e-5."""
    jh, th, jm, tm, jp, tp = _models()
    loader, _ = jloader.synthetic_loader(jh, num=24, seed=1)
    batches = [loader.random_batch() for _ in range(3)]
    tx = make_optimizer(jh)
    jstep = jax.jit(_make_single_step_core(jm, jh, None, tx))
    jstate = JTrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    step = make_train_step(tm, th, device="cpu")
    state = make_train_state(tp)
    for s, b in enumerate(batches):
        jstate, jmet = jstep(jstate,
                             {n: jnp.asarray(v) for n, v in b.items()},
                             jax.random.fold_in(jax.random.key(7), s))
        state, met = step(state, b, prng.fold_in(prng.key(7), s))
        for k in jmet:
            np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert state.step == int(jstate.step) == 3
    _tree_close(jax.device_get(jstate.params),
                convert.params_to_jax(state.params), atol=PARAM_ATOL,
                what="params ")
    jt = convert.train_state_to_jax(state)
    _tree_close(jax.device_get(jstate.opt_state), jt[1], atol=PARAM_ATOL,
                rtol=1e-4, what="opt ")


def test_hyper_tree_and_train_state_round_trip_bitwise():
    """``convert`` carries the nested ``dec.hyper.*`` tree and its Adam
    moments across and back bit for bit."""
    jh, th, jm, tm, jp, tp = _models()
    host = jax.device_get(jp)
    assert set(tp["dec"]["hyper"]) == {"wx", "wh", "b"}
    back = convert.params_to_jax(tp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(host)[0],
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b), path
    tx = make_optimizer(jh)
    opt = tx.init(jp)
    # moments with history: any distinct values will do
    opt = jax.tree_util.tree_map(
        lambda x: x + 0.25 if x.dtype == jnp.float32 else x + 1, opt)
    jstate = jax.device_get(JTrainState(jp, opt, jnp.asarray(7, jnp.int32)))
    tstate = convert.train_state_from_jax(jstate, device="cpu")
    assert tstate.step == 7
    assert torch.equal(tstate.opt_state.adam.mu["dec"]["hyper"]["wh"],
                       tp["dec"]["hyper"]["wh"] * 0 + 0.25)
    again = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jstate),
        jax.tree_util.tree_leaves(convert.train_state_to_jax(tstate)))
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(tree_items(tstate.params)) == len(
        jax.tree_util.tree_leaves(host))


# -- serving ----------------------------------------------------------------

SERVE = dict(TINY, max_seq_len=32, serve_slots=4, serve_chunk=4,
             decode_kernel="scan", fused_rnn=False)
N_REQ = 10
SAME_METRICS = ("completed", "decode_steps", "device_steps", "chunks",
                "dispatches", "dispatches_saved", "host_syncs",
                "steps_attributed", "steps_idle",
                "accepted_steps_per_device_step", "slot_utilization")


def _serve_fields(n, seed=11):
    rng = np.random.default_rng(seed)
    keys = [jax.random.fold_in(jax.random.key(seed), i) for i in range(n)]
    z = rng.normal(size=(n, SERVE["z_size"])).astype(np.float32)
    temps = rng.uniform(0.5, 1.0, n).astype(np.float32)
    caps = rng.integers(12, 17, n)
    return keys, z, temps, caps


def _compare_results(jres, tres):
    jby = {r.uid: r for r in jres}
    tby = {r.uid: r for r in tres}
    assert sorted(jby) == sorted(tby)
    for uid, a in jby.items():
        b = tby[uid]
        sa, sb = np.asarray(a.strokes5), np.asarray(b.strokes5)
        assert a.steps == b.steps and a.length == b.length, uid
        assert sa.shape == sb.shape, uid
        assert np.array_equal(sa[:, 2:], sb[:, 2:]), f"request {uid}: pens"
        err = float(np.max(np.abs(sa - sb)))
        assert err <= 1e-5, f"request {uid}: offsets err {err}"
        assert a.endpoint == b.endpoint
        assert a.attributed_steps == b.attributed_steps


def test_hyper_engine_matches_jax_scan_engine():
    """``generate`` through the plain chunk program against the JAX
    engine's scan chunk: 10 requests on 4 slots (the slots recycle), steps
    and pens exact, offsets within 1e-5, the scheduling metrics equal."""
    jm, tm, jp, tp = _models(**SERVE)[2:]
    keys, z, temps, caps = _serve_fields(N_REQ)
    jreqs = [JRequest(key=keys[i], z=z[i], temperature=float(temps[i]),
                      max_len=int(caps[i])) for i in range(N_REQ)]
    treqs = [Request(key=np.asarray(jax.random.key_data(keys[i])), z=z[i],
                     temperature=float(temps[i]), max_len=int(caps[i]))
             for i in range(N_REQ)]
    jout = JServeEngine(jm, jm.hps, jp, decode_kernel="scan").run(jreqs)
    before = cuda_decode.decode_chunk_launches
    tout = ServeEngine(tm, tm.hps, tp, device="cpu").run(treqs)
    assert cuda_decode.decode_chunk_launches == before
    _compare_results(jout["results"], tout["results"])
    for k in SAME_METRICS:
        assert jout["metrics"][k] == tout["metrics"][k], k
    assert tout["metrics"]["decode_kernel"] == "plain"
    assert tout["metrics"]["completed"] == N_REQ


def test_hyper_serve_requests_endpoint_mix_matches_jax():
    """generate / complete / reconstruct: the encode phase (plain replay
    loop over the four carry streams) stamps the same planned state, and
    the decode of it agrees."""
    jm, tm, jp, tp = _models(**SERVE)[2:]
    keys, z, temps, caps = _serve_fields(N_REQ, seed=12)
    rng = np.random.default_rng(12)
    specs = []
    for i in range(N_REQ):
        ep = ("generate", "complete", "reconstruct")[i % 3]
        prefix = None
        if ep != "generate":
            n = int(rng.integers(2, 20))
            prefix = np.zeros((n, 3), np.float32)
            prefix[:, :2] = rng.normal(size=(n, 2))
            prefix[:, 2] = rng.random(n) < 0.2
        specs.append(dict(endpoint=ep, temperature=float(temps[i]),
                          max_len=int(caps[i]), prefix=prefix,
                          z=z[i] if ep == "generate" else None))
    jreqs = [JRequest(key=keys[i], **specs[i]) for i in range(N_REQ)]
    treqs = [Request(key=np.asarray(jax.random.key_data(keys[i])),
                     **specs[i]) for i in range(N_REQ)]
    jout = j_serve_requests(jm, jm.hps, jp, jreqs)
    before = cuda_decode.replay_chunk_launches
    tout = serve_requests(tm, tm.hps, tp, treqs, device="cpu")
    assert cuda_decode.replay_chunk_launches == before
    _compare_results(jout["results"], tout["results"])
    for k in SAME_METRICS:
        assert jout["metrics"][k] == tout["metrics"][k], k
    assert tout["metrics"]["decode_kernel"] == "plain"
    for a, b in zip(jreqs, treqs):
        if a.endpoint == "generate":
            continue
        np.testing.assert_allclose(np.asarray(a.z), b.z, rtol=0, atol=1e-5)
        if a.endpoint == "complete":
            assert b.init_carry.shape == (tm.dec.carry_size,)
            np.testing.assert_allclose(np.asarray(a.init_carry),
                                       b.init_carry, rtol=0, atol=1e-5)
            np.testing.assert_array_equal(np.asarray(a.init_prev),
                                          b.init_prev)


def test_hyper_solo_vs_batch_invariance():
    """A request's strokes do not depend on what shares the engine with
    it: each request served alone on a same-slots engine equals its
    strokes in the full burst, bit for bit (as ``tests/test_serve.py``
    holds the JAX engine)."""
    tm, _, tp = _models(**SERVE)[3:]
    keys, z, temps, caps = _serve_fields(6, seed=13)
    words = [np.asarray(jax.random.key_data(k)) for k in keys]

    def req(i):
        return Request(key=words[i], z=z[i], temperature=float(temps[i]),
                       max_len=int(caps[i]), uid=i)

    eng = ServeEngine(tm, tm.hps, tp, device="cpu")
    burst = {r.uid: r for r in eng.run([req(i) for i in range(6)])["results"]}
    for i in (0, 3, 5):
        solo = eng.run([req(i)])["results"][0]
        assert solo.steps == burst[i].steps
        assert np.array_equal(solo.strokes5, burst[i].strokes5)


# -- refusals that remain ---------------------------------------------------


def test_decode_kernels_still_refuse_the_hyper_cell():
    with pytest.raises(ValueError, match="hyper"):
        cuda_decode.check_cell_kind("hyper")


def test_biases_passed_singly_are_refused():
    hh, e = SIZES["wide"]
    d = {k: torch.from_numpy(v) for k, v in _inputs(hh, e, biases=True)
         .items()}
    w = CF.HyperWeights(*(d[n] for n in W_NAMES))
    car = [d[n] for n in CARRIES]
    for kw in (dict(x_bias=d["x_bias"]),
               dict(x_bias_hyper=d["x_bias_hyper"])):
        with pytest.raises(ValueError, match="both x_bias and x_bias_hyper"):
            CF.fused_hyper_lstm(d["xs"], *w, *car, **kw)
        with pytest.raises(ValueError, match="both x_bias and x_bias_hyper"):
            CF.hyper_lstm_fwd(d["xs"], w, *car, **kw)


def test_mixed_matrix_dtypes_and_both_dropout_forms_are_refused():
    hh, e = SIZES["wide"]
    d = {k: torch.from_numpy(v) for k, v in _inputs(hh, e).items()}
    w = CF.HyperWeights(*(d[n] for n in W_NAMES))
    car = [d[n] for n in CARRIES]
    with pytest.raises(TypeError, match="share one of"):
        CF.fused_hyper_lstm(d["xs"], *w._replace(whh=w.whh.bfloat16()), *car)
    with pytest.raises(ValueError, match="not both"):
        CF.fused_hyper_lstm(d["xs"], *w, *car, 1.0,
                            torch.ones((T, B, H)), 5, KEEP)
    with pytest.raises(TypeError, match="residual"):
        CF.fused_hyper_lstm(d["xs"], *w, *car, residual_dtype=torch.float16)


def test_hyper_trains_fused_only_and_needs_the_card_unless_cpu(monkeypatch):
    """The hyper preset trains at ``fused_rnn=true`` and at its default
    ``fused_rnn=false`` (the plain cell path), with a HyperLSTM encoder
    too: one CPU step of each gives finite metrics. The entry points run
    on the card unless given ``device="cpu"``."""
    th = HParams(**TINY)
    batch = jloader.synthetic_loader(JHParams(**TINY), num=24,
                                     seed=0)[0].random_batch()
    for over in ("", "enc_model=hyper", "fused_rnn=false",
                 "fused_rnn=false,enc_model=hyper"):
        h = th.parse(over) if over else th
        m = SketchRNN(h)
        p = m.init_params(torch.Generator().manual_seed(0), device="cpu")
        _, met = make_train_step(m, h, device="cpu")(
            make_train_state(p), batch, prng.key(1))
        assert all(np.isfinite(float(v)) for v in met.values()), over
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = SketchRNN(th)
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tm, th, tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(tm, th)
    state, met = make_train_step(tm, th, device="cpu")(
        make_train_state(tp), jloader.synthetic_loader(
            JHParams(**TINY), num=24, seed=0)[0].random_batch(), prng.key(1))
    assert all(np.isfinite(float(v)) for v in met.values())
    assert state.step == 1
