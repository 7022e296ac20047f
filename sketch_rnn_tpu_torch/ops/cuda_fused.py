"""The training kernels: the encoder's and the decoder's recurrences.

The port of the two kernel families of ``sketch_rnn_tpu/ops/pallas_fused.py``
that training at the flagship configuration runs. Four hand-written CUDA
kernels (``csrc/fused_rnn.cu``) replace four Pallas kernels:

- :func:`fused_lstm_seq` (the bi-LSTM encoder, each direction): the
  forward replaces ``pallas_fused._lstm_seq_fwd_kernel``, the backward
  ``pallas_fused._lstm_seq_bwd_kernel``. It returns ``hs`` only, and its
  backward defines the ``xs``, ``c0`` and ``h0`` gradients as ZERO (the
  encoder's contract: the strokes are data, the carries constant zeros),
  exactly as the JAX package's custom VJP does.
- :func:`fused_ln_lstm` (the LayerNorm-LSTM decoder): the forward
  replaces ``pallas_fused._lnlstm_fwd_kernel``, the backward
  ``pallas_fused._lnlstm_bwd_kernel``, with the per-example gate bias
  ``x_bias`` and every input's gradient.

Both keep the Pallas kernels' memory contract: no ``[T, B, 4H]`` gate
buffer and no mask buffer exist in the forward; it saves only ``hs`` and
the pre-step cell states ``cs``, and the backward recomputes the gates
from ``(x, h_prev, c_prev)`` walking time backwards. Recurrent dropout on
the candidate ``g`` is either streamed ``masks [T, B, H]`` or drawn in
the kernel from ``dropout_seed`` by :func:`prng_mask`, whose counter does
not depend on any tiling, so the CUDA kernels reproduce the JAX package's
masks bit for bit.

Beside each kernel pair are its plain PyTorch versions: a forward and a
backward written step by step (the backward mirrors
``_lstm_step_bwd_math`` and ``_ln_lstm_bwd_gates``; it does not run
autograd of the forward). Each kernel has one wrapper with its plain
version's signature (``lstm_seq_fwd``, ``lstm_seq_bwd``, ``ln_lstm_fwd``,
``ln_lstm_bwd``): the plain version for CPU tensors, for CUDA tensors
the kernel or a raise. The public functions are
``torch.autograd.Function``s over those wrappers. The ``*_launches``
counters count kernel launches only (one per wrapper call, whatever the
number of CUDA kernels inside), never plain-version calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.ops.cuda_decode import _require

_MASK = 0xFFFFFFFF
_LN_EPS = 1e-6
MAX_HIDDEN = 512    # one thread per hidden unit, 512 threads per block

fused_lstm_seq_fwd_launches = 0
fused_lstm_seq_bwd_launches = 0
fused_ln_lstm_fwd_launches = 0
fused_ln_lstm_bwd_launches = 0


def reset_launch_counts() -> None:
    global fused_lstm_seq_fwd_launches, fused_lstm_seq_bwd_launches
    global fused_ln_lstm_fwd_launches, fused_ln_lstm_bwd_launches
    fused_lstm_seq_fwd_launches = fused_lstm_seq_bwd_launches = 0
    fused_ln_lstm_fwd_launches = fused_ln_lstm_bwd_launches = 0


def launch_counts() -> dict:
    return {"fused_lstm_seq_fwd": fused_lstm_seq_fwd_launches,
            "fused_lstm_seq_bwd": fused_lstm_seq_bwd_launches,
            "fused_ln_lstm_fwd": fused_ln_lstm_fwd_launches,
            "fused_ln_lstm_bwd": fused_ln_lstm_bwd_launches}


# -- the in-kernel dropout mask ---------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values held in int64, split so no
    intermediate leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def hash32(x: torch.Tensor) -> torch.Tensor:
    """``pallas_fused._hash32`` (a murmur3-style avalanche over uint32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def prng_mask(seed, t: int, b: int, h: int, keep: float) -> torch.Tensor:
    """Recurrent-dropout mask ``[B, H]`` of step ``t``, bitwise
    ``pallas_fused._prng_mask``: element ``(row, col)`` hashes the counter
    ``seed * 2654435761 + (t * B + row) * H + col (mod 2**32)``; the top
    24 bits give ``u = (bits >> 8) * 2**-24`` and the mask is ``(u < keep)
    * float32(1 / keep)``. ``seed``: int or int32 tensor (any device)."""
    seed = torch.as_tensor(seed).to(torch.int64).reshape(())
    dev = seed.device
    base = (_mul32(seed & _MASK, 2654435761) + (t * b) * h) & _MASK
    idx = torch.arange(b * h, dtype=torch.int64, device=dev).reshape(b, h)
    bits = hash32((base + idx) & _MASK)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    inv = torch.tensor(np.float32(1.0 / keep), device=dev)
    return (u < np.float32(keep)).to(torch.float32) * inv


def _step_mask(masks, seed, t, b, h, keep):
    if masks is not None:
        return masks[t]
    if seed is not None:
        return prng_mask(seed, t, b, h, keep)
    return None


def _check_dropout(masks, seed):
    if masks is not None and seed is not None:
        raise ValueError("pass masks or dropout_seed, not both")


def _check_residual(residual_dtype):
    if residual_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"residual_dtype={residual_dtype}: bfloat16 residuals of the "
            f"fused kernels come with the next slice of the PyTorch port; "
            f"train with fused_residual_dtype=float32")


# -- plain PyTorch versions: forward ----------------------------------------


def _lstm_gates(pre, c_prev, m, forget_bias):
    h = c_prev.shape[-1]
    i = torch.sigmoid(pre[:, :h])
    g_u = torch.tanh(pre[:, h:2 * h])
    g = g_u * m if m is not None else g_u
    f = torch.sigmoid(pre[:, 2 * h:3 * h] + forget_bias)
    o = torch.sigmoid(pre[:, 3 * h:])
    return i, g_u, f, o, c_prev * f + i * g


def _ln_fwd(u, gamma, beta):
    """Row layer norm; returns ``(y, xhat, r)``."""
    mu = u.mean(dim=-1, keepdim=True)
    xc = u - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + _LN_EPS)
    xhat = xc * r
    return xhat * gamma + beta, xhat, r


def _ln_bwd_input(dy, gamma, xhat, r):
    dxhat = dy * gamma
    return r * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))


def _ln_gates(pre, c_prev, m, gam, bet, gc, bc, forget_bias):
    """LayerNorm-LSTM gate block; returns every residual the backward
    needs: ``(i, g_u, f, o, new_c, new_h, yc, xhat_c, r_c, xhats, rs)``."""
    h = c_prev.shape[-1]
    ys, xhats, rs = [], [], []
    for j in range(4):
        y, xhat, r = _ln_fwd(pre[:, j * h:(j + 1) * h], gam[j], bet[j])
        ys.append(y)
        xhats.append(xhat)
        rs.append(r)
    i = torch.sigmoid(ys[0])
    g_u = torch.tanh(ys[1])
    g = g_u * m if m is not None else g_u
    f = torch.sigmoid(ys[2] + forget_bias)
    o = torch.sigmoid(ys[3])
    new_c = c_prev * f + i * g
    yc, xhat_c, r_c = _ln_fwd(new_c, gc, bc)
    new_h = torch.tanh(yc) * o
    return i, g_u, f, o, new_c, new_h, yc, xhat_c, r_c, xhats, rs


def _lstm_pre(x, h_prev, wx, b, wh):
    return x @ wx + b + h_prev @ wh


def _ln_pre(x, h_prev, wx, wh, xb):
    pre = x @ wx + h_prev @ wh
    return pre + xb if xb is not None else pre


def lstm_seq_fwd_reference(xs, wx, b, wh, c0, h0, forget_bias=1.0,
                           masks=None, dropout_seed=None, keep_prob=1.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward of :func:`fused_lstm_seq`: ``(hs, cs)``, ``cs``
    being the pre-step cell states the backward reads."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    c, hh = c0, h0
    hs, cs = [], []
    for t in range(t_len):
        pre = _lstm_pre(xs[t], hh, wx, b, wh)
        m = _step_mask(masks, dropout_seed, t, bsz, h, keep_prob)
        _, _, _, o, new_c = _lstm_gates(pre, c, m, forget_bias)
        cs.append(c)
        c, hh = new_c, torch.tanh(new_c) * o
        hs.append(hh)
    return torch.stack(hs), torch.stack(cs)


def ln_lstm_fwd_reference(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma,
                          lnc_beta, c0, h0, forget_bias=1.0, masks=None,
                          dropout_seed=None, keep_prob=1.0, x_bias=None):
    """The plain forward of :func:`fused_ln_lstm`: ``(hs, cs, cT, hT)``."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    c, hh = c0, h0
    hs, cs = [], []
    for t in range(t_len):
        pre = _ln_pre(xs[t], hh, wx, wh, x_bias)
        m = _step_mask(masks, dropout_seed, t, bsz, h, keep_prob)
        res = _ln_gates(pre, c, m, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
                        forget_bias)
        cs.append(c)
        c, hh = res[4], res[5]
        hs.append(hh)
    return torch.stack(hs), torch.stack(cs), c, hh


# -- plain PyTorch versions: backward ---------------------------------------


def lstm_seq_bwd_reference(xs, wx, b, wh, h0, hs, cs, dhs, forget_bias=1.0,
                           masks=None, dropout_seed=None, keep_prob=1.0):
    """The plain backward of :func:`fused_lstm_seq`, step by step
    (``pallas_fused._lstm_step_bwd_math``): recompute each step's gates
    from ``(x, h_prev, c_prev)``, walk time backwards from zero carry
    cotangents. Returns ``(dwx, db, dwh)``."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    dwx = torch.zeros_like(wx)
    db = torch.zeros_like(b)
    dwh = torch.zeros_like(wh)
    dc = torch.zeros((bsz, h), dtype=xs.dtype, device=xs.device)
    dh = torch.zeros_like(dc)
    for s in range(t_len - 1, -1, -1):
        x = xs[s]
        h_prev = hs[s - 1] if s > 0 else h0
        c_prev = cs[s]
        m = _step_mask(masks, dropout_seed, s, bsz, h, keep_prob)
        dh = dh + dhs[s]
        pre = _lstm_pre(x, h_prev, wx, b, wh)
        i, g_u, f, o, new_c = _lstm_gates(pre, c_prev, m, forget_bias)
        tanh_c = torch.tanh(new_c)
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        do = dh * tanh_c
        df = dc * c_prev
        g = g_u * m if m is not None else g_u
        di = dc * g
        dg_u = dc * i * m if m is not None else dc * i
        d_pre = torch.cat([di * i * (1.0 - i), dg_u * (1.0 - g_u * g_u),
                           df * f * (1.0 - f), do * o * (1.0 - o)], dim=-1)
        dwx += x.T @ d_pre
        db += d_pre.sum(dim=0)
        dh = d_pre @ wh.T
        dwh += h_prev.T @ d_pre
        dc = dc * f
    return dwx, db, dwh


def ln_lstm_bwd_reference(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma,
                          lnc_beta, h0, hs, cs, dhs, dcT, dhT,
                          forget_bias=1.0, masks=None, dropout_seed=None,
                          keep_prob=1.0, x_bias=None):
    """The plain backward of :func:`fused_ln_lstm`, step by step
    (``pallas_fused._ln_lstm_bwd_gates``). Returns ``(dxs, dxb, dwx, dwh,
    dgam, dbet, dgc, dbc, dc0, dh0)``; ``dxb`` is None without
    ``x_bias``."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    dxs = torch.empty_like(xs)
    dxb = torch.zeros_like(x_bias) if x_bias is not None else None
    dwx = torch.zeros_like(wx)
    dwh = torch.zeros_like(wh)
    dgam = torch.zeros_like(ln_gamma)
    dbet = torch.zeros_like(ln_beta)
    dgc = torch.zeros_like(lnc_gamma)
    dbc = torch.zeros_like(lnc_beta)
    dc, dh = dcT, dhT
    for s in range(t_len - 1, -1, -1):
        x = xs[s]
        h_prev = hs[s - 1] if s > 0 else h0
        c_prev = cs[s]
        pre = _ln_pre(x, h_prev, wx, wh, x_bias)
        m = _step_mask(masks, dropout_seed, s, bsz, h, keep_prob)
        (i, g_u, f, o, _, _, yc, xhat_c, r_c, xhats, rs) = _ln_gates(
            pre, c_prev, m, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
            forget_bias)
        dh = dh + dhs[s]
        tanh_yc = torch.tanh(yc)
        do = dh * tanh_yc
        dyc = dh * o * (1.0 - tanh_yc * tanh_yc)
        dgc += (dyc * xhat_c).sum(dim=0)
        dbc += dyc.sum(dim=0)
        dc = dc + _ln_bwd_input(dyc, lnc_gamma, xhat_c, r_c)
        df = dc * c_prev
        g = g_u * m if m is not None else g_u
        di = dc * g
        dg_u = dc * i * m if m is not None else dc * i
        dys = [di * i * (1.0 - i), dg_u * (1.0 - g_u * g_u),
               df * f * (1.0 - f), do * o * (1.0 - o)]
        parts = []
        for j in range(4):
            dgam[j] += (dys[j] * xhats[j]).sum(dim=0)
            dbet[j] += dys[j].sum(dim=0)
            parts.append(_ln_bwd_input(dys[j], ln_gamma[j], xhats[j], rs[j]))
        d_pre = torch.cat(parts, dim=-1)
        if dxb is not None:
            dxb += d_pre
        dxs[s] = d_pre @ wx.T
        dwx += x.T @ d_pre
        dh = d_pre @ wh.T
        dwh += h_prev.T @ d_pre
        dc = dc * f
    return dxs, dxb, dwx, dwh, dgam, dbet, dgc, dbc, dc, dh


# -- the kernels ------------------------------------------------------------
#
# One function per kernel, with its plain version's signature: the plain
# version on CPU tensors, the CUDA kernel on CUDA tensors (or a raise).
# Each adds one to its launch counter when it launches.


def _kernel_common(xs, wx, wh, c0, h0, masks, seed):
    """Validate what both kernel families share; returns ``(dev, t, b,
    d, h, mask_ptr, seed_ptr)``."""
    if xs.device.type != "cuda":
        raise ValueError(f"the fused RNN kernels run on CUDA or CPU "
                         f"tensors, not {xs.device}")
    dev = xs.device
    t, b, d = xs.shape
    h = wh.shape[0]
    if not 0 < h <= MAX_HIDDEN:
        raise ValueError(f"hidden size {h}: the fused RNN kernels hold one "
                         f"thread per hidden unit, at most {MAX_HIDDEN}")
    f32 = torch.float32
    for n, x, shape in (("xs", xs, (t, b, d)), ("wx", wx, (d, 4 * h)),
                        ("wh", wh, (h, 4 * h)), ("c0", c0, (b, h)),
                        ("h0", h0, (b, h))):
        _require(n, x, dev, f32, shape)
    if masks is not None:
        _require("masks", masks, dev, f32, (t, b, h))
    if seed is not None:
        _require("dropout_seed", seed, dev, torch.int32, ())
    return dev, t, b, d, h, _ptr(masks), _ptr(seed)


def _ln_params_check(dev, h, gam, bet, gc, bc, x_bias, bsz):
    f32 = torch.float32
    for n, x, shape in (("ln_gamma", gam, (4, h)), ("ln_beta", bet, (4, h)),
                        ("lnc_gamma", gc, (h,)), ("lnc_beta", bc, (h,))):
        _require(n, x, dev, f32, shape)
    if x_bias is not None:
        _require("x_bias", x_bias, dev, f32, (bsz, 4 * h))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _keep_args(keep_prob):
    return float(np.float32(keep_prob)), float(np.float32(1.0 / keep_prob))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def lstm_seq_fwd(xs, wx, b, wh, c0, h0, forget_bias=1.0, masks=None,
                 dropout_seed=None, keep_prob=1.0):
    """Forward of :func:`fused_lstm_seq`: ``(hs, cs)`` (kernel
    ``srt_lstm_seq_fwd``)."""
    global fused_lstm_seq_fwd_launches
    if xs.device.type == "cpu":
        return lstm_seq_fwd_reference(xs, wx, b, wh, c0, h0, forget_bias,
                                      masks, dropout_seed, keep_prob)
    from sketch_rnn_tpu_torch.ops import _build

    dev, t, bsz, d, h, mp, sp = _kernel_common(xs, wx, wh, c0, h0, masks,
                                               dropout_seed)
    _require("b", b, dev, torch.float32, (4 * h,))
    hs = torch.empty((t, bsz, h), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    keep, inv = _keep_args(keep_prob)
    lib = _build.load("fused_rnn")
    err = lib.srt_lstm_seq_fwd(
        xs.data_ptr(), wx.data_ptr(), b.data_ptr(), wh.data_ptr(),
        c0.data_ptr(), h0.data_ptr(), mp, sp, t, bsz, d, h, keep, inv,
        float(forget_bias), hs.data_ptr(), cs.data_ptr(), _stream(dev))
    _build.check(lib, err, "fused_lstm_seq forward")
    fused_lstm_seq_fwd_launches += 1
    return hs, cs


def lstm_seq_bwd(xs, wx, b, wh, h0, hs, cs, dhs, forget_bias=1.0,
                 masks=None, dropout_seed=None, keep_prob=1.0):
    """Backward of :func:`fused_lstm_seq`: ``(dwx, db, dwh)`` (kernel
    ``srt_lstm_seq_bwd``: the recurrence, then the weight-gradient
    pass)."""
    global fused_lstm_seq_bwd_launches
    if xs.device.type == "cpu":
        return lstm_seq_bwd_reference(xs, wx, b, wh, h0, hs, cs, dhs,
                                      forget_bias, masks, dropout_seed,
                                      keep_prob)
    from sketch_rnn_tpu_torch.ops import _build

    dev, t, bsz, d, h, mp, sp = _kernel_common(xs, wx, wh, h0, h0, masks,
                                               dropout_seed)
    _require("b", b, dev, torch.float32, (4 * h,))
    for n, x in (("hs", hs), ("cs", cs), ("dhs", dhs)):
        _require(n, x, dev, torch.float32, (t, bsz, h))
    # scratch: the pre-activation gradients of every step, read by the
    # weight-gradient pass
    dpre = torch.empty((t, bsz, 4 * h), dtype=torch.float32, device=dev)
    dwx = torch.empty_like(wx)
    db = torch.empty_like(b)
    dwh = torch.empty_like(wh)
    keep, inv = _keep_args(keep_prob)
    lib = _build.load("fused_rnn")
    err = lib.srt_lstm_seq_bwd(
        xs.data_ptr(), wx.data_ptr(), b.data_ptr(), wh.data_ptr(),
        h0.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(), mp,
        sp, t, bsz, d, h, keep, inv, float(forget_bias), dpre.data_ptr(),
        dwx.data_ptr(), db.data_ptr(), dwh.data_ptr(), _stream(dev))
    _build.check(lib, err, "fused_lstm_seq backward")
    fused_lstm_seq_bwd_launches += 1
    return dwx, db, dwh


def ln_lstm_fwd(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
                h0, forget_bias=1.0, masks=None, dropout_seed=None,
                keep_prob=1.0, x_bias=None):
    """Forward of :func:`fused_ln_lstm`: ``(hs, cs, cT, hT)`` (kernel
    ``srt_ln_lstm_fwd``)."""
    global fused_ln_lstm_fwd_launches
    if xs.device.type == "cpu":
        return ln_lstm_fwd_reference(xs, wx, wh, ln_gamma, ln_beta,
                                     lnc_gamma, lnc_beta, c0, h0,
                                     forget_bias, masks, dropout_seed,
                                     keep_prob, x_bias)
    from sketch_rnn_tpu_torch.ops import _build

    dev, t, bsz, d, h, mp, sp = _kernel_common(xs, wx, wh, c0, h0, masks,
                                               dropout_seed)
    _ln_params_check(dev, h, ln_gamma, ln_beta, lnc_gamma, lnc_beta, x_bias,
                     bsz)
    hs = torch.empty((t, bsz, h), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    cT = torch.empty((bsz, h), dtype=torch.float32, device=dev)
    hT = torch.empty_like(cT)
    keep, inv = _keep_args(keep_prob)
    lib = _build.load("fused_rnn")
    err = lib.srt_ln_lstm_fwd(
        xs.data_ptr(), _ptr(x_bias), wx.data_ptr(), wh.data_ptr(),
        ln_gamma.data_ptr(), ln_beta.data_ptr(), lnc_gamma.data_ptr(),
        lnc_beta.data_ptr(), c0.data_ptr(), h0.data_ptr(), mp, sp, t, bsz,
        d, h, keep, inv, float(forget_bias), hs.data_ptr(), cs.data_ptr(),
        cT.data_ptr(), hT.data_ptr(), _stream(dev))
    _build.check(lib, err, "fused_ln_lstm forward")
    fused_ln_lstm_fwd_launches += 1
    return hs, cs, cT, hT


def ln_lstm_bwd(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs,
                cs, dhs, dcT, dhT, forget_bias=1.0, masks=None,
                dropout_seed=None, keep_prob=1.0, x_bias=None):
    """Backward of :func:`fused_ln_lstm`: ``(dxs, dxb, dwx, dwh, dgam,
    dbet, dgc, dbc, dc0, dh0)`` (kernel ``srt_ln_lstm_bwd``: the
    recurrence, the weight-gradient pass and the LN-parameter sum)."""
    global fused_ln_lstm_bwd_launches
    if xs.device.type == "cpu":
        return ln_lstm_bwd_reference(xs, wx, wh, ln_gamma, ln_beta,
                                     lnc_gamma, lnc_beta, h0, hs, cs, dhs,
                                     dcT, dhT, forget_bias, masks,
                                     dropout_seed, keep_prob, x_bias)
    from sketch_rnn_tpu_torch.ops import _build

    dev, t, bsz, d, h, mp, sp = _kernel_common(xs, wx, wh, h0, h0, masks,
                                               dropout_seed)
    _ln_params_check(dev, h, ln_gamma, ln_beta, lnc_gamma, lnc_beta, x_bias,
                     bsz)
    f32 = torch.float32
    for n, g, shape in (("hs", hs, (t, bsz, h)), ("cs", cs, (t, bsz, h)),
                        ("dhs", dhs, (t, bsz, h)), ("dcT", dcT, (bsz, h)),
                        ("dhT", dhT, (bsz, h))):
        _require(n, g, dev, f32, shape)
    # scratch: every step's pre-activation gradients (read by the
    # weight-gradient pass) and each row's LN-parameter partials
    dpre = torch.empty((t, bsz, 4 * h), dtype=f32, device=dev)
    part = torch.empty((bsz, 10 * h), dtype=f32, device=dev)
    dxs = torch.empty_like(xs)
    dxb = torch.empty_like(x_bias) if x_bias is not None else None
    dwx = torch.empty_like(wx)
    dwh = torch.empty_like(wh)
    dln = torch.empty((10 * h,), dtype=f32, device=dev)
    dc0 = torch.empty((bsz, h), dtype=f32, device=dev)
    dh0 = torch.empty_like(dc0)
    keep, inv = _keep_args(keep_prob)
    lib = _build.load("fused_rnn")
    err = lib.srt_ln_lstm_bwd(
        xs.data_ptr(), _ptr(x_bias), wx.data_ptr(), wh.data_ptr(),
        ln_gamma.data_ptr(), ln_beta.data_ptr(), lnc_gamma.data_ptr(),
        lnc_beta.data_ptr(), h0.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        dhs.data_ptr(), dcT.data_ptr(), dhT.data_ptr(), mp, sp, t, bsz, d,
        h, keep, inv, float(forget_bias), dpre.data_ptr(), part.data_ptr(),
        dxs.data_ptr(), _ptr(dxb), dwx.data_ptr(), dwh.data_ptr(),
        dln.data_ptr(), dc0.data_ptr(), dh0.data_ptr(), _stream(dev))
    _build.check(lib, err, "fused_ln_lstm backward")
    fused_ln_lstm_bwd_launches += 1
    return (dxs, dxb, dwx, dwh, dln[:4 * h].view(4, h),
            dln[4 * h:8 * h].view(4, h), dln[8 * h:9 * h], dln[9 * h:], dc0,
            dh0)


# -- the autograd Functions -------------------------------------------------


def _as_seed(seed, like):
    if seed is None:
        return None
    return torch.as_tensor(seed, dtype=torch.int32).reshape(()).to(
        like.device)


class _FusedLSTMSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, wx, b, wh, c0, h0, masks, seed, forget_bias,
                keep_prob):
        hs, cs = lstm_seq_fwd(xs, wx, b, wh, c0, h0, forget_bias, masks,
                              seed, keep_prob)
        ctx.save_for_backward(xs, wx, b, wh, c0, h0, hs, cs, masks, seed)
        ctx.forget_bias, ctx.keep_prob = forget_bias, keep_prob
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xs, wx, b, wh, c0, h0, hs, cs, masks, seed = ctx.saved_tensors
        dwx, db, dwh = lstm_seq_bwd(xs, wx, b, wh, h0, hs, cs,
                                    dhs.contiguous(), ctx.forget_bias, masks,
                                    seed, ctx.keep_prob)
        return (torch.zeros_like(xs), dwx, db, dwh, torch.zeros_like(c0),
                torch.zeros_like(h0), None, None, None, None)


def fused_lstm_seq(xs, wx, b, wh, c0, h0, forget_bias: float = 1.0,
                   masks: Optional[torch.Tensor] = None, dropout_seed=None,
                   keep_prob: float = 1.0, residual_dtype=None
                   ) -> torch.Tensor:
    """Sequence-only fused LSTM over ``xs [T, B, D]``: returns ``hs [T,
    B, H]`` alone. ``wx [D, 4H]``, ``b [4H]``, ``wh [H, 4H]``, carries
    ``[B, H]``; gates ``(i, g, f, o)``, the forget bias added to ``f``.
    Dropout on the candidate: ``masks [T, B, H]`` or ``dropout_seed`` (an
    int32 scalar) with ``keep_prob``. Only the weights are
    differentiated: the gradients of ``xs``, ``c0`` and ``h0`` are zero
    by definition (the encoder's contract, as in the JAX package)."""
    _check_dropout(masks, dropout_seed)
    _check_residual(residual_dtype)
    return _FusedLSTMSeq.apply(xs, wx, b, wh, c0, h0, masks,
                               _as_seed(dropout_seed, xs), forget_bias,
                               keep_prob)


class _FusedLNLSTM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, wx, wh, gam, bet, gc, bc, c0, h0, masks, seed,
                x_bias, forget_bias, keep_prob):
        hs, cs, cT, hT = ln_lstm_fwd(xs, wx, wh, gam, bet, gc, bc, c0, h0,
                                     forget_bias, masks, seed, keep_prob,
                                     x_bias)
        ctx.save_for_backward(xs, wx, wh, gam, bet, gc, bc, h0, hs, cs,
                              masks, seed, x_bias)
        ctx.forget_bias, ctx.keep_prob = forget_bias, keep_prob
        return hs, cT, hT

    @staticmethod
    def backward(ctx, dhs, dcT, dhT):
        (xs, wx, wh, gam, bet, gc, bc, h0, hs, cs, masks, seed,
         x_bias) = ctx.saved_tensors
        (dxs, dxb, dwx, dwh, dgam, dbet, dgc, dbc, dc0, dh0) = ln_lstm_bwd(
            xs, wx, wh, gam, bet, gc, bc, h0, hs, cs, dhs.contiguous(),
            dcT.contiguous(), dhT.contiguous(), ctx.forget_bias, masks,
            seed, ctx.keep_prob, x_bias)
        return (dxs, dwx, dwh, dgam, dbet, dgc, dbc, dc0, dh0, None, None,
                dxb, None, None)


def fused_ln_lstm(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
                  h0, forget_bias: float = 1.0,
                  masks: Optional[torch.Tensor] = None, dropout_seed=None,
                  keep_prob: float = 1.0, residual_dtype=None,
                  x_bias: Optional[torch.Tensor] = None):
    """Fused LayerNorm-LSTM over ``xs [T, B, D]``: per-gate layer norm
    (``ln_gamma/ln_beta [4, H]``), the cell-state norm (``lnc_gamma /
    lnc_beta [H]``), no linear bias, the forget bias after the norm,
    dropout on the candidate. ``x_bias [B, 4H]`` is added to every
    step's pre-activations (the projection of time-invariant inputs).
    Returns ``(hs [T, B, H], (cT, hT))``; every input is differentiated.
    """
    _check_dropout(masks, dropout_seed)
    _check_residual(residual_dtype)
    hs, cT, hT = _FusedLNLSTM.apply(
        xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0, masks,
        _as_seed(dropout_seed, xs), x_bias, forget_bias, keep_prob)
    return hs, (cT, hT)
