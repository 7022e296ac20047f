"""Probe: the LayerNorm-LSTM recurrence split into measured terms, on the card.

The port of ``scripts/probe_dec_bwd_split.py``. A strictly nested ladder
of arms of the LayerNorm-LSTM kernels, each taking one term of work out
of the one before, so that the difference of two arms' times prices that
term. :func:`bwd_arm` (kernel ``srt_ln_probe_bwd`` of ``csrc/probe_ln.cu``)
runs the backward arms:

- ``prod``: the row-block backward, bit for bit the entry
  ``srt_ln_lstm_bwd_rowblock`` (the design ``fused_ln_lstm``'s backward,
  ``srt_ln_lstm_bwd``, replaced: not the production kernel);
- ``no_lnbwd``: the layer-norm backward's row-mean corrections elided
  (``d_pre = dy * gamma``); the LN-parameter sums kept;
- ``no_ln``: also the layer-norm statistics of the recomputed forward
  replaced by stand-ins (``mean = c_prev[:, 0] * 1e-3``, ``r = 1 +
  c_prev[:, 1] * 1e-3``), the reference's way: the stand-in forward
  builds the new cell state without the mask and hands the backward
  ``g_u * m``, which it masks again;
- ``no_gates``: ``d_pre = 0.25 pre + dh + 0.1 dc`` (each tiled over the
  four gates), ``dc' = 0.9 dc + 1e-3 c_prev``; every product kept, zero
  LN-parameter gradients;
- ``no_gradmm``: ``no_gates`` without the ``dwx``/``dwh``/``dx``
  products: ``dh_{t-1} = d_pre @ wh^T`` stays, ``dx = 0.5 x``;
- ``floor``: no products: ``d_pre = dh + 0.1 dc [+ x_bias]``,
  ``dh_{t-1} = 0.5 dh + 1e-3 h_prev``, ``dx = 0.5 x``.

:func:`fwd_arm` (``srt_ln_probe_fwd``) runs the forward arms ``prod``
(bit for bit the row-block entry ``srt_ln_lstm_fwd_rowblock``, not the
production ``srt_ln_lstm_fwd``), ``no_ln`` (the stand-in statistics),
``no_gates`` (``c' = 0.9 c + 0.1 pre[:, :H]``, ``h' = 0.5 h + 0.1
pre[:, H:2H]``) and ``floor`` (``c' = 0.9 c + x[:, :1] * 1e-3``, the
product in the weight dtype, ``h' = 0.5 h + 1e-3 x_bias[:, :H]``). The
arms are op-count probes: their numbers are wrong by design, and the
plain versions beside the wrappers compute the same wrong numbers.
``csrc/probe_ln.cu``'s header says what each arm drops on Hopper.

:func:`run_bwd_ladder` and :func:`run_fwd_ladder` time the arms on the
card at the reference's shape (B=4096, T=250, H=512, D=5, bfloat16
weights and residuals, ``x_bias``, in-kernel dropout from seed 5 at keep
0.9; the backward reads the residuals of one production ``fused_ln_lstm``
forward), interleaved (``_probe.interleaved``, CUDA events) where the
reference took K-chained differences. The backward ladder also times the
``glue`` arm: the stream preparation of the reference's retired layout
(``flip(cs)``, ``cat`` + ``flip`` of ``h_prev``, ``flip(dhs)``,
``flip(dxs)``) as plain PyTorch, each call taking the last one's outputs.
The port's backward reads natural-order streams, so it never pays this.
Each ladder's record names the entry its ``prod`` arm repeats
(``prod_repeats``) and carries the production entry's time beside it
(``production_entry``, ``production_ms``: ``srt_ln_lstm_fwd`` or
``srt_ln_lstm_bwd`` through the uncounted ``cuda_fused.*_entries``
helpers, timed in the same interleaving as the arms).
The reference's grid-scaling arm (batch tiles 64/128/256) has no
counterpart: the port's kernels have no batch tile (one block per row)
and no grid step per time step, so ``grid_scaling_ms`` is null.
:func:`main` prints the reference's record (its keys and deltas,
``tile`` 1: one row per block, ``device_kind`` from the card). Run on a
card:

    python -m sketch_rnn_tpu_torch.scripts.probe_dec_bwd_split [--fwd] \\
        [--reps 3] [--k 2] [--batch 4096] [--seq_len 250] [--skip_grid]

It prints and appends to no file.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.scripts import _probe

FWD_ARMS = ("prod", "no_ln", "no_gates", "floor")
ARMS = ("prod", "no_lnbwd", "no_ln", "no_gates", "no_gradmm", "floor")
# the kernels' arm ids (csrc/probe_ln.cu); "fake" is probe_ln_stats' arm
FWD_IDS = {a: i for i, a in enumerate(FWD_ARMS)}
BWD_IDS = {**{a: i for i, a in enumerate(ARMS)}, "fake": len(ARMS)}
# the backward arms with weight gradients (d_pre scratch, second pass)
# and with LN-parameter gradients (per-row partials, row-order sum)
_WEIGHT_GRAD_ARMS = ("prod", "no_lnbwd", "no_ln", "fake", "no_gates")
_LN_GRAD_ARMS = ("prod", "no_lnbwd", "no_ln", "fake")
H, D = 512, 5           # the reference's decoder width and input width

_launches = {**{f"fwd_{a}": 0 for a in FWD_ARMS},
             **{f"bwd_{a}": 0 for a in ARMS}}


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> dict:
    return dict(_launches)


def _refuse(arm, arms):
    if arm not in arms:
        raise ValueError(f"arm {arm!r}: one of {list(arms)}")


# -- plain versions ----------------------------------------------------------


def _stand_in_stats(c_prev):
    """The reference's stand-in layer-norm statistics of each row:
    ``(mean, r)``, each ``[B, 1]``."""
    return c_prev[:, :1] * 1e-3, 1.0 + c_prev[:, 1:2] * 1e-3


def fake_ln_gates(pre, c_prev, gam, bet, gc, bc, forget_bias):
    """The reference's ``_fake_ln_gates``: ``cuda_fused._ln_gates``'s
    residuals with the stand-in statistics for the four gate norms and
    the cell norm, and the new cell state built without the mask."""
    h = c_prev.shape[-1]
    mean, r = _stand_in_stats(c_prev)
    ys, xhats, rs = [], [], []
    for j in range(4):
        xhat = (pre[:, j * h:(j + 1) * h] - mean) * r
        ys.append(xhat * gam[j] + bet[j])
        xhats.append(xhat)
        rs.append(r)
    i = torch.sigmoid(ys[0])
    g_u = torch.tanh(ys[1])
    f = torch.sigmoid(ys[2] + forget_bias)
    o = torch.sigmoid(ys[3])
    new_c = c_prev * f + i * g_u
    xhat_c = (new_c - mean) * r
    yc = xhat_c * gc + bc
    return i, g_u, f, o, new_c, torch.tanh(yc) * o, yc, xhat_c, r, xhats, rs


def gates_bwd(res, dh, dc, c_prev, m, gam, gc, grads, corrections):
    """Backward through the gate block from its residuals ``res``
    (``cuda_fused._ln_gates``'s layout): with ``corrections`` the
    reference's ``_ln_lstm_bwd_gates``, without them its
    ``_ln_bwd_gates_noln`` (``d_pre = dy * gamma``, ``dc += dyc *
    lnc_gamma``). Adds this step's LN-parameter terms to ``grads``
    (``dgam, dbet, dgc, dbc``) in place; returns ``(d_pre, dc_next)``."""
    i, g_u, f, o, _, _, yc, xhat_c, r_c, xhats, rs = res
    dgam, dbet, dgc, dbc = grads
    tanh_yc = torch.tanh(yc)
    do = dh * tanh_yc
    dyc = dh * o * (1.0 - tanh_yc * tanh_yc)
    dgc += (dyc * xhat_c).sum(dim=0)
    dbc += dyc.sum(dim=0)
    dc = dc + (CF._ln_bwd_input(dyc, gc, xhat_c, r_c) if corrections
               else dyc * gc)
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
        parts.append(CF._ln_bwd_input(dys[j], gam[j], xhats[j], rs[j])
                     if corrections else dys[j] * gam[j])
    return torch.cat(parts, dim=-1), dc * f


def fwd_plain(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
              h0, x_bias=None, dropout_seed=None, keep_prob=1.0,
              forget_bias=1.0, residual_dtype=torch.bfloat16, teacher=None):
    """The plain version of forward arm ``arm``: ``(hs, cs, cT, hT)``;
    ``prod`` is ``cuda_fused.ln_lstm_fwd_reference``, operation for
    operation. ``teacher``: stored ``(hs, cs)`` of a run of the same arm
    (a kernel's); each step then starts from the stored carry (``cs[t]``,
    ``hs[t-1]`` or ``h0``) instead of its own, so every step is held on
    its own, whatever rounding gaps the recurrence would grow."""
    _refuse(arm, FWD_IDS)
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    w = CF._Weights(wx, wh)
    milli = CF._rnd(torch.tensor(1e-3, device=xs.device), wx.dtype)
    c, hh = c0, h0
    hs, cs = [], []
    for t in range(t_len):
        if teacher is not None:
            c = teacher[1][t].float()
            hh = teacher[0][t - 1].float() if t else h0
        if arm == "floor":
            x0 = CF._rnd(xs[t][:, :1], wx.dtype)
            new_c = c * 0.9 + CF._rnd(x0 * milli, wx.dtype)
            new_h = hh * 0.5 + (x_bias[:, :h] * 1e-3 if x_bias is not None
                                else c * 1e-3)
        else:
            pre = w.ln_pre(xs[t], hh, x_bias)
            if arm == "no_gates":
                new_c = c * 0.9 + pre[:, :h] * 0.1
                new_h = hh * 0.5 + pre[:, h:2 * h] * 0.1
            elif arm == "prod":
                m = CF._step_mask(None, dropout_seed, t, bsz, h, keep_prob)
                res = CF._ln_gates(pre, c, m, ln_gamma, ln_beta, lnc_gamma,
                                   lnc_beta, forget_bias)
                new_c, new_h = res[4], res[5]
            else:       # no_ln: _fake_ln_gates_fwd, the mask applied once
                m = CF._step_mask(None, dropout_seed, t, bsz, h, keep_prob)
                mean, r = _stand_in_stats(c)
                ys = [(pre[:, j * h:(j + 1) * h] - mean) * r * ln_gamma[j]
                      + ln_beta[j] for j in range(4)]
                g_u = torch.tanh(ys[1])
                new_c = (c * torch.sigmoid(ys[2] + forget_bias)
                         + torch.sigmoid(ys[0])
                         * (g_u * m if m is not None else g_u))
                yc = (new_c - mean) * r * lnc_gamma + lnc_beta
                new_h = torch.tanh(yc) * torch.sigmoid(ys[3])
        cs.append(c.to(residual_dtype))
        c, hh = new_c, new_h
        hs.append(hh.to(residual_dtype))
    return torch.stack(hs), torch.stack(cs), c, hh


def bwd_plain(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0,
              hs, cs, dhs, dcT, dhT, x_bias=None, dropout_seed=None,
              keep_prob=1.0, forget_bias=1.0):
    """The plain version of backward arm ``arm`` (one of ``ARMS`` or
    probe_ln_stats' ``fake``): ``(dxs, dxb, dwx, dwh, dgam, dbet, dgc,
    dbc, dc0, dh0)``, the weight gradients as float32 sums. ``prod`` is
    ``cuda_fused.ln_lstm_bwd_reference``."""
    _refuse(arm, BWD_IDS)
    ln = (ln_gamma, ln_beta, lnc_gamma, lnc_beta)
    if arm == "prod":
        return CF.ln_lstm_bwd_reference(
            xs, wx, wh, *ln, h0, hs, cs, dhs, dcT, dhT, forget_bias, None,
            dropout_seed, keep_prob, x_bias, f32_weight_grads=True)
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    st = CF._BwdStep(xs, wx, wh, h0, hs, cs, dhs)
    dxs = torch.empty(xs.shape, dtype=torch.float32, device=xs.device)
    dxb = torch.zeros_like(x_bias) if x_bias is not None else None
    grads = tuple(torch.zeros_like(p) for p in ln)
    dc, dh = dcT, dhT
    for s in range(t_len - 1, -1, -1):
        x, h_prev, c_prev, dh = st.operands(s, dh)
        if arm != "floor":
            pre = st.w.ln_pre(x, h_prev, x_bias)
        if arm in ("no_lnbwd", "no_ln", "fake"):
            m = CF._step_mask(None, dropout_seed, s, bsz, h, keep_prob)
            if arm == "no_lnbwd":
                res = CF._ln_gates(pre, c_prev, m, *ln, forget_bias)
            else:
                res = fake_ln_gates(pre, c_prev, *ln, forget_bias)
                if m is not None:   # the reference's ln_res[1] * m
                    res = (res[0], res[1] * m) + res[2:]
            d_pre, dc_next = gates_bwd(res, dh, dc, c_prev, m, ln_gamma,
                                       lnc_gamma, grads, arm == "fake")
        else:
            if arm == "floor":
                d_pre = dh.repeat(1, 4) + dc.repeat(1, 4) * 0.1
                if x_bias is not None:
                    d_pre = d_pre + x_bias
            else:       # no_gates, no_gradmm
                d_pre = pre * 0.25 + dh.repeat(1, 4) + dc.repeat(1, 4) * 0.1
            dc_next = dc * 0.9 + c_prev * 1e-3
        if dxb is not None:
            dxb += d_pre
        if arm in _WEIGHT_GRAD_ARMS:
            dxs[s], dh = st.products(x, h_prev, d_pre, True)
        else:
            dxs[s] = x * 0.5
            dh = (CF._rnd(d_pre, wx.dtype) @ st.w.whf.T if arm == "no_gradmm"
                  else dh * 0.5 + h_prev * 1e-3)
        dc = dc_next
    return (dxs, dxb, st.dwx, st.dwh, *grads, dc, dh)


# -- the kernels -------------------------------------------------------------


def fwd_arm(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0,
            x_bias=None, dropout_seed=None, keep_prob=1.0, forget_bias=1.0,
            residual_dtype=torch.bfloat16):
    """Forward arm ``arm`` of ``FWD_ARMS``: ``xs [T, B, D]``, ``wx [D,
    4H]`` and ``wh [H, 4H]`` of one weight dtype (float32 or bfloat16),
    the LN parameters, ``c0``/``h0 [B, H]``, ``x_bias [B, 4H]`` and the
    int32 ``dropout_seed`` (or None) float32/int32 as
    ``cuda_fused.ln_lstm_fwd`` takes them. Returns ``(hs, cs, cT, hT)``,
    ``hs``/``cs`` in ``residual_dtype``. The plain version on CPU
    tensors; on CUDA tensors the kernel, or a raise."""
    _refuse(arm, FWD_IDS)
    ln = (ln_gamma, ln_beta, lnc_gamma, lnc_beta)
    if xs.device.type == "cpu":
        return fwd_plain(arm, xs, wx, wh, *ln, c0, h0, x_bias, dropout_seed,
                         keep_prob, forget_bias, residual_dtype)
    dev, t, b, d, h, sp, wb = _probe.check_ln(xs, wx, wh, ln, x_bias,
                                              dropout_seed, c0, h0)
    rd = CF._residual(residual_dtype)
    hs = torch.empty((t, b, h), dtype=rd, device=dev)
    cs = torch.empty_like(hs)
    cT = torch.empty((b, h), dtype=torch.float32, device=dev)
    hT = torch.empty_like(cT)
    _probe.launch("srt_ln_probe_fwd", f"fwd_arm({arm})", FWD_IDS[arm],
                  xs.data_ptr(), CF._ptr(x_bias), wx.data_ptr(),
                  wh.data_ptr(), *(p.data_ptr() for p in ln), c0.data_ptr(),
                  h0.data_ptr(), sp, t, b, d, h, wb,
                  int(rd == torch.bfloat16), *CF._keep_args(keep_prob),
                  float(forget_bias), hs.data_ptr(), cs.data_ptr(),
                  cT.data_ptr(), hT.data_ptr(), CF._stream(dev), lib="probe_ln")
    _launches[f"fwd_{arm}"] += 1
    return hs, cs, cT, hT


def bwd_kernel(arm, counts, key, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma,
               lnc_beta, h0, hs, cs, dhs, dcT, dhT, x_bias=None,
               dropout_seed=None, keep_prob=1.0, forget_bias=1.0):
    """Launch backward arm ``arm`` (``BWD_IDS``) on CUDA tensors and add
    one to ``counts[key]``; the operands and results of
    :func:`bwd_arm`."""
    ln = (ln_gamma, ln_beta, lnc_gamma, lnc_beta)
    dev, t, b, d, h, sp, wb = _probe.check_ln(xs, wx, wh, ln, x_bias,
                                              dropout_seed, h0, h0)
    rb = CF._residuals_check(dev, t, b, h, hs, cs, dhs)
    CF._f32_check(dev, (("dcT", dcT, (b, h)), ("dhT", dhT, (b, h))))
    f32 = torch.float32
    # scratch: every step's d_pre (float32) for the weight-gradient pass,
    # each row's LN-parameter partials; only the arms that use them
    dpre = (torch.empty((t, b, 4 * h), dtype=f32, device=dev)
            if arm in _WEIGHT_GRAD_ARMS else None)
    part = (torch.empty((b, 10 * h), dtype=f32, device=dev)
            if arm in _LN_GRAD_ARMS else None)
    dxs = torch.empty_like(xs)
    dxb = torch.empty_like(x_bias) if x_bias is not None else None
    dwx = torch.empty(wx.shape, dtype=f32, device=dev)
    dwh = torch.empty(wh.shape, dtype=f32, device=dev)
    dln = torch.empty((10 * h,), dtype=f32, device=dev)
    dc0 = torch.empty((b, h), dtype=f32, device=dev)
    dh0 = torch.empty_like(dc0)
    # the weight pass's plan and partials, as srt_ln_lstm_bwd's (the
    # other arms run no weight pass)
    wg, wg_part = (CF._wg_scratch(t, b, d, h, 0, wx.dtype, dev)
                   if arm in _WEIGHT_GRAD_ARMS else ((0, 0, None), None))
    _probe.launch("srt_ln_probe_bwd", f"bwd_arm({arm})", BWD_IDS[arm],
                  xs.data_ptr(), CF._ptr(x_bias), wx.data_ptr(),
                  wh.data_ptr(), *(p.data_ptr() for p in ln), h0.data_ptr(),
                  hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
                  CF._ptr(dcT), CF._ptr(dhT), sp, t, b, d, h, wb, rb,
                  *CF._keep_args(keep_prob), float(forget_bias),
                  CF._ptr(dpre), CF._ptr(part), dxs.data_ptr(),
                  CF._ptr(dxb), dwx.data_ptr(), dwh.data_ptr(),
                  dln.data_ptr(), dc0.data_ptr(), dh0.data_ptr(), *wg,
                  CF._stream(dev), lib="probe_ln")
    counts[key] += 1
    return (dxs, dxb, dwx, dwh, dln[:4 * h].view(4, h),
            dln[4 * h:8 * h].view(4, h), dln[8 * h:9 * h], dln[9 * h:], dc0,
            dh0)


def bwd_arm(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs,
            cs, dhs, dcT, dhT, x_bias=None, dropout_seed=None, keep_prob=1.0,
            forget_bias=1.0):
    """Backward arm ``arm`` of ``ARMS`` over the stored ``hs``/``cs``/
    ``dhs [T, B, H]`` (one residual dtype) and the float32 carry
    cotangents ``dcT``/``dhT [B, H]``, the other operands as
    :func:`fwd_arm` takes them. Returns ``(dxs, dxb, dwx, dwh, dgam,
    dbet, dgc, dbc, dc0, dh0)``, all float32 (``dxb`` None without
    ``x_bias``; the weight gradients not rounded to the weight dtype).
    The plain version on CPU tensors; on CUDA tensors the kernel, or a
    raise."""
    _refuse(arm, ARMS)
    args = (xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs,
            dhs, dcT, dhT, x_bias, dropout_seed, keep_prob, forget_bias)
    if xs.device.type == "cpu":
        return bwd_plain(arm, *args)
    return bwd_kernel(arm, _launches, f"bwd_{arm}", *args)


# -- the ladders on the card -------------------------------------------------


def probe_inputs(b=4096, t=250, device="cuda", seed=0):
    """The reference's operands, seeded: ``xs ~ N(0, 1)`` rounded to
    bfloat16 (held as float32, exactly), bfloat16 ``wx ~ N(0, 0.3)`` and
    ``wh ~ N(0, 0.05)``, float32 ``x_bias ~ N(0, 0.1)``, unit gains and
    zero offsets, in-kernel dropout from seed 5 at keep 0.9, forget bias
    1; as keyword arguments of :func:`fwd_arm`/:func:`bwd_arm`."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    n = lambda *s: torch.randn(s, generator=g)
    dev = torch.device(device)
    return dict(xs=n(t, b, D).to(bf).float().to(dev),
                wx=(0.3 * n(D, 4 * H)).to(bf).to(dev),
                wh=(0.05 * n(H, 4 * H)).to(bf).to(dev),
                ln_gamma=torch.ones((4, H), device=dev),
                ln_beta=torch.zeros((4, H), device=dev),
                lnc_gamma=torch.ones((H,), device=dev),
                lnc_beta=torch.zeros((H,), device=dev),
                x_bias=(0.1 * n(b, 4 * H)).to(dev),
                dropout_seed=torch.tensor(5, dtype=torch.int32, device=dev),
                keep_prob=0.9, forget_bias=1.0)


def bwd_inputs(inp):
    """The backward arms' operands beside ``inp``: zero carries, the
    bfloat16 residuals of one production ``fused_ln_lstm`` forward
    (``cuda_fused.ln_lstm_fwd``), ``dhs = 1`` (bfloat16, exactly), zero
    carry cotangents."""
    t, b, _ = inp["xs"].shape
    z = torch.zeros((b, H), device=inp["xs"].device)
    hs, cs, _, _ = CF.ln_lstm_fwd(c0=z, h0=z, residual_dtype=torch.bfloat16,
                                  **inp)
    return dict(inp, h0=z, hs=hs, cs=cs, dhs=torch.ones_like(hs), dcT=z,
                dhT=z)


def glue_step(state, h0):
    """The reference's retired stream preparation, once: ``flip(cs)``,
    ``flip(cat(h0, hs[:-1]))``, ``flip(dhs)``, ``flip(dxs)``. ``state`` is
    ``(hs, cs, dhs, dxs)``; returns the next state (``hs`` and the three
    flipped streams) and the flipped ``h_prev``."""
    hs, cs, dhs, dxs = state
    rev = lambda a: torch.flip(a, dims=(0,))
    hp = torch.cat([h0[None].to(hs.dtype), hs[:-1]], dim=0)
    return (hs, rev(cs), rev(dhs), rev(dxs)), rev(hp)


def _record(kind, b, t, k, reps, ms, recheck, deltas, dev):
    return {"kind": kind, "device_kind": torch.cuda.get_device_name(dev),
            "batch_size": b, "seq_len": t, "H": H, "D": D, "tile": 1,
            "reps": reps, "calls_per_dispatch": k, "arms_ms": ms,
            "prod_recheck_ms": recheck, "deltas_ms": deltas}


def run_fwd_ladder(b=4096, t=250, k=2, reps=3, device="cuda"):
    """The forward ladder on the card; returns the record."""
    dev = torch.device(device)
    inp = probe_inputs(b, t, dev)
    z = torch.zeros((b, H), device=dev)
    calls = [lambda a=a: fwd_arm(a, c0=z, h0=z, **inp) for a in FWD_ARMS]
    production, _ = CF.ln_lstm_fwd_entries(
        c0=z, h0=z, residual_dtype=torch.bfloat16, **inp)
    times = _probe.interleaved(
        [*calls, lambda: production("srt_ln_lstm_fwd")], k, reps)
    ms = dict(zip(FWD_ARMS, times))
    recheck = _probe.interleaved(calls[:1], k, reps)[0]
    deltas = {"ln_stack": ms["prod"] - ms["no_ln"],
              "gate_transcendentals": ms["no_ln"] - ms["no_gates"],
              "matmuls_over_floor": ms["no_gates"] - ms["floor"],
              "dma_orchestration_floor_CAUTION": ms["floor"]}
    rec = _record("probe_dec_fwd_split", b, t, k, reps, ms, recheck,
                  deltas, dev)
    rec.update(prod_repeats="srt_ln_lstm_fwd_rowblock",
               production_entry="srt_ln_lstm_fwd", production_ms=times[-1])
    return rec


def run_bwd_ladder(b=4096, t=250, k=2, reps=3, device="cuda"):
    """The backward ladder and the glue arm on the card; returns the
    record."""
    dev = torch.device(device)
    inp = bwd_inputs(probe_inputs(b, t, dev))
    calls = [lambda a=a: bwd_arm(a, **inp) for a in ARMS]
    state = [(inp["hs"], inp["cs"], inp["dhs"],
              torch.zeros_like(inp["xs"]))]

    def glue():
        state[0] = glue_step(state[0], inp["h0"])[0]

    production, _ = CF.ln_lstm_bwd_entries(**inp)
    times = _probe.interleaved(
        [*calls, glue, lambda: production("srt_ln_lstm_bwd")], k, reps)
    ms = dict(zip((*ARMS, "glue"), times))
    recheck = _probe.interleaved(calls[:1], k, reps)[0]
    # as in the reference, no delta is taken from the zero-product floor
    # arm; no_gradmm (the recompute and serial dh products, the streams,
    # the step loop) is the base term
    deltas = {"ln_bwd_corrections": ms["prod"] - ms["no_lnbwd"],
              "ln_fwd_reductions": ms["no_lnbwd"] - ms["no_ln"],
              "gate_transcendentals": ms["no_ln"] - ms["no_gates"],
              "grad_weight_matmuls": ms["no_gates"] - ms["no_gradmm"],
              "base_serial_mm_dma_orchestration": ms["no_gradmm"]}
    rec = _record("probe_dec_bwd_split", b, t, k, reps, ms, recheck, deltas,
                  dev)
    rec.update(glue_ms=ms["glue"],
               floor_arm_uninterpretable=ms["floor"] >= ms["no_gradmm"],
               grid_scaling_ms=None, prod_repeats="srt_ln_lstm_bwd_rowblock",
               production_entry="srt_ln_lstm_bwd", production_ms=times[-1])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--k", type=int, default=2,
                    help="kernel calls per timing")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seq_len", type=int, default=250)
    ap.add_argument("--skip_grid", action="store_true",
                    help="accepted for the reference's command line; the "
                         "port has no grid-scaling arm")
    ap.add_argument("--fwd", action="store_true",
                    help="run the forward ladder instead")
    args = ap.parse_args(argv)
    run = run_fwd_ladder if args.fwd else run_bwd_ladder
    print(json.dumps(run(args.batch, args.seq_len, args.k, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
