"""Probe: the LayerNorm-LSTM recurrence split into measured terms, on the card.

The port of ``scripts/probe_dec_bwd_split.py``. A strictly nested ladder
of arms of the LayerNorm-LSTM kernels, each taking one term of work out
of the one before, so that the difference of two arms' times prices that
term. Every arm runs on the production kernels' persistent cooperative
loops (``csrc/ln_lstm.cuh``), its arm a compile-time policy of them, so
``prod`` IS the production kernel and each delta prices a term of the
design ``fused_ln_lstm`` runs. :func:`bwd_arm` (kernel
``srt_ln_probe_bwd`` of ``csrc/probe_ln.cu``) runs the backward arms:

- ``prod``: ``fused_ln_lstm``'s backward, bit for bit ``srt_ln_lstm_bwd``
  (the hoisted recompute, the statistics, the loop with three grid
  barriers a step, the LN sums' row sum, the weight pass);
- ``no_lnbwd``: the layer-norm backward's row-mean corrections elided
  (``d_pre = dy * gamma``); the LN-parameter sums kept; on the card the
  loop's two exchanges and their barriers go (one barrier a step);
- ``no_ln``: also the layer-norm statistics of the recomputed forward
  replaced by stand-ins (``mean = c_prev[:, 0] * 1e-3``, ``r = 1 +
  c_prev[:, 1] * 1e-3``), the reference's way: the stand-in forward
  builds the new cell state without the mask and hands the backward
  ``g_u * m``, which it masks again; on the card no statistics launch;
- ``no_gates``: ``d_pre = 0.25 pre + dh + 0.1 dc`` (each tiled over the
  four gates), ``dc' = 0.9 dc + 1e-3 c_prev``; every product kept, zero
  LN-parameter gradients;
- ``no_gradmm``: ``no_gates`` without the ``dwx``/``dwh``/``dx``
  products: ``dh_{t-1} = d_pre @ wh^T`` stays, ``dx = 0.5 x`` (the loop
  still writes ``d_pre`` to its scratch: its transposed product reads the
  other slices' through it);
- ``floor``: no products: ``d_pre = dh + 0.1 dc [+ x_bias]``,
  ``dh_{t-1} = 0.5 dh + 1e-3 h_prev``, ``dx = 0.5 x``; no barrier.

:func:`fwd_arm` (``srt_ln_probe_fwd``) runs the forward arms ``prod``
(bit for bit ``srt_ln_lstm_fwd``, three grid barriers a step), ``no_ln``
(the stand-in statistics, one barrier), ``no_gates`` (``c' = 0.9 c + 0.1
pre[:, :H]``, ``h' = 0.5 h + 0.1 pre[:, H:2H]``, one barrier) and
``floor`` (``c' = 0.9 c + x[:, :1] * 1e-3``, the product in the weight
dtype, ``h' = 0.5 h + 1e-3 x_bias[:, :H]``, no barrier). The arms are
op-count probes: their numbers are wrong by design, and the plain
versions beside the wrappers compute the same wrong numbers.
``csrc/probe_ln.cu``'s header says what each arm drops on Hopper;
:func:`fwd_plan` and :func:`bwd_plan` give each arm's barriers, launches
and scratch from the shape alone (the wrappers allocate what they name).
The row-block design the arms ran before (one block per batch row, wh
from L2 every step) stays reachable as ``srt_ln_probe_fwd_rowblock`` and
``srt_ln_probe_bwd_rowblock`` through the uncounted :func:`fwd_entries`
and :func:`bwd_entries`, its ``prod`` arms bit for bit the row-block
entries ``srt_ln_lstm_*_rowblock``.

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
Each ladder's record names the entry its ``prod`` arm is
(``prod_repeats``) and carries that production entry's own time beside
it (``production_entry``, ``production_ms``: ``srt_ln_lstm_fwd`` or
``srt_ln_lstm_bwd`` through the uncounted ``cuda_fused.*_entries``
helpers, timed in the same interleaving as the arms), which matches
``prod`` within noise. The reference's grid-scaling arm timed its batch
tiles (64/128/256); its counterpart, ``grid_scaling_ms``, times ``prod``
at 1, 2 and 4 forced windows of rows (the same work; each window T more
steps of grid barriers). :func:`main` prints the reference's record (its
keys and deltas, ``tile`` the loop's rows per batch tile, ``device_kind``
from the card). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.probe_dec_bwd_split [--fwd] \\
        [--reps 3] [--k 2] [--batch 4096] [--seq_len 250] [--skip_grid]

It prints and appends to no file.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import NamedTuple

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
GRID_WINDOWS = (1, 2, 4)  # prod's forced windows of rows (grid_scaling_ms)

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
#
# Every arm runs on the production kernels' persistent loops
# (csrc/ln_lstm.cuh): srt_ln_probe_fwd / srt_ln_probe_bwd, prod being
# srt_ln_lstm_fwd / srt_ln_lstm_bwd. The row-block design the arms ran
# before stays reachable, uncounted, through fwd_entries / bwd_entries
# (srt_ln_probe_*_rowblock).


class ArmPlan(NamedTuple):
    """What one arm of the persistent kernels runs a call and holds:
    ``barriers`` grid barriers a loop step; ``fixed_launches`` kernel
    launches besides the loop's one a window of rows; ``scratch``
    ``{name: (shape, dtype)}``, everything the wrapper allocates beside
    the outputs. From the shape alone."""
    barriers: int
    fixed_launches: int
    scratch: dict

    def launches(self, windows: int = 1) -> int:
        return self.fixed_launches + windows

    def scratch_bytes(self) -> int:
        return sum(math.prod(shape) * torch.empty(0, dtype=dt).element_size()
                   for shape, dt in self.scratch.values())


def fwd_plan(arm, t, b, d, h, w_dtype=torch.bfloat16) -> ArmPlan:
    """Forward arm ``arm`` at ``T, B, D, H`` and weight dtype ``w_dtype``:
    one launch a window. ``prod``: production's ``[2, B, H]`` ``h``
    exchange and its work (``cuda_fused.ln_fwd_work_floats``), three
    barriers a step; ``no_ln`` the exchange and a ``[2, B, 2]`` one for
    its stand-ins, ``no_gates`` the exchange and its float ``h`` carry
    ``[B, H]``, one barrier each; ``floor`` nothing, no barrier."""
    _refuse(arm, FWD_IDS)
    scratch = {}
    if arm != "floor":
        scratch["hx"] = ((2, b, h), w_dtype)
    work = {"prod": CF.ln_fwd_work_floats(b, h), "no_ln": 4 * b,
            "no_gates": b * h}.get(arm, 0)
    if work:
        scratch["work"] = ((work,), torch.float32)
    return ArmPlan({"prod": 3, "floor": 0}.get(arm, 1), 0, scratch)


def bwd_plan(arm, t, b, d, h, w_dtype=torch.bfloat16) -> ArmPlan:
    """Backward arm ``arm`` (``BWD_IDS``): production's launches (the
    recompute, the statistics, the loop, the LN sums' row sum, the
    weight pass's two) less what the arm takes out, and only the scratch
    it uses: ``d_pre`` (every arm but ``floor``: ``no_gradmm``'s
    transposed product reads the other slices' through it), the LN
    partials (the arms with the gate block), the work (``prod``: the
    exchanges, the statistics and the ``dxh`` stash; ``fake`` the
    exchanges and the stash; ``no_lnbwd`` the statistics), the weight
    pass's partials (the arms with the pass). The arms without the
    weight pass or the LN sums write those outputs as zeros by
    ``cudaMemsetAsync``, no kernel."""
    _refuse(arm, BWD_IDS)
    f32 = torch.float32
    slices = -(-h // CF.LN_UNITS)
    gates = arm in _LN_GRAD_ARMS
    stats = arm in ("prod", "no_lnbwd")
    exchanges = arm in ("prod", "fake")
    weight = arm in _WEIGHT_GRAD_ARMS
    scratch = {}
    if arm != "floor":
        scratch["dpre"] = ((t, b, 4 * h), f32)
    if gates:
        scratch["part"] = ((b, 10 * h), f32)
    work = ((slices * 10 + 4 * h) * b if exchanges else 0) + (
        t * 10 * b if stats else 0)
    if work:
        scratch["work"] = ((work,), f32)
    if weight:
        p = CF.weight_grad_plan(t, b, d, h, 0, w_dtype)
        scratch["wg_part"] = ((p.slices, d + h, 4 * h), f32)
    fixed = int(arm != "floor") + stats + gates + 2 * weight
    barriers = 3 if exchanges else 0 if arm == "floor" else 1
    return ArmPlan(barriers, fixed, scratch)


def _alloc(plan, dev):
    return {n: torch.empty(shape, dtype=dt, device=dev)
            for n, (shape, dt) in plan.scratch.items()}


def _fwd_args(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
              h0, x_bias, dropout_seed, keep_prob, forget_bias,
              residual_dtype, windows):
    """Check a forward arm's operands and allocate its outputs and its
    plan's scratch: ``(new, old, outs, scratch)``, the arguments of
    ``srt_ln_probe_fwd`` and of ``srt_ln_probe_fwd_rowblock``, ``(hs, cs,
    cT, hT)`` and the scratch, which the caller keeps alive while the
    launches use it."""
    ln = (ln_gamma, ln_beta, lnc_gamma, lnc_beta)
    dev, t, b, d, h, sp, wb = _probe.check_ln(xs, wx, wh, ln, x_bias,
                                              dropout_seed, c0, h0)
    rd = CF._residual(residual_dtype)
    hs = torch.empty((t, b, h), dtype=rd, device=dev)
    cs = torch.empty_like(hs)
    cT = torch.empty((b, h), dtype=torch.float32, device=dev)
    hT = torch.empty_like(cT)
    scratch = _alloc(fwd_plan(arm, t, b, d, h, wx.dtype), dev)
    head = (FWD_IDS[arm], xs.data_ptr(), CF._ptr(x_bias), wx.data_ptr(),
            wh.data_ptr(), *(p.data_ptr() for p in ln), c0.data_ptr(),
            h0.data_ptr(), sp, t, b, d, h, wb, int(rd == torch.bfloat16),
            *CF._keep_args(keep_prob), float(forget_bias), hs.data_ptr(),
            cs.data_ptr(), cT.data_ptr(), hT.data_ptr())
    st = CF._stream(dev)
    new = (*head, CF._ptr(scratch.get("hx")), CF._ptr(scratch.get("work")),
           int(windows), st)
    return new, (*head, st), (hs, cs, cT, hT), scratch


def fwd_arm(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0,
            x_bias=None, dropout_seed=None, keep_prob=1.0, forget_bias=1.0,
            residual_dtype=torch.bfloat16, windows=0):
    """Forward arm ``arm`` of ``FWD_ARMS``: ``xs [T, B, D]``, ``wx [D,
    4H]`` and ``wh [H, 4H]`` of one weight dtype (float32 or bfloat16),
    the LN parameters, ``c0``/``h0 [B, H]``, ``x_bias [B, 4H]`` and the
    int32 ``dropout_seed`` (or None) float32/int32 as
    ``cuda_fused.ln_lstm_fwd`` takes them. Returns ``(hs, cs, cT, hT)``,
    ``hs``/``cs`` in ``residual_dtype``. The plain version on CPU
    tensors; on CUDA tensors the kernel (``windows``: 0 for production's
    windows of rows, else that many), or a raise."""
    _refuse(arm, FWD_IDS)
    ln = (ln_gamma, ln_beta, lnc_gamma, lnc_beta)
    if xs.device.type == "cpu":
        return fwd_plain(arm, xs, wx, wh, *ln, c0, h0, x_bias, dropout_seed,
                         keep_prob, forget_bias, residual_dtype)
    new, _, outs, _scratch = _fwd_args(arm, xs, wx, wh, *ln, c0, h0, x_bias,
                                       dropout_seed, keep_prob, forget_bias,
                                       residual_dtype, windows)
    _probe.launch("srt_ln_probe_fwd", f"fwd_arm({arm})", *new, lib="probe_ln")
    _launches[f"fwd_{arm}"] += 1
    return outs


def fwd_entries(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
                h0, x_bias=None, dropout_seed=None, keep_prob=1.0,
                forget_bias=1.0, residual_dtype=torch.bfloat16, windows=0):
    """The C entries of forward arm ``arm`` on CUDA tensors, for the A/B of
    its two designs; no wrapper calls it, and it counts no launch.
    Returns ``(run, outs)``: ``run(entry)`` launches ``"srt_ln_probe_fwd"``
    (the persistent loop) or ``"srt_ln_probe_fwd_rowblock"`` (the
    row-block design it replaced) on one set of buffers, and keeps the
    inputs alive; ``outs`` as the last launch left them."""
    from sketch_rnn_tpu_torch.ops import _build

    CF._entries_on_cuda("fwd_entries", xs)
    _refuse(arm, FWD_IDS)
    held = (xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0,
            x_bias, dropout_seed)
    new, old, outs, scratch = _fwd_args(arm, *held[:9], x_bias,
                                        dropout_seed, keep_prob,
                                        forget_bias, residual_dtype, windows)
    lib = _build.load("probe_ln")
    args = {"srt_ln_probe_fwd": new, "srt_ln_probe_fwd_rowblock": old}

    def run(entry, _held=(held, scratch)):   # holds the scratch and inputs
        _build.check(lib, getattr(lib, entry)(*args[entry]), entry)

    return run, outs


def _bwd_args(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0,
              hs, cs, dhs, dcT, dhT, x_bias, dropout_seed, keep_prob,
              forget_bias, windows):
    """Check a backward arm's operands and allocate its outputs and its
    plan's scratch (which holds the row-block design's too): ``(new, old,
    outs, scratch)`` as :func:`_fwd_args`'s."""
    ln = (ln_gamma, ln_beta, lnc_gamma, lnc_beta)
    dev, t, b, d, h, sp, wb = _probe.check_ln(xs, wx, wh, ln, x_bias,
                                              dropout_seed, h0, h0)
    rb = CF._residuals_check(dev, t, b, h, hs, cs, dhs)
    CF._f32_check(dev, (("dcT", dcT, (b, h)), ("dhT", dhT, (b, h))))
    f32 = torch.float32
    plan = bwd_plan(arm, t, b, d, h, wx.dtype)
    scratch = _alloc(plan, dev)
    dxs = torch.empty_like(xs)
    dxb = torch.empty_like(x_bias) if x_bias is not None else None
    dwx = torch.empty(wx.shape, dtype=f32, device=dev)
    dwh = torch.empty(wh.shape, dtype=f32, device=dev)
    dln = torch.empty((10 * h,), dtype=f32, device=dev)
    dc0 = torch.empty((b, h), dtype=f32, device=dev)
    dh0 = torch.empty_like(dc0)
    wg = (0, 0, None)
    if "wg_part" in scratch:
        p = CF.weight_grad_plan(t, b, d, h, 0, wx.dtype)
        wg = (p.slices, p.kslice, scratch["wg_part"].data_ptr())
    head = (BWD_IDS[arm], xs.data_ptr(), CF._ptr(x_bias), wx.data_ptr(),
            wh.data_ptr(), *(p.data_ptr() for p in ln), h0.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(), CF._ptr(dcT),
            CF._ptr(dhT), sp, t, b, d, h, wb, rb, *CF._keep_args(keep_prob),
            float(forget_bias), CF._ptr(scratch.get("dpre")),
            CF._ptr(scratch.get("part")))
    tail = (dxs.data_ptr(), CF._ptr(dxb), dwx.data_ptr(), dwh.data_ptr(),
            dln.data_ptr(), dc0.data_ptr(), dh0.data_ptr(), *wg)
    st = CF._stream(dev)
    new = (*head, CF._ptr(scratch.get("work")), *tail, int(windows), st)
    outs = (dxs, dxb, dwx, dwh, dln[:4 * h].view(4, h),
            dln[4 * h:8 * h].view(4, h), dln[8 * h:9 * h], dln[9 * h:], dc0,
            dh0)
    return new, (*head, *tail, st), outs, scratch


def bwd_kernel(arm, counts, key, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma,
               lnc_beta, h0, hs, cs, dhs, dcT, dhT, x_bias=None,
               dropout_seed=None, keep_prob=1.0, forget_bias=1.0, windows=0):
    """Launch backward arm ``arm`` (``BWD_IDS``) on CUDA tensors and add
    one to ``counts[key]``; the operands and results of
    :func:`bwd_arm`."""
    new, _, outs, _scratch = _bwd_args(
        arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs,
        dhs, dcT, dhT, x_bias, dropout_seed, keep_prob, forget_bias, windows)
    _probe.launch("srt_ln_probe_bwd", f"bwd_arm({arm})", *new,
                  lib="probe_ln")
    counts[key] += 1
    return outs


def bwd_arm(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs,
            cs, dhs, dcT, dhT, x_bias=None, dropout_seed=None, keep_prob=1.0,
            forget_bias=1.0, windows=0):
    """Backward arm ``arm`` of ``ARMS`` over the stored ``hs``/``cs``/
    ``dhs [T, B, H]`` (one residual dtype) and the float32 carry
    cotangents ``dcT``/``dhT [B, H]``, the other operands as
    :func:`fwd_arm` takes them. Returns ``(dxs, dxb, dwx, dwh, dgam,
    dbet, dgc, dbc, dc0, dh0)``, all float32 (``dxb`` None without
    ``x_bias``; the weight gradients not rounded to the weight dtype).
    The plain version on CPU tensors; on CUDA tensors the kernel
    (``windows`` as :func:`fwd_arm`'s), or a raise."""
    _refuse(arm, ARMS)
    args = (xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs,
            dhs, dcT, dhT, x_bias, dropout_seed, keep_prob, forget_bias)
    if xs.device.type == "cpu":
        return bwd_plain(arm, *args)
    return bwd_kernel(arm, _launches, f"bwd_{arm}", *args, windows=windows)


def bwd_entries(arm, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0,
                hs, cs, dhs, dcT, dhT, x_bias=None, dropout_seed=None,
                keep_prob=1.0, forget_bias=1.0, windows=0):
    """The C entries of backward arm ``arm`` (``BWD_IDS``, ``fake``
    included) on CUDA tensors, as :func:`fwd_entries`: ``run(entry)``
    launches ``"srt_ln_probe_bwd"`` or ``"srt_ln_probe_bwd_rowblock"``;
    uncounted."""
    from sketch_rnn_tpu_torch.ops import _build

    CF._entries_on_cuda("bwd_entries", xs)
    _refuse(arm, BWD_IDS)
    held = (xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs,
            dhs, dcT, dhT, x_bias, dropout_seed)
    new, old, outs, scratch = _bwd_args(arm, *held, keep_prob, forget_bias,
                                        windows)
    lib = _build.load("probe_ln")
    args = {"srt_ln_probe_bwd": new, "srt_ln_probe_bwd_rowblock": old}

    def run(entry, _held=(held, scratch)):   # holds the scratch and inputs
        _build.check(lib, getattr(lib, entry)(*args[entry]), entry)

    return run, outs


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


def batch_tile(b, dev):
    """Rows per batch tile of the loops at ``B`` rows on ``dev``'s card:
    slices of ``LN_UNITS`` units, as many tiles as fill its SMs once
    (``csrc/lstm_loops.cuh`` ``loop_grid``)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = min(b, max(1, sms // -(-H // CF.LN_UNITS)))
    return -(-b // tiles)


def _record(kind, b, t, k, reps, ms, recheck, deltas, dev):
    return {"kind": kind, "device_kind": torch.cuda.get_device_name(dev),
            "batch_size": b, "seq_len": t, "H": H, "D": D,
            "tile": batch_tile(b, dev),
            "reps": reps, "calls_per_dispatch": k, "arms_ms": ms,
            "prod_recheck_ms": recheck, "deltas_ms": deltas}


def run_fwd_ladder(b=4096, t=250, k=2, reps=3, device="cuda"):
    """The forward ladder on the card; returns the record. ``prod`` is
    the production kernel, so ``production_ms`` (``srt_ln_lstm_fwd``
    through ``cuda_fused.ln_lstm_fwd_entries``, in the same turns) should
    match it within noise. ``grid_scaling_ms``: ``prod`` at each of
    ``GRID_WINDOWS`` forced windows of rows (``{windows: ms}``), the same
    work, each window T more steps of three grid barriers."""
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
    scaling = _probe.interleaved(
        [lambda n=n: fwd_arm("prod", c0=z, h0=z, windows=n, **inp)
         for n in GRID_WINDOWS], k, reps)
    deltas = {"ln_stack": ms["prod"] - ms["no_ln"],
              "gate_transcendentals": ms["no_ln"] - ms["no_gates"],
              "matmuls_over_floor": ms["no_gates"] - ms["floor"],
              "dma_orchestration_floor_CAUTION": ms["floor"]}
    rec = _record("probe_dec_fwd_split", b, t, k, reps, ms, recheck,
                  deltas, dev)
    rec.update(grid_scaling_ms=dict(zip(GRID_WINDOWS, scaling)),
               prod_repeats="srt_ln_lstm_fwd",
               production_entry="srt_ln_lstm_fwd", production_ms=times[-1])
    return rec


def run_bwd_ladder(b=4096, t=250, k=2, reps=3, device="cuda"):
    """The backward ladder and the glue arm on the card; returns the
    record. ``production_ms`` and ``grid_scaling_ms`` as
    :func:`run_fwd_ladder`'s, for ``srt_ln_lstm_bwd``: the reference's
    grid-scaling arm timed its batch tiles (64, 128, 256), the port
    times its windows of rows."""
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
    scaling = _probe.interleaved(
        [lambda n=n: bwd_arm("prod", windows=n, **inp)
         for n in GRID_WINDOWS], k, reps)
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
               grid_scaling_ms=dict(zip(GRID_WINDOWS, scaling)),
               prod_repeats="srt_ln_lstm_bwd",
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
                         "grid-scaling runs always run")
    ap.add_argument("--fwd", action="store_true",
                    help="run the forward ladder instead")
    args = ap.parse_args(argv)
    run = run_fwd_ladder if args.fwd else run_bwd_ladder
    print(json.dumps(run(args.batch, args.seq_len, args.k, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
