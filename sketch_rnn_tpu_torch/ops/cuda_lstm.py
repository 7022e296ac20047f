"""The cuDNN-layout LSTM with a reserve space: :func:`lstm_seq`.

The port of ``sketch_rnn_tpu/ops/pallas_lstm.py``. The inputs are
projected outside for all steps at once (``xp = LSTMCell.
precompute_inputs(params, xs)``, one large product), and the kernel runs
only the recurrent ``h @ wh`` and the gate block: the hand-fused form of
``run_rnn(hoist=True)`` over an LSTM cell. Training keeps cuDNN's
"reserve space": the forward saves the post-activation gates ``[T, B,
4H]`` (``i``, the UNMASKED candidate ``g``, ``f``, ``o``) and the
pre-step cell states ``cs``, and the backward walks time backwards from
them without recomputing a product. Gate order ``(i, g, f, o)``; the
forget bias is added to ``f`` here, as ``LSTMCell`` does; recurrent
dropout multiplies the candidate by streamed masks ``[T, B, H]``
(``ops/rnn.py::make_dropout_masks``), which get no gradient. float32
only, as the TPU kernel is.

Two hand-written CUDA kernels (``csrc/lstm_seq.cu``) replace the Pallas
pair: ``srt_lstm_seq_fwd`` the forward ``_fwd_kernel``,
``srt_lstm_seq_bwd`` the backward ``_bwd_kernel``. Both run on the
persistent weight-resident loops of ``csrc/lstm_loops.cuh``, which the
fused LSTM of ``cuda_fused`` runs too: the forward with the ``xp`` row
streamed and the gate reserve stored, bit for bit the row-block design
it replaced; the backward's loop from the stored gates (no recompute),
then ``dwh`` by the fixed-order split-K weight pass of
``csrc/weight_grad.cuh`` on the plan of ``cuda_fused.weight_grad_plan``:
no atomics. Beside them are their plain PyTorch versions,
:func:`lstm_seq_fwd_plain` and :func:`lstm_seq_bwd_plain`, which repeat
the Pallas bodies step by step. The wrappers :func:`lstm_seq_fwd` /
:func:`lstm_seq_bwd` take the plain version for CPU tensors; on CUDA
tensors they launch the kernel or raise, and count each launch.

The A/B helpers :func:`lstm_seq_fwd_entries` and
:func:`lstm_seq_bwd_entries` drive the C entries on CUDA tensors only,
uncounted and called by no wrapper: the loops, the row-block design they
replaced (``srt_lstm_seq_fwd_rowblock``, ``srt_lstm_seq_bwd_rowblock``)
and, backwards, one launch alone (``srt_lstm_seq_bwd_stage``: 1 the loop,
2 the weight pass), each on one set of buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sketch_rnn_tpu_torch.ops.cuda_decode import _require
from sketch_rnn_tpu_torch.ops.cuda_fused import (MAX_HIDDEN,
                                                 _entries_on_cuda, _ptr,
                                                 _stream, _wg_scratch)

_launches = {"lstm_seq_fwd": 0, "lstm_seq_bwd": 0}


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> dict:
    return dict(_launches)


# -- plain PyTorch versions -------------------------------------------------


def lstm_seq_fwd_plain(xp, wh, c0, h0, forget_bias=1.0, masks=None):
    """The forward, step by step as ``pallas_lstm._fwd_kernel``: ``(hs,
    cT, hT, gates, cs)``, ``gates`` the post-activation ``(i, g_u, f, o)``
    with ``g`` unmasked, ``cs`` the pre-step cell states."""
    h = wh.shape[0]
    c, hh = c0, h0
    hs, gates, cs = [], [], []
    for t in range(xp.shape[0]):
        pre = xp[t] + hh @ wh
        i = torch.sigmoid(pre[:, :h])
        g_u = torch.tanh(pre[:, h:2 * h])
        g = g_u * masks[t] if masks is not None else g_u
        f = torch.sigmoid(pre[:, 2 * h:3 * h] + forget_bias)
        o = torch.sigmoid(pre[:, 3 * h:])
        gates.append(torch.cat([i, g_u, f, o], dim=-1))
        cs.append(c)
        c = c * f + i * g
        hh = torch.tanh(c) * o
        hs.append(hh)
    return torch.stack(hs), c, hh, torch.stack(gates), torch.stack(cs)


def lstm_seq_bwd_plain(wh, gates, cs, h_prev, masks, dhs, dcT, dhT):
    """The backward, step by step as ``pallas_lstm._bwd_kernel`` from the
    reserve (``h_prev = [h0, hs[:-1]]``): ``(dxp, dwh, dc0, dh0)``; ``dwh``
    summed over the steps from ``T-1`` down to 0."""
    h = wh.shape[0]
    dh, dc = dhT, dcT
    dwh = torch.zeros_like(wh)
    dxp = [None] * gates.shape[0]
    for t in range(gates.shape[0] - 1, -1, -1):
        dh = dh + dhs[t]
        i, g_u = gates[t, :, :h], gates[t, :, h:2 * h]
        f, o = gates[t, :, 2 * h:3 * h], gates[t, :, 3 * h:]
        g = g_u * masks[t] if masks is not None else g_u
        c_prev = cs[t]
        tanh_c = torch.tanh(c_prev * f + i * g)
        do = dh * tanh_c
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        df = dc * c_prev
        di = dc * g
        dg_u = dc * i
        if masks is not None:
            dg_u = dg_u * masks[t]
        d_pre = torch.cat([di * i * (1.0 - i), dg_u * (1.0 - g_u * g_u),
                           df * f * (1.0 - f), do * o * (1.0 - o)], dim=-1)
        dxp[t] = d_pre
        dh = d_pre @ wh.T
        dwh = dwh + h_prev[t].T @ d_pre
        dc = dc * f
    return torch.stack(dxp), dwh, dc, dh


# -- the kernels ------------------------------------------------------------


def _launch(entry, what, counter, *args):
    from sketch_rnn_tpu_torch.ops import _build

    lib = _build.load("lstm_seq")
    _build.check(lib, getattr(lib, entry)(*args), what)
    _launches[counter] += 1


def _shapes(xp_or_gates, wh):
    dev = xp_or_gates.device
    if dev.type != "cuda":
        raise ValueError(f"lstm_seq runs on CUDA or CPU tensors, not {dev}")
    t, b, _ = xp_or_gates.shape
    h = wh.shape[0]
    if not 0 < h <= MAX_HIDDEN:
        raise ValueError(f"hidden size {h}: the lstm_seq kernels take at "
                         f"most {MAX_HIDDEN} hidden units")
    return dev, t, b, h


def _fwd_args(xp, wh, c0, h0, forget_bias, masks):
    """Check the forward's inputs and allocate its outputs and its ``hx``
    scratch: ``(args, outs, hx)``, the arguments of the
    ``srt_lstm_seq_fwd*`` entries, ``(hs, cT, hT, gates, cs)`` and the
    ``[2, B, H]`` float scratch through which the loop's blocks exchange
    ``h``, which the caller keeps alive while the launches use it."""
    dev, t, b, h = _shapes(xp, wh)
    f32 = torch.float32
    for n, x, shape in (("xp", xp, (t, b, 4 * h)), ("wh", wh, (h, 4 * h)),
                        ("c0", c0, (b, h)), ("h0", h0, (b, h))):
        _require(n, x, dev, f32, shape)
    if masks is not None:
        _require("masks", masks, dev, f32, (t, b, h))
    hs = torch.empty((t, b, h), dtype=f32, device=dev)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(xp)
    cT = torch.empty((b, h), dtype=f32, device=dev)
    hT = torch.empty_like(cT)
    hx = torch.empty((2, b, h), dtype=f32, device=dev)
    args = (xp.data_ptr(), wh.data_ptr(), c0.data_ptr(), h0.data_ptr(),
            _ptr(masks), t, b, h, float(forget_bias), hs.data_ptr(),
            cT.data_ptr(), hT.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            hx.data_ptr(), _stream(dev))
    return args, (hs, cT, hT, gates, cs), hx


def lstm_seq_fwd(xp, wh, c0, h0, forget_bias=1.0, masks=None):
    """Forward of :func:`lstm_seq`: ``(hs, cT, hT, gates, cs)`` (kernel
    ``srt_lstm_seq_fwd``, the cooperative loop); every operand float32
    and contiguous."""
    if xp.device.type == "cpu":
        return lstm_seq_fwd_plain(xp, wh, c0, h0, forget_bias, masks)
    args, outs, _hx = _fwd_args(xp, wh, c0, h0, forget_bias, masks)
    _launch("srt_lstm_seq_fwd", "lstm_seq forward", "lstm_seq_fwd", *args)
    return outs


def _bwd_args(wh, gates, cs, hs, h0, masks, dhs, dcT, dhT):
    """Check the backward's inputs and allocate its outputs and the weight
    pass's scratch: ``(args, outs, part)``, the arguments of the
    ``srt_lstm_seq_bwd*`` entries (without the stage), ``(dxp, dwh, dc0,
    dh0)`` and the partials scratch, which the caller keeps alive while
    the launches use it."""
    dev, t, b, h = _shapes(gates, wh)
    f32 = torch.float32
    for n, x, shape in (("wh", wh, (h, 4 * h)), ("gates", gates,
                                                  (t, b, 4 * h)),
                        ("cs", cs, (t, b, h)), ("hs", hs, (t, b, h)),
                        ("h0", h0, (b, h)), ("dhs", dhs, (t, b, h)),
                        ("dcT", dcT, (b, h)), ("dhT", dhT, (b, h))):
        _require(n, x, dev, f32, shape)
    if masks is not None:
        _require("masks", masks, dev, f32, (t, b, h))
    dxp = torch.empty_like(gates)
    dwh = torch.empty_like(wh)
    dc0 = torch.empty((b, h), dtype=f32, device=dev)
    dh0 = torch.empty_like(dc0)
    wg, part = _wg_scratch(t, b, 0, h, 0, f32, dev)  # dwh's partials
    args = (wh.data_ptr(), gates.data_ptr(), cs.data_ptr(), hs.data_ptr(),
            h0.data_ptr(), _ptr(masks), dhs.data_ptr(), dcT.data_ptr(),
            dhT.data_ptr(), t, b, h, dxp.data_ptr(), dwh.data_ptr(),
            dc0.data_ptr(), dh0.data_ptr(), *wg, _stream(dev))
    return args, (dxp, dwh, dc0, dh0), part


def lstm_seq_bwd(wh, gates, cs, hs, h0, masks, dhs, dcT, dhT):
    """Backward of :func:`lstm_seq`: ``(dxp, dwh, dc0, dh0)`` (kernel
    ``srt_lstm_seq_bwd``: the cooperative loop over the reserve, then the
    fixed-order ``dwh`` reduction, ``h_{t-1}`` read from ``hs``/``h0`` in
    place)."""
    if gates.device.type == "cpu":
        h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
        return lstm_seq_bwd_plain(wh, gates, cs, h_prev, masks, dhs, dcT,
                                  dhT)
    args, outs, _part = _bwd_args(wh, gates, cs, hs, h0, masks, dhs, dcT,
                                  dhT)
    _launch("srt_lstm_seq_bwd", "lstm_seq backward", "lstm_seq_bwd", *args)
    return outs


# -- the A/B helpers ----------------------------------------------------------


def lstm_seq_fwd_entries(xp, wh, c0, h0, forget_bias=1.0, masks=None):
    """The C entries behind :func:`lstm_seq_fwd` on CUDA tensors, for the
    A/B of the forward's two designs; no wrapper calls it, and it counts
    no launch. Returns ``(run, outs)``: ``run(entry)`` launches
    ``"srt_lstm_seq_fwd"`` (the cooperative loop) or
    ``"srt_lstm_seq_fwd_rowblock"`` (the row-block design it replaced) on
    one set of buffers, and keeps the inputs alive (the entries take raw
    addresses); ``outs`` are ``(hs, cT, hT, gates, cs)`` as the last
    launch left them."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("lstm_seq_fwd_entries", xp)
    args, outs, hx = _fwd_args(xp, wh, c0, h0, forget_bias, masks)
    lib = _build.load("lstm_seq")
    held = (hx, xp, wh, c0, h0, masks)

    def run(entry, _held=held):     # holds the scratch and the inputs
        _build.check(lib, getattr(lib, entry)(*args), entry)

    return run, outs


def lstm_seq_bwd_entries(wh, gates, cs, hs, h0, masks, dhs, dcT, dhT):
    """The C entries behind :func:`lstm_seq_bwd` on CUDA tensors, for the
    A/B of the backward's two designs; no wrapper calls it, and it counts
    no launch. Returns ``(run, outs)``: ``run(entry, stage=0)`` launches
    ``"srt_lstm_seq_bwd"`` (the loop, then the weight pass),
    ``"srt_lstm_seq_bwd_rowblock"`` (the row-block design it replaced,
    then the same weight pass) or, with ``stage`` 1 or 2,
    ``"srt_lstm_seq_bwd_stage"`` (the loop or the weight pass alone), all
    on one set of buffers, and keeps the inputs alive; ``outs`` are
    ``(dxp, dwh, dc0, dh0)`` as the last launches left them."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("lstm_seq_bwd_entries", gates)
    args, outs, part = _bwd_args(wh, gates, cs, hs, h0, masks, dhs, dcT,
                                 dhT)
    lib = _build.load("lstm_seq")
    held = (part, wh, gates, cs, hs, h0, masks, dhs, dcT, dhT)

    def run(entry, stage=0, _held=held):   # holds the scratch and inputs
        pre = (stage,) if entry == "srt_lstm_seq_bwd_stage" else ()
        _build.check(lib, getattr(lib, entry)(*pre, *args), entry)

    return run, outs


# -- the autograd Function --------------------------------------------------


class _LSTMSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xp, wh, c0, h0, masks, forget_bias):
        hs, cT, hT, gates, cs = lstm_seq_fwd(xp, wh, c0, h0, forget_bias,
                                             masks)
        ctx.save_for_backward(wh, gates, cs, hs, h0, masks)
        return hs, cT, hT

    @staticmethod
    def backward(ctx, dhs, dcT, dhT):
        wh, gates, cs, hs, h0, masks = ctx.saved_tensors
        dxp, dwh, dc0, dh0 = lstm_seq_bwd(
            wh, gates, cs, hs, h0, masks, dhs.contiguous(), dcT.contiguous(),
            dhT.contiguous())
        return dxp, dwh, dc0, dh0, None, None


def lstm_seq(xp: torch.Tensor, wh: torch.Tensor, c0: torch.Tensor,
             h0: torch.Tensor, forget_bias: float = 1.0,
             masks: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused LSTM over a whole sequence of precomputed input projections.

    ``xp [T, B, 4H]`` (``x @ wx + b``), ``wh [H, 4H]``, carries ``c0, h0
    [B, H]``, optional ``masks [T, B, H]`` on the candidate; all float32.
    Returns ``(hs [T, B, H], (cT, hT))``. Every input but the masks is
    differentiated."""
    hs, cT, hT = _LSTMSeq.apply(xp, wh, c0, h0, masks, float(forget_bias))
    return hs, (cT, hT)
