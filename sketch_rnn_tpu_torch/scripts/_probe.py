"""What the probe scripts share: the kernel libraries' launch, operand
checks, the interleaved A/B timing by CUDA events."""

from __future__ import annotations

import statistics

import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.ops.cuda_decode import _require
from sketch_rnn_tpu_torch.ops.cuda_fused import MAX_HIDDEN, WEIGHT_DTYPES


def launch(entry, what, *args, lib="probe_seq"):
    """Call ``entry`` of the library ``lib`` (``probe_seq`` or
    ``probe_ln``) and raise on a refused launch."""
    from sketch_rnn_tpu_torch.ops import _build

    lib = _build.load(lib)
    _build.check(lib, getattr(lib, entry)(*args), what)


def check_direction(dev, t, b, d, xs, wx, bias, wh):
    """One direction's operands: ``xs [T, B, D]`` and ``bias [4H]``
    float32, ``wx [D, 4H]`` and ``wh [H, 4H]`` of one weight dtype;
    returns ``(h, w_bf16)``."""
    if dev.type != "cuda":
        raise ValueError(f"the probe kernels run on CUDA or CPU tensors, "
                         f"not {dev}")
    h = wh.shape[0]
    if not 0 < h <= MAX_HIDDEN:
        raise ValueError(f"hidden size {h}: the probe kernels hold one "
                         f"thread per hidden unit, at most {MAX_HIDDEN}")
    if wx.dtype not in WEIGHT_DTYPES:
        raise TypeError(f"wx has dtype {wx.dtype}: the probe kernels take "
                        f"weights in {WEIGHT_DTYPES}")
    f32 = torch.float32
    for n, x, dt, shape in (("xs", xs, f32, (t, b, d)),
                            ("wx", wx, wx.dtype, (d, 4 * h)),
                            ("b", bias, f32, (4 * h,)),
                            ("wh", wh, wx.dtype, (h, 4 * h))):
        _require(n, x, dev, dt, shape)
    return h, int(wx.dtype == torch.bfloat16)


def check_ln(xs, wx, wh, ln, x_bias, seed, c0, h0):
    """The LayerNorm ladder's operands (``csrc/probe_ln.cu``): the
    LayerNorm-LSTM kernels' (``ln`` = ``(ln_gamma, ln_beta, lnc_gamma,
    lnc_beta)``; ``c0``/``h0``, or ``h0`` twice for the backward, float32
    ``[B, H]``), ``H >= 2`` (the stand-in stats read two columns), no
    streamed masks. Returns ``(dev, t, b, d, h, seed_ptr, w_bf16)``."""
    dev, t, b, d, h, _, sp, wb = CF._kernel_common(xs, wx, wh, c0, h0, None,
                                                   seed)
    if h < 2:
        raise ValueError(f"hidden size {h}: the LayerNorm ladder's "
                         f"stand-in stats read two columns")
    CF._ln_params_check(dev, h, *ln, x_bias, b)
    return dev, t, b, d, h, sp, wb


def events_ms(fn, k):
    """ms per call of ``k`` calls of ``fn``, between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(k):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / k


def interleaved(arms, k, reps):
    """Median ms per call of each arm over ``reps`` rounds of ``k`` calls,
    the arms taking turns (A, B, A, B, ...) after one settling round, so a
    drift of the card's clocks hits them alike."""
    times = [[] for _ in arms]
    for r in range(reps + 1):
        for fn, ts in zip(arms, times):
            ms = events_ms(fn, k)
            if r:
                ts.append(ms)
    return [statistics.median(ts) for ts in times]
