"""What the probe scripts share: the kernel libraries' launch, operand
checks, the plan of the probe loop (``csrc/probe_seq.cu``), the
interleaved A/B timing by CUDA events."""

from __future__ import annotations

import statistics
from typing import NamedTuple

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


# The probe loop's plan (csrc/probe_seq.cu, probe_loop_kernel): blocks of
# PS_UNITS hidden units of one direction by a tile of batch rows, as many
# tiles as fill the card's SMs once, the tile's h rows staged in chunks of
# PS_CHUNKS rows (the largest that fits), and the fewest windows of rows
# whose blocks fit in a block's shared memory (persist.cuh).
PS_UNITS = 32
PS_CHUNKS = (64, 32)
PS_SMS = 132                # an H100's SMs
PS_SMEM_MAX = 232_448       # an H100 block's opt-in shared memory, bytes


class ProbeSeqPlan(NamedTuple):
    """``slices`` of ``PS_UNITS`` units per direction; at most ``tiles``
    batch tiles in each of ``windows`` windows of rows (window ``w`` the
    rows ``[w * B // windows, (w + 1) * B // windows)``, ``min(rows,
    tiles)`` tiles of it, tile ``i`` of ``n`` the rows ``[i * rows // n,
    (i + 1) * rows // n)`` of it); h staged ``chunk`` rows at a time;
    ``smem`` bytes of shared memory a block."""
    slices: int
    tiles: int
    chunk: int
    windows: int
    smem: int

    def blocks(self, dirs: int) -> int:
        return dirs * self.slices * self.tiles


def probe_seq_smem(h, d, chunk, rows) -> int:
    """A block's shared memory for a tile of ``rows`` rows
    (``probe_seq.cu`` ``ps_smem``, the same sum): ``wh``'s columns as
    bf16 rows of ``4 * PS_UNITS + 8`` with ``k`` padded to 16, ``wx`` and
    ``b`` as float, the float carries (a row stride 16 above a multiple
    of 32), two bf16 h chunks (rows of ``k + 8``) and the staged float
    outputs (rows of ``PS_UNITS + 2``, two of them)."""
    kp = -(-h // 16) * 16
    cst = (rows + 15) // 32 * 32 + 16
    return (kp * (4 * PS_UNITS + 8) * 2 + (d + 1) * 4 * PS_UNITS * 4
            + PS_UNITS * cst * 4 + 2 * chunk * (kp + 8) * 2
            + 2 * chunk * (PS_UNITS + 2) * 4)


def probe_seq_plan(b, h, d, dirs, sms=PS_SMS,
                   smem_max=PS_SMEM_MAX) -> ProbeSeqPlan:
    """The plan of the probe loop for ``B`` rows, ``H`` units, ``D``
    inputs and ``dirs`` directions (1 or 2) on a card of ``sms`` SMs:
    ``dirs * slices * tiles <= sms`` blocks (one per SM); the fewest
    windows, then the largest chunk, whose blocks fit in ``smem_max``
    bytes. The outputs do not depend on it: every sum runs over all of
    ``k`` in order. Raises ``ValueError`` for a shape it cannot hold."""
    if dirs not in (1, 2) or b < 1 or not 0 < h <= MAX_HIDDEN or d < 0:
        raise ValueError(f"probe loop: B={b}, H={h}, D={d}, dirs={dirs}")
    slices = -(-h // PS_UNITS)
    fill = sms // (dirs * slices)
    if fill < 1:
        raise ValueError(f"probe loop: {dirs * slices} blocks of one tile "
                         f"exceed the card's {sms} SMs")
    for windows in range(1, b + 1):
        rows = -(-b // windows)
        tiles = min(rows, fill)
        nb = -(-rows // tiles)
        for chunk in PS_CHUNKS:
            if chunk > nb and chunk != PS_CHUNKS[-1]:
                continue        # a smaller chunk holds the tile
            smem = probe_seq_smem(h, d, chunk, nb)
            if smem <= smem_max:
                return ProbeSeqPlan(slices, tiles, chunk, windows, smem)
    raise ValueError(f"probe loop: H={h}, D={d} does not fit in "
                     f"{smem_max} bytes of shared memory even at one row")


def device_plan(dev, b, h, d, dirs) -> ProbeSeqPlan:
    """:func:`probe_seq_plan` on ``dev``'s card (its SM count)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return probe_seq_plan(b, h, d, dirs, sms=sms)


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
