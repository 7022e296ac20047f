"""The HyperLSTM forward's design, held on the CPU.

``srt_hyper_fwd`` (``sketch_rnn_tpu_torch/csrc/fused_hyper.cu``) runs on
the card only; what it is built from is held here: the loop's plan
(``cuda_fused.hyper_fwd_plan``, the grid, windows, passes and shared
memory the kernel checks before any launch), the scratch the wrapper
allocates (``hyper_fwd_work_floats`` and the exchanges), and the entry's
arguments against its ctypes signature. The forward's arithmetic is the
plain version's, which ``test_torch_hyper`` holds against the Pallas
forward, and the kernel is held against that plain version on the card
(``test_torch_cuda``, ``chip_smoke.py``).
"""

import pytest
import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("b,d,h,hh,e,want", [
    # the hyper preset: LN slices of 16 units, 32 slices x 4 tiles = 128
    # blocks on 132 SMs, one window; the products on groups of 8 main and
    # 4 auxiliary units for the 50 rows of 2 tiles, in two passes of 25
    (100, 5, 512, 256, 32, (16, 2, 32, 4, 1, 25, 28, 229_504)),
    (5, 5, 16, 32, 8, (16, 2, 2, 4, 1, 4, 4, 29_840)),
    (5, 5, 40, 8, 4, (16, 2, 3, 4, 1, 4, 4, 19_904)),
    (6, 5, 24, 24, 3, (16, 2, 2, 6, 1, 2, 4, 22_896)),
    # a row cannot take the two tiles of a split: slices of 8 units
    (1, 5, 512, 256, 32, (8, 1, 64, 1, 1, 1, 8, 147_888)),
    (1, 5, 24, 24, 3, (8, 1, 3, 1, 1, 1, 8, 17_600))])
def test_hyper_fwd_plan_at_the_preset_and_narrow_shapes(b, d, h, hh, e, want):
    p = CF.hyper_fwd_plan(b, d, h, hh, e)
    assert tuple(p) == want
    assert p.slices * p.tiles <= CF.HYPER_SMS
    assert p.tiles % p.split == 0 and p.units // p.split == 8
    assert p.smem <= CF.HYPER_SMEM_MAX
    # the slices cover both unit sets, neither wider than a slice's units
    assert -(-h // p.slices) <= p.units and -(-hh // p.slices) <= p.units
    # a products pass: the group's rows, or at least 16 of them
    enb = p.split * -(-b // p.tiles)
    assert min(enb, CF.HYPER_FWD_MIN_PASS) <= p.pchunk <= enb
    # a products pass gives each of the 8 warps at most one float task
    per = 2 + 2 * CF._hf_aux4(hh, p.slices, p.split) // 4
    assert -(-p.pchunk // 16) * per <= 8
    # a LayerNorm pass: whole warp tasks, at most one a warp
    tr = 32 // p.units * 2
    assert p.chunk % tr == 0 and tr <= p.chunk <= 8 * tr
    assert p == CF.hyper_fwd_plan(b, d, h, hh, e, BF16)


def test_hyper_fwd_plan_fills_the_passes_evenly():
    """At the preset a product group's 50 rows take two passes of 25 (not
    32 and 18), and a tile's 25 rows one LayerNorm pass of seven warp
    tasks."""
    p = CF.hyper_fwd_plan(100, 5, 512, 256, 32)
    enb = p.split * -(-100 // p.tiles)
    assert enb == 50 and -(-enb // p.pchunk) == 2 and p.pchunk == 25
    assert p.chunk == 28


def test_hyper_fwd_plan_takes_the_fewest_windows_that_fit():
    """B=8192 at the preset's widths: a tile's carries and the passes'
    rows exceed a block's shared memory in one window; the plan takes the
    least number of windows whose tiles fit with a products pass of at
    least one task's 16 rows, and one window fewer would not."""
    b, d, h, hh, e = 8192, 5, 512, 256, 32
    p = CF.hyper_fwd_plan(b, d, h, hh, e)
    assert p.windows == 6 and (p.units, p.split, p.slices, p.tiles) == (
        16, 2, 32, 4)
    assert p.pchunk >= 16 and p.smem <= CF.HYPER_SMEM_MAX

    def smem(windows, pchunk):
        rows = -(-b // windows)
        nb = -(-rows // p.tiles)
        return CF.hyper_fwd_smem(p.units, p.split, p.slices, nb, d, h, hh,
                                 e, pchunk, p.chunk)
    assert smem(p.windows, p.pchunk) == p.smem
    assert smem(p.windows - 1, 16) > CF.HYPER_SMEM_MAX


@pytest.mark.parametrize("kw,err", [
    (dict(b=100, d=5, h=512, hh=256, e=32, sms=16), ValueError),  # no grid
    (dict(b=100, d=5, h=512, hh=256, e=32, smem_max=100_000), ValueError),
    (dict(b=4, d=5, h=16, hh=16, e=2000), ValueError),  # z rows outgrow it
    (dict(b=0, d=5, h=16, hh=16, e=4), ValueError),
    (dict(b=4, d=0, h=16, hh=16, e=4), ValueError),
    (dict(b=4, d=5, h=600, hh=16, e=4), ValueError),
    (dict(b=4, d=5, h=16, hh=16, e=4, dtype=torch.float16), TypeError)])
def test_hyper_fwd_plan_refuses_a_shape_it_cannot_hold(kw, err):
    with pytest.raises(err):
        CF.hyper_fwd_plan(**kw)


def test_hyper_fwd_work_floats_is_what_the_wrapper_allocates(monkeypatch):
    """At the preset: z, the layer norms' slice partials, the hp exchange
    and the stash, float32; beside them the h and hh exchanges of the
    weight dtype. The wrapper runs on the CPU here with its operand checks
    and the stream stubbed (one step), so that its allocations show."""
    b, d, h, hh, e = 100, 5, 512, 256, 32
    p = CF.hyper_fwd_plan(b, d, h, hh, e)
    want = b * 12 * e + b * p.slices * (8 + 2) + b * 4 * h + 4 * b * h
    assert CF.hyper_fwd_work_floats(b, h, e, p.slices) == want
    assert 4 * want == 1_920_000

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *shape, dtype=None,
                        device=None: real_empty(*shape, dtype=dtype))
    monkeypatch.setattr(CF, "_stream", lambda dev: 0)
    monkeypatch.setattr(CF, "_hyper_common", lambda xs, w, *a: (
        "cuda", 1, b, d, h, hh, e, int(w.wx.dtype == BF16)))
    for wdt in (F32, BF16):
        w = CF.HyperWeights(*(real_empty(1, dtype=wdt if n in
                                         CF.HYPER_MATRICES else F32)
                              for n in CF.HyperWeights._fields))
        x = real_empty(1)
        args, rowblock, outs, (xch, work) = CF._hyper_fwd_args(
            x, w, x, x, x, x, 1.0, None, None, 1.0, None, None, None)
        assert work.numel() == want and work.dtype == F32
        assert tuple(xch.shape) == (2, b, h + hh) and xch.dtype == wdt
        # the plan rides between the operands and the scratch
        assert args[39:47] == tuple(p)
        assert len(args) == 58 and len(rowblock) == 48


def test_hyper_fwd_entries_match_their_ctypes_signatures():
    from sketch_rnn_tpu_torch.ops import _build

    sig = _build.SIGNATURES["fused_hyper"]
    assert len(sig["srt_hyper_fwd"]) == 58
    assert len(sig["srt_hyper_fwd_rowblock"]) == 48
    # the plan's eight ints after keep, inv_keep and the forget bias
    import ctypes
    assert sig["srt_hyper_fwd"][36:39] == [ctypes.c_float] * 3
    assert sig["srt_hyper_fwd"][39:47] == [ctypes.c_int] * 8
    assert sig["srt_hyper_fwd_rowblock"] == (
        sig["srt_hyper_fwd"][:39] + sig["srt_hyper_fwd"][49:])


def test_hyper_lstm_fwd_entries_need_cuda_tensors():
    w = CF.HyperWeights(*(torch.zeros(1) for _ in CF.HyperWeights._fields))
    x = torch.zeros(1, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        CF.hyper_lstm_fwd_entries(x, w, x, x, x, x)
