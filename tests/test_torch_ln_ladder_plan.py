"""The LayerNorm ladder's per-arm plans on the CPU.

``sketch_rnn_tpu_torch/scripts/probe_dec_bwd_split.py::fwd_plan`` and
``bwd_plan`` say, from the shape alone, what each arm of the ladder's
persistent kernels (``csrc/probe_ln.cu`` on ``csrc/ln_lstm.cuh``) runs a
call and holds: grid barriers a loop step, kernel launches (one a window
of rows for the loop) and the scratch the wrappers allocate. Here, without a card, at H 16 / 40 / 512 x B 1 / 100 /
4096: each arm's barriers and launches, production's scratch as the
production wrappers size it, no arm's scratch above production's, and the
B=4096 ladder's largest call within an 80 GB card.
"""

import pytest
import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as PS

T, D = 250, 5
SHAPES = [(h, b) for h in (16, 40, 512) for b in (1, 100, 4096)]
CARD_BYTES = 80e9
BF16, F32 = torch.bfloat16, torch.float32

# grid barriers a loop step, by arm
FWD_BARRIERS = {"prod": 3, "no_ln": 1, "no_gates": 1, "floor": 0}
BWD_BARRIERS = {"prod": 3, "fake": 3, "no_lnbwd": 1, "no_ln": 1,
                "no_gates": 1, "no_gradmm": 1, "floor": 0}
# kernel launches a call at one window: the recompute, the statistics,
# the loop, the LN sums' row sum, the weight pass's two
BWD_LAUNCHES = {"prod": 6, "no_lnbwd": 6, "no_ln": 5, "fake": 5,
                "no_gates": 4, "no_gradmm": 2, "floor": 1}


@pytest.mark.parametrize("h,b", SHAPES)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fwd_plan(h, b, dtype):
    prod = PS.fwd_plan("prod", T, b, D, h, dtype)
    # production's scratch, as cuda_fused sizes srt_ln_lstm_fwd's
    assert prod.scratch == {"hx": ((2, b, h), dtype),
                            "work": ((CF.ln_fwd_work_floats(b, h),), F32)}
    for arm in PS.FWD_ARMS:
        plan = PS.fwd_plan(arm, T, b, D, h, dtype)
        assert plan.barriers == FWD_BARRIERS[arm]
        assert (plan.launches(), plan.launches(2)) == (1, 2)
        assert plan.scratch_bytes() <= prod.scratch_bytes()
        assert ("hx" in plan.scratch) == (arm != "floor")
    assert PS.fwd_plan("floor", T, b, D, h, dtype).scratch == {}


@pytest.mark.parametrize("h,b", SHAPES)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_bwd_plan(h, b, dtype):
    prod = PS.bwd_plan("prod", T, b, D, h, dtype)
    wg = CF.weight_grad_plan(T, b, D, h, 0, dtype)
    # production's scratch, as cuda_fused sizes srt_ln_lstm_bwd's
    assert prod.scratch == {
        "dpre": ((T, b, 4 * h), F32), "part": ((b, 10 * h), F32),
        "work": ((CF.ln_bwd_work_floats(T, b, h),), F32),
        "wg_part": ((wg.slices, D + h, 4 * h), F32)}
    for arm in (*PS.ARMS, "fake"):
        plan = PS.bwd_plan(arm, T, b, D, h, dtype)
        assert plan.barriers == BWD_BARRIERS[arm]
        assert plan.launches() == BWD_LAUNCHES[arm]
        assert plan.launches(4) == BWD_LAUNCHES[arm] + 3
        assert plan.scratch_bytes() <= prod.scratch_bytes()
        weight = arm in ("prod", "no_lnbwd", "no_ln", "fake", "no_gates")
        sums = arm in ("prod", "no_lnbwd", "no_ln", "fake")
        assert ("wg_part" in plan.scratch) == weight
        assert ("part" in plan.scratch) == sums
        assert ("dpre" in plan.scratch) == (arm != "floor")
    # the stand-in arms hold no statistics, no_lnbwd nothing but them
    stats = T * b * 10
    assert PS.bwd_plan("no_ln", T, b, D, h, dtype).scratch.get("work") is None
    assert PS.bwd_plan("no_lnbwd", T, b, D, h, dtype).scratch["work"] == (
        (stats,), F32)
    assert PS.bwd_plan("fake", T, b, D, h, dtype).scratch["work"][0][0] == (
        CF.ln_bwd_work_floats(T, b, h) - stats)


def _tensor_bytes(shapes, dtype):
    size = torch.empty(0, dtype=dtype).element_size()
    return sum(torch.Size(s).numel() * size for s in shapes)


def test_the_b4096_ladder_fits_a_card():
    """The largest call of the ladder at its shape (B=4096, T=250, H=512,
    bf16 weights and residuals): its inputs, its outputs and its arm's
    scratch, with the row-block design's sharing the same buffers, well
    within an 80 GB card."""
    b, h = 4096, PS.H
    inputs = (_tensor_bytes([(T, b, D), (b, 4 * h), (b, h), (b, h), (b, h),
                             (4, h), (4, h), (h,), (h,)], F32)
              + _tensor_bytes([(D, 4 * h), (h, 4 * h), (T, b, h),
                               (T, b, h), (T, b, h)], BF16))
    fwd_out = _tensor_bytes([(T, b, h)] * 2, BF16) + _tensor_bytes(
        [(b, h)] * 2, F32)
    bwd_out = _tensor_bytes([(T, b, D), (b, 4 * h), (D, 4 * h), (h, 4 * h),
                             (10 * h,), (b, h), (b, h)], F32)
    fwd = max(PS.fwd_plan(a, T, b, D, h).scratch_bytes()
              for a in PS.FWD_ARMS) + fwd_out
    bwd = max(PS.bwd_plan(a, T, b, D, h).scratch_bytes()
              for a in (*PS.ARMS, "fake")) + bwd_out
    assert inputs + max(fwd, bwd) < CARD_BYTES / 4
    # the d_pre scratch dominates: 8.4 GB
    assert PS.bwd_plan("prod", T, b, D, h).scratch_bytes() > 8.19e9


def test_plans_refuse_an_unknown_arm():
    with pytest.raises(ValueError, match="arm"):
        PS.fwd_plan("no_lnbwd", T, 4, D, 16)
    with pytest.raises(ValueError, match="arm"):
        PS.bwd_plan("no_gate", T, 4, D, 16)
