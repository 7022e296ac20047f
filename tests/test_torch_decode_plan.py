"""The serving loop's plan and scratch on the CPU.

``ops/cuda_decode.py::decode_plan`` sizes the persistent cooperative loop
of ``csrc/decode.cu`` (slices of 16 units x batch tiles, windows of rows,
shared memory a block) from the shape alone, and the wrappers allocate the
scratch it names; the C side checks the plan and refuses, never falls back.
Here, without a card: the plan at the serving shapes fits an H100 (at most
132 blocks, at most 232,448 bytes of shared memory a block), small and
large slot counts, the shapes it refuses, and the scratch the wrappers
allocate. The plan does not depend on the cell: both cells run on it.
"""

import pytest
import torch

from sketch_rnn_tpu_torch.ops import cuda_decode as cd

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("policy", cd.POLICIES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_at_the_serving_shapes_fits_an_h100(policy, dtype):
    plan = cd.decode_plan(64, 512, 20, dtype, policy)
    assert (plan.slices, plan.tiles, plan.windows) == (32, 4, 1)
    assert plan.slices * plan.tiles <= cd.SERVE_SMS
    assert plan.smem <= cd.SERVE_SMEM_MAX
    # the sizes csrc/decode.cu's header gives
    want = {("decode", F32): (186_736, 1_361_920),
            ("decode", BF16): (112_448, 1_230_848),
            ("replay", F32): (176_640, 344_064),
            ("replay", BF16): (102_352, 212_992)}[policy, dtype]
    assert (plan.smem, plan.scratch) == want


@pytest.mark.parametrize("policy", cd.POLICIES)
def test_plan_at_eight_slots(policy):
    plan = cd.decode_plan(8, 512, 20, F32, policy)
    assert (plan.slices, plan.tiles, plan.windows) == (32, 4, 1)
    # tiles of 2 rows: the same resident columns, fewer pairs
    assert plan.smem == cd.decode_smem(policy, 4, 512, 20, 32, 2)
    assert plan.smem < cd.decode_plan(64, 512, 20, F32, policy).smem


@pytest.mark.parametrize("policy,b,dtype,windows", [
    ("decode", 512, F32, 2), ("decode", 4096, F32, 14),
    ("replay", 1024, BF16, 2), ("replay", 4096, BF16, 5)])
def test_plan_takes_the_fewest_windows_that_fit(policy, b, dtype, windows):
    plan = cd.decode_plan(b, 512, 20, dtype, policy)
    assert plan.windows == windows
    ws = 2 if dtype == BF16 else 4

    def most(n):        # the largest window's block at n windows
        hi = -(-b // n)
        return cd.decode_smem(policy, ws, 512, 20, 32, -(-hi // min(
            hi, cd.SERVE_SMS // 32)))

    assert most(windows) == plan.smem <= cd.SERVE_SMEM_MAX
    assert most(windows - 1) > cd.SERVE_SMEM_MAX
    assert plan.slices * plan.tiles <= cd.SERVE_SMS


def test_plan_slices_and_tiles_at_narrow_widths():
    # one slice of 16 units; three uneven slices of 13-14; tiles fill the
    # SMs up to one row each
    assert cd.decode_plan(4, 16, 3)[:3] == (1, 4, 1)
    assert cd.decode_plan(4, 40, 3)[:3] == (3, 4, 1)
    assert cd.decode_plan(1000, 16, 3)[:2] == (1, 132)
    assert cd.decode_plan(1000, 40, 3)[:2] == (3, 44)


def test_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="H <= 512"):
        cd.decode_plan(64, 1024, 20)
    with pytest.raises(ValueError, match="H <= 512"):
        cd.decode_plan(0, 512, 20)
    with pytest.raises(ValueError, match="does not fit"):
        cd.decode_plan(64, 512, 2000)      # out_w's rows alone: 768 KB
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cd.decode_plan(64, 512, 20, torch.float16)
    with pytest.raises(ValueError, match="policy"):
        cd.decode_plan(64, 512, 20, F32, "encode")


def _meta_stream(monkeypatch):
    class _S:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _S())


@pytest.mark.parametrize("cell,conditional,dtype", [
    ("layer_norm", True, F32), ("lstm", False, BF16)])
def test_wrappers_allocate_the_plans_scratch(monkeypatch, cell, conditional,
                                             dtype):
    """The decode and replay wrappers' arguments on meta tensors: the plan
    and a scratch of exactly ``plan.scratch`` bytes before the outputs."""
    _meta_stream(monkeypatch)
    meta = torch.device("meta")
    b, h, m, k, e, ez = 64, 512, 20, 8, 64, 128
    z = lambda *s, dt=F32: torch.zeros(s, dtype=dt, device=meta)
    cp = {"wx": z(5 + (ez if conditional else 0), 4 * h, dt=dtype),
          "wh": z(h, 4 * h, dt=dtype)}
    if cell == "lstm":
        cp["b"] = z(4 * h)
    else:
        cp.update(ln_gamma=z(4, h), ln_beta=z(4, h), lnc_gamma=z(h),
                  lnc_beta=z(h))
    extra = z(b, ez) if conditional else None
    cdt = None if dtype == F32 else dtype
    i32 = torch.int32
    args, rowblock, outs, held = cd._decode_args(
        cp, z(h, 6 * m + 3, dt=dtype), z(6 * m + 3), z(b, h), z(b, h),
        z(b, 5), extra, z(k, b, 4), z(b), z(b, dt=i32),
        z(b, dt=torch.bool), z(b, dt=i32), z(5), cell, m, 1.0, cdt, False)
    plan = cd.decode_plan(b, h, m, dtype)
    assert held[0].dtype == torch.uint8 and held[0].numel() == plan.scratch
    # ..., forget_bias, slices, tiles, windows, smem, scratch, 5 outputs,
    # the stream
    assert args[27:31] == tuple(plan[:4]) and len(args) == len(rowblock) + 5
    assert [tuple(o.shape) for o in outs] == [(k, b, 5), (b, h), (b, h),
                                              (b,), (b,)]
    args, rowblock, outs, held = cd._replay_args(
        cp, z(b, h), z(b, h), z(e, b, 5), extra, z(b, dt=i32), cell, 1.0,
        cdt)
    plan = cd.decode_plan(b, h, 1, dtype, "replay")
    assert held[0].numel() == plan.scratch
    assert args[18:22] == tuple(plan[:4]) and len(args) == len(rowblock) + 5
