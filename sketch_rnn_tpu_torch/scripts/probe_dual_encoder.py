"""Probe: both encoder directions in one kernel, on the card.

The port of ``scripts/probe_dual_encoder.py``. The encoder's two
directions are two INDEPENDENT recurrence chains over the same data; the
production encoder runs them as two ``fused_lstm_seq`` forwards.
:func:`dual_seq_fwd` (kernel ``srt_dual_seq_fwd`` of
``csrc/probe_seq.cu``) runs both in one persistent loop, one grid barrier
a step for both, the recurrent product on the tensor cores, to see
whether one launch over two chains beats two launches. Forward only, the
sequence-only contract: zero carries, no dropout.

:func:`run_probe` times three arms, interleaved: two launches of the
port's production ``fused_lstm_seq`` forward (``single_2calls_ms``), one
dual launch (``dual_ms``), and two launches of the same loop over one
direction, :func:`probe_bf16_gates.seq_fwd` with float32 gates
(``same_design_2calls_ms``), on the same inputs (the backward
direction's inputs flipped once, outside the timing). The dual launch is
held to the two same-design launches (within the JAX script's ``1e-2``,
and ``bitwise_parity`` records that they agree bit for bit): the
production forward sums in another order, and at the probe's ``N(0,
0.1)`` weights the recurrence is chaotic, so a rounding gap grows to
O(1) over 250 steps. :func:`main` prints the record (the JAX script's
keys, ``device_kind`` from the card; ``tile`` is the rows of a batch
tile, ``plan`` the loop's plan). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.probe_dual_encoder \\
        [--reps 7] [--t 250] [--b 4096] [--h 256] [--d 5] [--k 8]

It prints and appends to no file.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.scripts import _probe
from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as PB

_launches = {"dual_seq_fwd": 0}


def reset_launch_counts() -> None:
    _launches["dual_seq_fwd"] = 0


def launch_counts() -> dict:
    return dict(_launches)


def dual_seq_fwd_plain(xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                       forget_bias=1.0, residual_dtype=torch.bfloat16):
    """The plain version: two plain ``fused_lstm_seq`` forwards from zero
    carries, ``(hs_f, cs_f, hs_b, cs_b)`` in ``residual_dtype``."""
    b, h = xs_f.shape[1], wh_f.shape[0]
    z = torch.zeros((b, h), dtype=torch.float32, device=xs_f.device)
    hs_f, cs_f = CF.lstm_seq_fwd_reference(
        xs_f, wx_f, b_f, wh_f, z, z, forget_bias,
        residual_dtype=residual_dtype)
    hs_b, cs_b = CF.lstm_seq_fwd_reference(
        xs_b, wx_b, b_b, wh_b, z, z, forget_bias,
        residual_dtype=residual_dtype)
    return hs_f, cs_f, hs_b, cs_b


def _launchers(xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b, wh_b, forget_bias,
               residual_dtype):
    """The checked operands' launches on one set of outputs: ``(calls,
    outs)``, ``calls["rowblock"]`` the row-block entry and, at bfloat16
    weights, ``calls["loop"]`` the persistent loop (with its ``hx``
    scratch). The caller keeps the inputs alive."""
    dev = xs_f.device
    t, b, d = xs_f.shape
    h, wb = _probe.check_direction(dev, t, b, d, xs_f, wx_f, b_f, wh_f)
    _probe.check_direction(dev, t, b, d, xs_b, wx_b, b_b, wh_b)
    if wx_b.dtype != wx_f.dtype or wh_b.shape != wh_f.shape:
        raise TypeError("both directions take weights of one dtype and "
                        "shape")
    rd = torch.float32 if residual_dtype is None else residual_dtype
    if rd not in CF.RESIDUAL_DTYPES:
        raise TypeError(f"residual_dtype {rd}: the dual kernel stores "
                        f"{CF.RESIDUAL_DTYPES}")
    outs = [torch.empty((t, b, h), dtype=rd, device=dev) for _ in range(4)]
    ins = (xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    head = (*(x.data_ptr() for x in ins), t, b, d, h)
    tail = [o.data_ptr() for o in outs]
    rb, fb, st = int(rd == torch.bfloat16), float(forget_bias), CF._stream(dev)
    calls = {"rowblock": lambda: _probe.launch(
        "srt_dual_seq_fwd_rowblock", "dual_seq_fwd", *head, wb, rb, fb,
        *tail, st)}
    if wb:
        hx = torch.empty((2, 2, b, h), dtype=torch.bfloat16, device=dev)
        plan = _probe.device_plan(dev, b, h, d, 2)
        calls["loop"] = lambda: _probe.launch(
            "srt_dual_seq_fwd", "dual_seq_fwd", *head, rb, fb, *plan, *tail,
            hx.data_ptr(), st)
    return calls, outs


def dual_seq_fwd(xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                 forget_bias=1.0, residual_dtype=torch.bfloat16):
    """Both directions' sequence LSTM forward in one launch: ``xs_f,
    xs_b [T, B, D]`` float32, per direction ``wx [D, 4H]`` and ``wh [H,
    4H]`` (all four of one weight dtype, float32 or bfloat16) and ``b
    [4H]`` float32. Returns ``(hs_f, cs_f, hs_b, cs_b)``, each ``[T, B,
    H]`` in ``residual_dtype`` (float32 or bfloat16). The plain version
    on CPU tensors; on CUDA tensors the kernel, or a raise. The kernel
    is chosen by the weight dtype: bfloat16 weights run the persistent
    tensor-core loop (``srt_dual_seq_fwd``), float32 weights the row-block
    design (``srt_dual_seq_fwd_rowblock``), which no probe runs."""
    if xs_f.device.type == "cpu":
        return dual_seq_fwd_plain(xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b,
                                  wh_b, forget_bias, residual_dtype)
    calls, outs = _launchers(xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                             forget_bias, residual_dtype)
    calls["loop" if wx_f.dtype == torch.bfloat16 else "rowblock"]()
    _launches["dual_seq_fwd"] += 1
    return tuple(outs)


def dual_seq_fwd_entries(xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b, wh_b,
                         forget_bias=1.0, residual_dtype=torch.bfloat16):
    """For the A/B on the card: the persistent loop and the row-block
    design on one set of outputs, bfloat16 weights, CUDA tensors only,
    no launch counted. Returns ``(run, outs)``: ``run("loop")`` or
    ``run("rowblock")`` launches one (and keeps the inputs alive);
    ``outs`` are ``(hs_f, cs_f, hs_b, cs_b)`` as the last launch left
    them."""
    if xs_f.device.type != "cuda" or wx_f.dtype != torch.bfloat16:
        raise ValueError("dual_seq_fwd_entries: CUDA tensors and bfloat16 "
                         "weights")
    ins = (xs_f, xs_b, wx_f, b_f, wh_f, wx_b, b_b, wh_b)
    calls, outs = _launchers(*ins, forget_bias, residual_dtype)

    def run(design, _held=ins):
        calls[design]()

    return run, tuple(outs)


def probe_inputs(t, b, h, d, k, device="cuda"):
    """The probe's operands, seeded: ``k`` input sequences (one per call
    in a timing, so no call repeats another's data) and their flips,
    bfloat16 weights ``N(0, 0.1)``, zero biases."""
    g = torch.Generator().manual_seed(0)
    xs = torch.randn((k, t, b, d), generator=g).to(device)
    mk = lambda *s: (0.1 * torch.randn(s, generator=g)).to(
        torch.bfloat16).to(device)
    w = dict(wx_f=mk(d, 4 * h), wx_b=mk(d, 4 * h), wh_f=mk(h, 4 * h),
             wh_b=mk(h, 4 * h),
             b_f=torch.zeros(4 * h, device=device),
             b_b=torch.zeros(4 * h, device=device))
    return xs, torch.flip(xs, dims=(1,)).contiguous(), w


def run_probe(t=250, b=4096, h=256, d=5, k=8, reps=7, device="cuda"):
    """The A/B on the card; returns the record. Raises if the dual launch
    differs from two launches of the same loop over one direction by
    more than the JAX script's ``1e-2`` (they are expected equal bit for
    bit: ``bitwise_parity`` in the record)."""
    dev = torch.device(device)
    xs, xs_rev, w = probe_inputs(t, b, h, d, k, dev)
    zc = torch.zeros((b, h), device=dev)
    bf = torch.bfloat16

    def single(i=0):
        hf = CF.lstm_seq_fwd(xs[i], w["wx_f"], w["b_f"], w["wh_f"], zc, zc,
                             1.0, residual_dtype=bf)
        hb = CF.lstm_seq_fwd(xs_rev[i], w["wx_b"], w["b_b"], w["wh_b"], zc,
                             zc, 1.0, residual_dtype=bf)
        return (*hf, *hb)

    def dual(i=0):
        return dual_seq_fwd(xs[i], xs_rev[i], w["wx_f"], w["b_f"],
                            w["wh_f"], w["wx_b"], w["b_b"], w["wh_b"])

    def pair(i=0):
        return (*PB.seq_fwd(xs[i], w["wx_f"], w["b_f"], w["wh_f"], False),
                *PB.seq_fwd(xs_rev[i], w["wx_b"], w["b_b"], w["wh_b"],
                            False))

    pairs = list(zip(pair(), dual()))
    parity = all(torch.equal(a, c) for a, c in pairs)
    err = max(float((a.float() - c.float()).abs().max()) for a, c in pairs)
    if not err <= 1e-2:
        raise AssertionError(f"dual_seq_fwd differs from two seq_fwd "
                             f"launches of the same loop by {err}")
    del pairs
    it = {"a": 0, "b": 0, "c": 0}

    def arm(fn, name):
        def call():
            fn(it[name] % k)
            it[name] += 1
        return call

    ms_a, ms_b, ms_c = _probe.interleaved(
        [arm(single, "a"), arm(dual, "b"), arm(pair, "c")], k, reps)
    plan = _probe.device_plan(dev, b, h, d, 2)
    return {"kind": "probe_dual_encoder", "T": t, "B": b, "H": h, "D": d,
            "tile": -(-b // (plan.windows * plan.tiles)), "reps": reps,
            "calls_per_dispatch": k, "single_2calls_ms": ms_a,
            "dual_ms": ms_b, "speedup": ms_a / ms_b,
            "same_design_2calls_ms": ms_c,
            "same_design_speedup": ms_c / ms_b, "bitwise_parity": parity,
            "plan": plan._asdict(),
            "device_kind": torch.cuda.get_device_name(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--t", type=int, default=250)
    ap.add_argument("--b", type=int, default=4096)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--k", type=int, default=8,
                    help="kernel calls per timing")
    args = ap.parse_args(argv)
    print(json.dumps(run_probe(args.t, args.b, args.h, args.d, args.k,
                               args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
