"""Probe: bfloat16 gate transcendentals in the sequence LSTM forward.

The port of ``scripts/probe_bf16_gates.py``. :func:`seq_fwd` (kernel
``srt_seq_fwd`` of ``csrc/probe_seq.cu``: the persistent loop of the dual
encoder probe over one direction, the recurrent product on the tensor
cores) is the encoder's sequence LSTM forward (zero carry, no dropout,
bfloat16 ``hs``/``cs``) with the gate block in one of two forms
(``bf16_gates``):

- ``False``: the production recipe, float32 gates; the same function as
  the ``fused_lstm_seq`` forward (its sums in another order).
- ``True``: the Pallas arm. The pre-activations rounded to bfloat16,
  then ``sigmoid(v) = 1 / (1 + exp(-v))``, the candidate's ``tanh``,
  ``i * g`` and ``tanh(c) * o`` in bfloat16 (each transcendental
  evaluated in float32 and rounded), the cell state accumulated, and its
  ``tanh`` taken, in float32.

:func:`run_probe` times the arms, interleaved, and measures the drift of
bfloat16 gates against float32 gates over T steps. :func:`main` prints
the JAX script's record (its keys, ``device_kind`` from the card;
``tile`` is the rows of a batch tile). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.probe_bf16_gates [--reps 7] \\
        [--t 250] [--b 4096] [--h 256] [--d 5] [--k 8]

It prints and appends to no file.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.scripts import _probe

_launches = {"seq_fwd": 0}


def reset_launch_counts() -> None:
    _launches["seq_fwd"] = 0


def launch_counts() -> dict:
    return dict(_launches)


GATE_FORMS = {False: 0, True: 1}   # the kernel's gate forms


def _bf16_gates(pre, c, forget_bias):
    """The bfloat16 gate block: ``(new_c, new_h)``, both float32, every
    gate op rounded to bfloat16 where the Pallas arm rounds (torch's
    bfloat16 ops evaluate in float32 and round)."""
    bf = torch.bfloat16
    h = c.shape[-1]
    pre = pre.to(bf)
    one = torch.tensor(1.0, dtype=bf, device=pre.device)
    sig = lambda v: one / (one + torch.exp(-v))
    i = sig(pre[:, :h])
    g = torch.tanh(pre[:, h:2 * h])
    f = sig(pre[:, 2 * h:3 * h]
            + torch.tensor(forget_bias, dtype=bf, device=pre.device))
    o = sig(pre[:, 3 * h:])
    new_c = c * f.float() + (i * g).float()
    new_h = (torch.tanh(new_c).to(bf) * o).float()
    return new_c, new_h


def seq_fwd_plain(xs, wx, b, wh, bf16_gates, forget_bias=1.0):
    """The plain version: ``(hs, cs)`` in bfloat16. The float32-gates
    arm is the plain ``fused_lstm_seq`` forward itself."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    z = torch.zeros((bsz, h), dtype=torch.float32, device=xs.device)
    if not bf16_gates:
        return CF.lstm_seq_fwd_reference(xs, wx, b, wh, z, z, forget_bias,
                                         residual_dtype=torch.bfloat16)
    w = CF._Weights(wx, wh)
    c = hh = z
    hs, cs = [], []
    for t in range(t_len):
        pre = w.lstm_pre(xs[t], hh, b, None)
        cs.append(c.to(torch.bfloat16))
        c, hh = _bf16_gates(pre, c, forget_bias)
        hs.append(hh.to(torch.bfloat16))
    return torch.stack(hs), torch.stack(cs)


def _launchers(xs, wx, b, wh, bf16_gates, forget_bias):
    """The checked operands' launches on one set of outputs: ``(calls,
    (hs, cs))``, ``calls["rowblock"]`` the row-block entry and, at
    bfloat16 weights, ``calls["loop"]`` the persistent loop (with its
    ``hx`` scratch). The caller keeps the inputs alive."""
    dev = xs.device
    t, bsz, d = xs.shape
    h, wb = _probe.check_direction(dev, t, bsz, d, xs, wx, b, wh)
    hs = torch.empty((t, bsz, h), dtype=torch.bfloat16, device=dev)
    cs = torch.empty_like(hs)
    head = (xs.data_ptr(), wx.data_ptr(), b.data_ptr(), wh.data_ptr(), t,
            bsz, d, h)
    gf, fb, st = GATE_FORMS[bf16_gates], float(forget_bias), CF._stream(dev)
    calls = {"rowblock": lambda: _probe.launch(
        "srt_seq_fwd_rowblock", "seq_fwd", *head, wb, gf, fb,
        hs.data_ptr(), cs.data_ptr(), st)}
    if wb:
        hx = torch.empty((1, 2, bsz, h), dtype=torch.bfloat16, device=dev)
        plan = _probe.device_plan(dev, bsz, h, d, 1)
        calls["loop"] = lambda: _probe.launch(
            "srt_seq_fwd", "seq_fwd", *head, gf, fb, *plan, hs.data_ptr(),
            cs.data_ptr(), hx.data_ptr(), st)
    return calls, (hs, cs)


def seq_fwd(xs, wx, b, wh, bf16_gates, forget_bias=1.0):
    """The sequence LSTM forward with the gate form ``bf16_gates`` (False
    or True): ``xs [T, B, D]`` and ``b [4H]`` float32, ``wx
    [D, 4H]`` and ``wh [H, 4H]`` of one weight dtype (float32 or
    bfloat16). Returns ``(hs, cs)``, each ``[T, B, H]`` bfloat16 (the JAX
    probe keeps ``hs`` alone). The plain version on CPU tensors; on CUDA
    tensors the kernel, or a raise. The kernel is chosen by the weight
    dtype: bfloat16 weights run the persistent tensor-core loop
    (``srt_seq_fwd``), float32 weights the row-block design
    (``srt_seq_fwd_rowblock``), which no probe runs."""
    if bf16_gates not in GATE_FORMS:
        raise ValueError(f"bf16_gates={bf16_gates!r}: one of "
                         f"{list(GATE_FORMS)}")
    if xs.device.type == "cpu":
        return seq_fwd_plain(xs, wx, b, wh, bf16_gates, forget_bias)
    calls, outs = _launchers(xs, wx, b, wh, bf16_gates, forget_bias)
    calls["loop" if wx.dtype == torch.bfloat16 else "rowblock"]()
    _launches["seq_fwd"] += 1
    return outs


def seq_fwd_entries(xs, wx, b, wh, bf16_gates, forget_bias=1.0):
    """For the A/B on the card: the persistent loop and the row-block
    design on one set of outputs, bfloat16 weights, CUDA tensors only,
    no launch counted. Returns ``(run, (hs, cs))``: ``run("loop")`` or
    ``run("rowblock")`` launches one (and keeps the inputs alive)."""
    if xs.device.type != "cuda" or wx.dtype != torch.bfloat16:
        raise ValueError("seq_fwd_entries: CUDA tensors and bfloat16 "
                         "weights")
    ins = (xs, wx, b, wh)
    calls, outs = _launchers(*ins, bf16_gates, forget_bias)

    def run(design, _held=ins):
        calls[design]()

    return run, outs


def probe_inputs(t, b, h, d, k, device="cuda"):
    """The probe's operands, seeded: ``k`` input sequences, bfloat16
    weights ``N(0, 0.1)``, a zero bias."""
    g = torch.Generator().manual_seed(0)
    xs = torch.randn((k, t, b, d), generator=g).to(device)
    mk = lambda *s: (0.1 * torch.randn(s, generator=g)).to(
        torch.bfloat16).to(device)
    return xs, mk(d, 4 * h), torch.zeros(4 * h, device=device), mk(h, 4 * h)


def run_probe(t=250, b=4096, h=256, d=5, k=8, reps=7, device="cuda"):
    """The A/B on the card and the drift of bfloat16 gates; returns the
    record."""
    dev = torch.device(device)
    xs, wx, bias, wh = probe_inputs(t, b, h, d, k, dev)
    hs = [seq_fwd(xs[0], wx, bias, wh, g)[0].float() for g in GATE_FORMS]
    err = float((hs[1] - hs[0]).abs().max())
    it = dict.fromkeys(GATE_FORMS, 0)

    def arm(gates):
        def call():
            seq_fwd(xs[it[gates] % k], wx, bias, wh, gates)
            it[gates] += 1
        return call

    ms_f, ms_b = _probe.interleaved([arm(g) for g in GATE_FORMS], k, reps)
    plan = _probe.device_plan(dev, b, h, d, 1)
    return {"kind": "probe_bf16_gates", "T": t, "B": b, "H": h,
            "tile": -(-b // (plan.windows * plan.tiles)),
            "calls_per_dispatch": k, "reps": reps, "f32_gates_ms": ms_f,
            "bf16_gates_ms": ms_b, "speedup": ms_f / ms_b,
            "max_abs_err": err, "device_kind": torch.cuda.get_device_name(dev)}


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
