"""Probe: would storing the layer-norm statistics speed up the decoder
backward, on the card?

The port of ``scripts/probe_ln_stats.py``. The LayerNorm-LSTM backward
needs the forward's layer-norm statistics (mean and rstd of the four gate
norms and of the cell norm) at every step; on the card production hoists
them out of its loop into one launch over all row-steps
(``ln_stats_kernel``). Storing the forward's (mean, rstd) pairs as
residual streams would replace that launch with reads. :func:`bwd_fake`
(kernel ``srt_ln_probe_bwd`` of ``csrc/probe_ln.cu``, arm ``fake``) is
the production backward with the five pairs replaced by stand-ins
(``mean = c_prev[:, 0] * 1e-3``, ``r = 1 + c_prev[:, 1] * 1e-3``, read
from the residual ``cs``; numerically wrong, a pure op-count probe, as
the reference's ``_bwd_kernel_fake``): no statistics launch, the
corrections' two exchanges, all three grid barriers a step and every
product kept. It is the lever's upper bound, since a real implementation
would also read the stats streams.

:func:`run_probe` times the production backward (the ladder's ``prod``
arm, which is ``fused_ln_lstm``'s ``srt_ln_lstm_bwd``) against it,
interleaved with CUDA events, then the production arm again as the drift
check, at the reference's shape and inputs
(``probe_dec_bwd_split.probe_inputs``). The reference's decision rule:
the fake-stats arm under 0.95x the production time means invest in stats
residuals, else record the negative. :func:`main` prints the record (the
reference's keys, ``tile`` the loop's rows per batch tile,
``device_kind`` from the card). The row-block design the arm ran before
stays reachable as ``srt_ln_probe_bwd_rowblock``
(``probe_dec_bwd_split.bwd_entries("fake", ...)``). Run on a card:

    python -m sketch_rnn_tpu_torch.scripts.probe_ln_stats [--reps 3] \\
        [--k 2] [--batch 4096] [--seq_len 250]

It prints and appends to no file.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sketch_rnn_tpu_torch.scripts import _probe
from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as PS

INVEST_BELOW = 0.95     # fake / prod under this: stats residuals may pay

_launches = {"bwd_fake": 0}


def reset_launch_counts() -> None:
    _launches["bwd_fake"] = 0


def launch_counts() -> dict:
    return dict(_launches)


def bwd_fake(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs,
             dhs, dcT, dhT, x_bias=None, dropout_seed=None, keep_prob=1.0,
             forget_bias=1.0):
    """The production LayerNorm-LSTM backward with stand-in forward
    statistics: the operands and results of
    ``probe_dec_bwd_split.bwd_arm``. The plain version
    (``probe_dec_bwd_split.bwd_plain(\"fake\", ...)``) on CPU tensors; on
    CUDA tensors the kernel, or a raise."""
    args = (xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs,
            dhs, dcT, dhT, x_bias, dropout_seed, keep_prob, forget_bias)
    if xs.device.type == "cpu":
        return PS.bwd_plain("fake", *args)
    return PS.bwd_kernel("fake", _launches, "bwd_fake", *args)


def run_probe(b=4096, t=250, k=2, reps=3, device="cuda"):
    """The A/B on the card; returns the record."""
    dev = torch.device(device)
    inp = PS.bwd_inputs(PS.probe_inputs(b, t, dev))
    prod = lambda: PS.bwd_arm("prod", **inp)
    fake = lambda: bwd_fake(**inp)
    a, f = _probe.interleaved([prod, fake], k, reps)
    a2 = _probe.interleaved([prod], k, reps)[0]
    return {"kind": "probe_ln_stats",
            "device_kind": torch.cuda.get_device_name(dev), "batch_size": b,
            "seq_len": t, "H": PS.H, "D": PS.D,
            "tile": PS.batch_tile(b, dev), "reps": reps,
            "calls_per_dispatch": k, "prod_bwd_ms": a,
            "fake_stats_bwd_ms": f, "prod_bwd_ms_recheck": a2,
            "speedup_ceiling": a / f,
            "invest_in_stats_residuals": f < INVEST_BELOW * a}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--k", type=int, default=2,
                    help="kernel calls per timing")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seq_len", type=int, default=250)
    args = ap.parse_args(argv)
    print(json.dumps(run_probe(args.batch, args.seq_len, args.k, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
