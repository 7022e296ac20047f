"""Hold this checkout's shared training code against another checkout's.

Builds ``fused_rnn.cu`` and ``lstm_seq.cu`` of another checkout of the
repository (``OTHER``, e.g. an earlier commit unpacked with ``git
archive``) beside this checkout's, loads both with ctypes under this
checkout's ``_build.SIGNATURES`` (their C entries must agree), and runs the
same seeded inputs through both: the LayerNorm-LSTM forward and backward
(rows 5f, 5b; also at the LayerNorm ladder's B=4096 at bf16), the LSTM
backward with and without its inputs' gradients (rows 3b, 4b),
``lstm_seq``'s backward (row 7b) and the weight pass alone
(``srt_weight_grad``, row W, at the decoder's and encoder's shapes, with
and without a row of ones, at D = 0). Each case prints one JSON line:
whether every output is bit for bit the other checkout's, and both
builds' times in turns (this, other, other, this; medians). Exits 1 when
any case differs. Needs a card and nvcc::

    python -m sketch_rnn_tpu_torch.scripts.compare_builds OTHER [--reps N]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from sketch_rnn_tpu_torch.ops import _build
from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.ops import cuda_lstm as CL

LIBS = ("fused_rnn", "lstm_seq")
T, B, D = 250, 100, 5
KEEP = 0.9


def build_other(root: Path, name: str, out_dir: Path) -> ctypes.CDLL:
    """``root``'s ``csrc/<name>.cu`` built with this checkout's flags and
    bound with this checkout's signatures."""
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{name}-other.so"
    src = root / "sketch_rnn_tpu_torch" / "csrc" / f"{name}.cu"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.srt_error_string.argtypes = [ctypes.c_int]
    lib.srt_error_string.restype = ctypes.c_char_p
    return lib


def _seeded(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda *s, sc=1.0: (sc * torch.randn(s, generator=g)).to("cuda")


def lstm_case(h, wdt, ln, full, b=B, fwd=False):
    """A backward entry's A/B helper (``*_bwd_entries``) on seeded inputs
    (with ``fwd``, the LayerNorm-LSTM forward's, ``ln_lstm_fwd_entries``):
    ``(made, call)``; ``made()`` returns ``(run, outs)`` bound to the
    library loaded at that moment, ``run(call)`` launches the entry."""
    r = _seeded(h + 7 * ln + 3 * full)
    xs, c0, h0 = r(T, b, D), r(b, h, sc=0.3), r(b, h, sc=0.3)
    wx, wh = r(D, 4 * h, sc=0.4).to(wdt), r(h, 4 * h, sc=h ** -0.5).to(wdt)
    rdt = None if wdt == torch.float32 else wdt
    seed = torch.tensor(4242, dtype=torch.int32, device="cuda")
    drop = dict(dropout_seed=seed, keep_prob=KEEP,
                x_bias=r(b, 4 * h, sc=0.3))
    lnp = (1 + r(4, h, sc=0.1), r(4, h, sc=0.1), 1 + r(h, sc=0.1),
           r(h, sc=0.1))
    if fwd:
        return (lambda: CF.ln_lstm_fwd_entries(xs, wx, wh, *lnp, c0, h0,
                                               **drop, residual_dtype=rdt),
                "srt_ln_lstm_fwd")
    if ln:
        hs, cs = CF.ln_lstm_fwd(xs, wx, wh, *lnp, c0, h0, **drop,
                                residual_dtype=rdt)[:2]
    else:
        hs, cs = CF.lstm_fwd(xs, wx, r(4 * h, sc=0.1), wh, c0, h0, **drop,
                             residual_dtype=rdt)[:2]
    cot = dict(dhs=r(T, b, h, sc=0.1).to(hs.dtype), dcT=r(b, h, sc=0.1),
               dhT=r(b, h, sc=0.1))
    if ln:
        return (lambda: CF.ln_lstm_bwd_entries(xs, wx, wh, *lnp, h0, hs, cs,
                                               **cot, **drop),
                "srt_ln_lstm_bwd")
    bias = r(4 * h, sc=0.1)
    if not full:
        cot = dict(dhs=cot["dhs"])
        drop = dict(dropout_seed=seed, keep_prob=KEEP)
    return (lambda: CF.lstm_bwd_entries(xs, wx, bias, wh, h0, hs, cs, **cot,
                                        **drop, full=full), "srt_lstm_bwd")


def lstm_seq_case(h):
    """``lstm_seq``'s backward on seeded gates and residuals."""
    r = _seeded(h + 11)
    g4 = torch.sigmoid(r(T, B, 4 * h))
    wh = r(h, 4 * h, sc=h ** -0.5)
    cs, hs, h0 = r(T, B, h, sc=0.3), r(T, B, h, sc=0.3), r(B, h, sc=0.3)
    masks = ((torch.rand((T, B, h)) < KEEP).float() / KEEP).to("cuda")
    dhs, dcT, dhT = r(T, B, h, sc=0.1), r(B, h, sc=0.1), r(B, h, sc=0.1)
    return (lambda: CL.lstm_seq_bwd_entries(wh, g4, cs, hs, h0, masks, dhs,
                                            dcT, dhT), "srt_lstm_seq_bwd")


def weight_case(d, h, ones, wdt):
    """The weight pass alone (``weight_grad_entries``, variant 0)."""
    r = _seeded(d + h + ones)
    xs, h0 = r(T, B, d), r(B, h, sc=0.3)
    hs, d_pre = r(T, B, h, sc=0.3).to(wdt), r(T, B, 4 * h, sc=0.01)
    return (lambda: CF.weight_grad_entries(xs, h0, hs, d_pre, ones, wdt), 0)


def _turns(fn, reps):
    """ms of ``reps`` calls of ``fn``, each between its own CUDA events."""
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def compare(label, lib_name, case, libs, reps, stages=()):
    """Both builds on one case: bitwise, then timed in turns (and, with
    ``stages``, each stage of the entry alone: ``call + "_stage"``)."""
    made, call = case
    runs, snaps, stage_runs = {}, {}, {}
    for who, lib in libs.items():
        _build._libs[lib_name] = lib
        run, outs = made()
        del _build._libs[lib_name]
        run(call)
        torch.cuda.synchronize()
        snaps[who] = [o.clone() for o in outs if o is not None]
        runs[who] = (lambda run=run: run(call))
        stage_runs[who] = (lambda k, run=run: run(call + "_stage", k))
    same = all(torch.equal(a, b) for a, b in zip(snaps["this"],
                                                  snaps["other"]))
    for fn in runs.values():
        fn()
    ms = {"this": [], "other": []}
    for _ in range(reps):
        order = ("this", "other", "other", "this")
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        evs[0].record()
        for who, ev in zip(order, evs[1:]):
            runs[who]()
            ev.record()
        torch.cuda.synchronize()
        for i, who in enumerate(order):
            ms[who].append(evs[i].elapsed_time(evs[i + 1]))
    rec = {"case": label, "bitwise": same,
           "ms": statistics.median(ms["this"]),
           "other_ms": statistics.median(ms["other"])}
    if stages:      # each stage of the entry alone, in the same turns
        for key, who in (("stages_ms", "this"), ("other_stages_ms",
                                                 "other")):
            rec[key] = [statistics.median(_turns(
                lambda k=k: stage_runs[who](k), reps)) for k in stages]
    print(json.dumps(rec), flush=True)
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_builds: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    _build.build_all(list(LIBS))
    out_dir = _build.BUILD_DIR / "compare"
    this = {n: _build.load(n) for n in LIBS}
    other = {n: build_other(args.other, n, out_dir) for n in LIBS}
    f32, bf16 = torch.float32, torch.bfloat16
    ok = True
    for dt in (f32, bf16):
        tag = "f32" if dt == f32 else "bf16"
        for label, case in (
                (f"5f srt_ln_lstm_fwd H=512 {tag}",
                 lstm_case(512, dt, 1, 1, fwd=True)),
                (f"5b srt_ln_lstm_bwd H=512 {tag}", lstm_case(512, dt, 1, 1)),
                (f"3b srt_lstm_bwd H=512 {tag}", lstm_case(512, dt, 0, 1)),
                (f"4b srt_lstm_bwd H=256 {tag}", lstm_case(256, dt, 0, 0)),
                (f"W D=5 H=512 {tag}", weight_case(5, 512, 0, dt)),
                (f"W D=5 H=512 ones {tag}", weight_case(5, 512, 1, dt)),
                (f"W D=5 H=256 ones {tag}", weight_case(5, 256, 1, dt))):
            stages = (() if label[:2] in ("W ", "5f") else
                      (1, 2, 3, 4) if label.startswith("5b") else (1, 2, 3))
            ok &= compare(label, "fused_rnn", case,
                          {"this": this["fused_rnn"],
                           "other": other["fused_rnn"]}, args.reps, stages)
    for label, fwd in (("5f srt_ln_lstm_fwd H=512 B=4096 bf16", True),
                       ("5b srt_ln_lstm_bwd H=512 B=4096 bf16", False)):
        ok &= compare(label, "fused_rnn",
                      lstm_case(512, bf16, 1, 1, b=4096, fwd=fwd),
                      {"this": this["fused_rnn"],
                       "other": other["fused_rnn"]}, args.reps)
    ok &= compare("W D=0 H=512 f32", "fused_rnn",
                  weight_case(0, 512, 0, f32),
                  {"this": this["fused_rnn"], "other": other["fused_rnn"]},
                  args.reps)
    ok &= compare("7b srt_lstm_seq_bwd H=512 f32", "lstm_seq",
                  lstm_seq_case(512),
                  {"this": this["lstm_seq"], "other": other["lstm_seq"]},
                  args.reps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
