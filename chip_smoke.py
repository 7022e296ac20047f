#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100:
the kernels are built for sm_90a) and the CUDA toolkit. Every phase
prints one JSON line; any failure raises and the script exits non-zero
without the final line. With no CUDA device it exits 2 at once.

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — builds the kernels of ``sketch_rnn_tpu_torch/csrc`` with
   nvcc (ops/_build.py), one nvcc per source started together, and
   reports the build time.
3. kernel  — each kernel against its plain PyTorch version on the same
   CUDA tensors, with times (CUDA events) beside the card's bound for
   the same work:
   - the serving kernels at the serving shapes of the full-width model
     (B=64 slots, K=8 steps, H=512, M=20, Nz=128; replay at E=64):
     errors, exact agreement of t/done/pen away from CDF near-ties;
   - the four training kernels (``fused_lstm_seq`` and ``fused_ln_lstm``,
     forward and backward) at the training shapes (B=100, T=250, encoder
     H=256, decoder H=512 with its x_bias, dropout seeded at keep 0.9):
     every output and gradient within FUSED_TOL, the in-kernel dropout
     masks bitwise the plain ``prng_mask`` ones, every result identical
     run to run; cuDNN's LSTM (``torch.nn.LSTM``) timed beside
     ``fused_lstm_seq`` as a yardstick only.
4. serve   — the serving main path: ``ServeEngine`` at the full
   ``layer_norm`` preset (conditional VAE, bi-LSTM encoder 256,
   LayerNorm-LSTM decoder 512, serve_slots=64, serve_chunk=8,
   max_seq_len=250) on seeded random weights serves 128 ``generate``
   requests, then ``serve_requests`` serves 32 ``complete`` and 32
   ``reconstruct`` requests on synthetic prefixes. The serving kernels'
   launch counters are zeroed just before and read just after, and must
   show both kernels launched. A small burst served on the card is then
   held against the same burst served by the plain versions on the CPU.
5. profile — a 64-request burst timed, then profiled: device time by
   kernel and the device's busy share of the burst.
6. train   — the training main path: ``train/loop.train`` on the
   flagship ``quickdraw345_dp`` model at float32 (seeded random weights,
   the synthetic 345-class corpus), 2 warm-up steps, then 10 steps timed
   with the training kernels' launch counters zeroed just before and read
   just after: exactly 2 launches per step of each ``fused_lstm_seq``
   kernel and 1 of each ``fused_ln_lstm`` kernel, finite losses.
7. train_reference — one full-width step through the kernels against the
   same step through the plain versions on the card, and one small step
   on the card against the same step on the CPU.
8. train_profile — two train steps timed, then profiled.
9. the kernels line, the ``nvidia-smi`` line, and the result line.

Random serving weights carry the pen-suppression sentinel ``out_b[2] =
-1e9`` (an untrained model ends a sketch after a few steps) and requests
carry seeded caps in [16, 250], so sketches run to QuickDraw-like
lengths.
"""

import contextlib
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

B, K, E = 64, 8, 64
# kernel vs plain version on the card, float32. Both sum 512-term dot
# products, in different orders, so they round differently (~1e-7
# relative per step), and the gaps compound through the recurrence and
# the sampler's exp(log_sigma) * normal scaling. Measured on an H100
# (PERF.md): decode (8 steps) <= 1.5e-6 on carries and offsets, replay
# (64 steps) <= 7.7e-6 on carries. TOL keeps a 13x margin over the
# largest; a wrong gate order or layer-norm association errs by ~1e-1.
TOL = 1e-4
NEAR_TIE = 1e-5    # a draw whose uniform is this close to a CDF edge may
#                    flip under rounding; such rows are counted, not held


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(flops, moved_bytes):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = moved_bytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def full_width(cell, seed=0):
    import torch

    from sketch_rnn_tpu_torch import HParams
    from sketch_rnn_tpu_torch.models.vae import SketchRNN

    hps = HParams(conditional=True, dec_model=cell, serve_slots=B,
                  serve_chunk=K)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device="cuda")
    return hps, model, params


def check_decode(cell):
    """decode_chunk vs its plain version at the serving shapes."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params = full_width(cell)
    # a p3 logit bias of -3 keeps most rows drawing through the chunk
    # while some still end on their own; every 4th row hits its cap
    # mid-chunk and every 16th starts done
    params["out_b"][2] = -3.0
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    z = torch.randn((B, hps.z_size), generator=g).to(dev)
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, B))
    prev0 = torch.tensor([0, 0, 1.0, 0, 0]).expand(B, 5).contiguous().to(dev)
    keys = prng.fold_in(prng.key(1), torch.arange(B)).to(dev)
    t0 = torch.randint(0, 200, (B,), generator=g, dtype=torch.int32)
    caps = torch.where(torch.arange(B) % 4 == 0,
                       t0 + torch.randint(1, K, (B,), generator=g,
                                          dtype=torch.int32),
                       torch.full((B,), 250, dtype=torch.int32)).to(dev)
    t0 = t0.to(dev)
    u = cd.make_uniforms(keys, t0, K)
    temps = (0.4 + torch.rand((B,), generator=g)).to(dev)
    done0 = (torch.arange(B) % 16 == 3).to(dev)
    end = torch.tensor([0, 0, 0, 0, 1.0]).to(dev)
    args = (params["dec"], params["out_w"], params["out_b"], c0, h0, prev0,
            z, u, temps, t0, done0, caps, end)
    kw = dict(cell_kind=cell, num_mixture=hps.num_mixture)
    got = cd.decode_chunk(*args, **kw)
    torch.cuda.synchronize()
    *want, margin = cd.decode_chunk_reference(*args, **kw,
                                              return_margin=True)
    near = (margin < NEAR_TIE).cpu()
    keep = ~near
    s_k, s_p = got[0].cpu()[:, keep], want[0].cpu()[:, keep]
    for name, a, b in (("t", got[3], want[3]), ("done", got[4], want[4])):
        if not torch.equal(a.cpu()[keep], b.cpu()[keep]):
            raise AssertionError(f"decode_chunk[{cell}]: {name} differs "
                                 f"from the plain version")
    if not torch.equal(s_k[..., 2:], s_p[..., 2:]):
        raise AssertionError(f"decode_chunk[{cell}]: pen states differ")
    off_err = float((s_k[..., :2] - s_p[..., :2]).abs().max())
    carry_err = max(float((a.cpu()[keep] - b.cpu()[keep]).abs().max())
                    for a, b in ((got[1], want[1]), (got[2], want[2])))
    if not (off_err <= TOL and carry_err <= TOL):
        raise AssertionError(
            f"decode_chunk[{cell}]: offsets err {off_err}, carry err "
            f"{carry_err} (tol {TOL})")
    ms = cuda_ms(lambda: cd.decode_chunk(*args, **kw), 50)
    plain_ms = cuda_ms(lambda: cd.decode_chunk_reference(*args, **kw), 5)
    # the work this run's data needs: the live row-steps' products
    h, p = hps.dec_rnn_size, 6 * hps.num_mixture + 3
    live = int((got[3] - t0).sum())
    flops = 2 * live * (5 * 4 * h + h * 4 * h + h * p)
    cp = params["dec"]
    moved = (nbytes(*(cp[k] for k in cp if k != "wx"), params["out_w"],
                    params["out_b"], c0, h0, prev0, u, temps, t0, done0,
                    caps, end, *got)
             + 5 * 4 * h * 4 + B * 4 * h * 4)  # wx[:5], extra @ wx[5:]
    bms, by = bound_ms(flops, moved)
    log("kernel", name="decode_chunk", cell=cell, B=B, K=K, H=h,
        M=hps.num_mixture, near_tie_rows=int(near.sum()),
        offset_err=off_err, carry_err=carry_err, tol=TOL, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, live_row_steps=live,
        flops=flops, bytes=moved)
    return {"err": max(off_err, carry_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}


def check_replay(cell):
    """replay_chunk vs its plain version at B=64, E=64."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd

    hps, model, params = full_width(cell)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    z = torch.randn((B, hps.z_size), generator=g).to(dev)
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, B))
    xs = torch.zeros((E, B, 5))
    xs[..., :2] = torch.randn((E, B, 2), generator=g)
    pen = torch.randint(0, 2, (E, B), generator=g)
    xs[..., 2] = (pen == 0).float()
    xs[..., 3] = (pen == 1).float()
    xs = xs.to(dev)
    seq_len = torch.randint(1, E + 1, (B,), generator=g,
                            dtype=torch.int32).to(dev)
    args = (params["dec"], c0, h0, xs, z, seq_len)
    kw = dict(cell_kind=cell)
    got = cd.replay_chunk(*args, **kw)
    torch.cuda.synchronize()
    want = cd.replay_chunk_reference(*args, **kw)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not err <= TOL:
        raise AssertionError(f"replay_chunk[{cell}]: carry err {err} "
                             f"(tol {TOL})")
    ms = cuda_ms(lambda: cd.replay_chunk(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: cd.replay_chunk_reference(*args, **kw), 3)
    h = hps.dec_rnn_size
    live = int(seq_len.sum())
    flops = 2 * live * (5 * 4 * h + h * 4 * h)
    cp = params["dec"]
    moved = (nbytes(*(cp[k] for k in cp if k != "wx"), c0, h0, xs,
                    seq_len, *got) + 5 * 4 * h * 4 + B * 4 * h * 4)
    bms, by = bound_ms(flops, moved)
    log("kernel", name="replay_chunk", cell=cell, B=B, E=E, H=h,
        carry_err=err, tol=TOL, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, live_row_steps=live, flops=flops,
        bytes=moved)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by}


def synthetic_prefix(rng, n):
    """A stroke-3 sketch prefix of ``n`` rows: offsets ~ N(0, 1), the pen
    lifted about one row in eight."""
    import numpy as np

    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.normal(size=(n, 2))
    p[:, 2] = rng.random(n) < 0.125
    return p


def check_result(res, cap):
    import numpy as np

    s5 = res.strokes5
    if not (s5.shape == (res.steps, 5) and np.isfinite(s5).all()
            and 1 <= res.steps <= cap):
        raise AssertionError(f"request {res.uid}: bad strokes "
                             f"{s5.shape} steps {res.steps} cap {cap}")
    if not np.array_equal(s5[:, 2:].sum(-1), np.ones(res.steps)):
        raise AssertionError(f"request {res.uid}: pen rows not one-hot")


def serve_main_path(card):
    import numpy as np
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params = full_width("layer_norm")
    params["out_b"][2] = -1e9          # pen-suppression sentinel
    engine = ServeEngine(model, hps, params)
    rng = np.random.default_rng(0)
    n_gen, n_enc = 128, 32
    z = rng.normal(size=(n_gen, hps.z_size)).astype(np.float32)
    caps = rng.integers(16, hps.max_seq_len + 1, n_gen + 2 * n_enc)
    k0 = prng.key(0)
    gen = [Request(key=prng.fold_in(k0, i), z=z[i], temperature=0.8,
                   max_len=int(caps[i])) for i in range(n_gen)]
    enc = [Request(key=prng.fold_in(k0, n_gen + i),
                   endpoint="complete" if i < n_enc else "reconstruct",
                   prefix=synthetic_prefix(rng, int(rng.integers(33, 65))),
                   temperature=0.8, max_len=int(caps[n_gen + i]))
           for i in range(2 * n_enc)]

    cd.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_gen = engine.run(gen)
    t1 = time.perf_counter()
    out_enc = serve_requests(model, hps, params, enc, engine=engine)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"decode_chunk": cd.decode_chunk_launches,
                "replay_chunk": cd.replay_chunk_launches}

    m_gen, m_enc = out_gen["metrics"], out_enc["metrics"]
    if m_gen["completed"] != n_gen or m_enc["completed"] != 2 * n_enc:
        raise AssertionError(f"completed {m_gen['completed']}/{n_gen} "
                             f"and {m_enc['completed']}/{2 * n_enc}")
    for res in out_gen["results"]:
        check_result(res, int(caps[res.uid]))
    for res in out_enc["results"]:
        check_result(res, int(caps[n_gen + res.uid]))
    chunks = m_gen["chunks"] + m_enc["chunks"]
    # one encode batch: the 64 prefixes share the edge 64 and fill the
    # 64 encode rows
    if launches != {"decode_chunk": chunks, "replay_chunk": 1}:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{chunks} decode_chunk and 1 replay_chunk")
    log("serve", card=card, preset="layer_norm", slots=B, chunk=K,
        launches=launches,
        generate={k: m_gen[k] for k in (
            "completed", "wall_s", "sketches_per_sec", "chunks",
            "decode_steps", "slot_utilization", "latency_p50_s",
            "latency_p99_s")},
        generate_ms_per_chunk=(t1 - t0) * 1e3 / m_gen["chunks"],
        encode_endpoints={k: m_enc[k] for k in (
            "completed", "wall_s", "sketches_per_sec", "chunks",
            "decode_steps", "slot_utilization")},
        encode_endpoints_wall_s=t2 - t1)
    return launches


def serve_small_vs_cpu():
    """A small full-width burst served on the card and by the plain
    versions on the CPU: steps and pens equal, offsets within tolerance.
    8 requests x 8 steps: a near-tie flip (~1e-7 rounding against CDF
    edges) has a chance of order 1e-4 here."""
    import numpy as np

    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.utils import prng
    from sketch_rnn_tpu_torch.utils.device import tree_to

    hps, model, params = full_width("layer_norm", seed=3)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(8, hps.z_size)).astype(np.float32)

    def burst(device, p):
        reqs = [Request(key=prng.fold_in(prng.key(3), i), z=z[i],
                        temperature=0.8, max_len=K) for i in range(8)]
        out = ServeEngine(model, hps, p, slots=8, device=device).run(reqs)
        return {r.uid: r for r in out["results"]}

    card = burst(None, params)
    cpu = burst("cpu", tree_to(params, "cpu"))
    err = 0.0
    for uid, r in cpu.items():
        a = card[uid]
        if a.steps != r.steps or not np.array_equal(
                a.strokes5[:, 2:], r.strokes5[:, 2:]):
            raise AssertionError(f"request {uid}: card and CPU differ in "
                                 f"steps or pen states")
        err = max(err, float(np.abs(a.strokes5 - r.strokes5).max()))
    if not err <= TOL:
        raise AssertionError(f"card vs CPU offsets err {err}")
    log("reference", requests=8, steps=K, max_abs_err=err, tol=TOL)


def profile_generate():
    """Where a generate burst's time goes: 64 requests of 64 steps on the
    main-path engine, timed once without and once under torch.profiler
    (CPU and CUDA activity). Reports the kernels' device time by name
    and the device's busy share of the unprofiled wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params = full_width("layer_norm")
    params["out_b"][2] = -1e9          # pen-suppression sentinel
    engine = ServeEngine(model, hps, params)
    z = np.random.default_rng(5).normal(
        size=(B, hps.z_size)).astype(np.float32)

    def burst():
        reqs = [Request(key=prng.fold_in(prng.key(5), i), z=z[i],
                        temperature=0.8, max_len=64) for i in range(B)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = engine.run(reqs)["metrics"]
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    burst()                            # warm-up
    m, wall = burst()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = burst()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    log("profile", requests=B, chunks=m["chunks"], wall_ms=wall * 1e3,
        host_ms_per_chunk=wall * 1e3 / m["chunks"],
        profiled_wall_ms=wall_prof * 1e3, device_ms=total / 1e3,
        device_busy_share=total / 1e6 / wall,
        device_kernels_per_chunk=sum(e.count for e in kernels)
        / m["chunks"],
        top=[{"name": e.key[:60], "device_ms": e.self_device_time_total
              / 1e3, "count": e.count} for e in top])


# -- the training path -----------------------------------------------------

DEV = "cuda"
KEEP = 0.9             # recurrent-dropout keep probability (hps default)
TRAIN_STEPS, WARM_STEPS = 10, 2
FUSED_SRC = "sketch_rnn_tpu_torch/csrc/fused_rnn.cu"
FUSED_REPLACES = {     # the Pallas kernel bodies each CUDA kernel replaces
    "fused_lstm_seq_fwd": "sketch_rnn_tpu/ops/pallas_fused.py:621",
    "fused_lstm_seq_bwd": "sketch_rnn_tpu/ops/pallas_fused.py:648",
    "fused_ln_lstm_fwd": "sketch_rnn_tpu/ops/pallas_fused.py:826",
    "fused_ln_lstm_bwd": "sketch_rnn_tpu/ops/pallas_fused.py:900",
}
# training kernels vs their plain versions on the card, float32, as the
# largest error of each output relative to that output's largest
# magnitude. Both sum 256/512-term (and, for the weight gradients,
# 25,000-term) products in different orders; the gaps compound through
# 250 steps of recurrence. Measured on an H100 (PERF.md): seq fwd
# 2.1e-7, seq bwd 4.2e-6, LN fwd 1.5e-6, LN bwd 5.0e-6. TOL keeps a 20x
# margin over the largest; a wrong gate, mask or LN term errs by ~1e-1.
FUSED_TOL = 1e-4
# one train step through the kernels vs the same step (state, batch,
# key) through the plain versions: loss and grad norm relative, the
# parameter update absolute (Adam's updates are ~lr = 1e-3). Measured on
# an H100: loss and grad norm 0 (full width) and 1.2e-7 (small step,
# card vs CPU), updates 6.0e-8 and 3.0e-8. Margins: 85x and 17x.
STEP_REL_TOL = 1e-5
UPDATE_TOL = 1e-6


def train_hps(**over):
    """The model of the flagship ``quickdraw345_dp`` preset
    (``sketch_rnn_tpu/cli.py`` PRESETS): conditional VAE, bi-LSTM encoder
    256, LayerNorm-LSTM decoder 512, Nz=128, M=20, 345 classes, fused
    RNN kernels, recurrent dropout at keep 0.9, B=100, T=250, at float32
    compute and residuals."""
    from sketch_rnn_tpu_torch import HParams

    return HParams(**{**dict(conditional=True, dec_model="layer_norm",
                             num_classes=345, fused_rnn=True), **over})


def train_setup(seed=0, **over):
    import torch

    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.models.vae import SketchRNN

    hps = train_hps(**over)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device=DEV)
    loader, _ = synthetic_loader(hps, num=10 * hps.batch_size, seed=seed)
    return hps, model, params, loader


FUSED_OUTPUTS = {
    "fused_lstm_seq_fwd": ("hs", "cs"),
    "fused_lstm_seq_bwd": ("dwx", "db", "dwh"),
    "fused_ln_lstm_fwd": ("hs", "cs", "cT", "hT"),
    "fused_ln_lstm_bwd": ("dxs", "dx_bias", "dwx", "dwh", "dln_gamma",
                          "dln_beta", "dlnc_gamma", "dlnc_beta", "dc0",
                          "dh0"),
}


def rel_errs(names, got, want):
    """``(max abs error, max error relative to each output's largest
    magnitude, {output: max abs error})`` over the paired outputs."""
    ab = rel = 0.0
    per = {}
    for n, a, b in zip(names, got, want):
        d = float((a - b).abs().max())
        per[n] = d
        ab = max(ab, d)
        rel = max(rel, d / max(float(b.abs().max()), 1e-30))
    return ab, rel, per


def streamed_masks(seed, t, b, h):
    """The in-kernel masks of every step as a ``[T, B, H]`` tensor."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    return torch.stack([CF.prng_mask(seed, s, b, h, KEEP) for s in range(t)])


def fused_inputs():
    """The training kernels' inputs as the main path builds them: one
    synthetic batch, the model's own weights, the decoder's per-example
    gate bias and initial carry from a seeded z, dropout seeds drawn as
    ``ops/rnn.py`` draws them, and seeded output cotangents."""
    import torch

    from sketch_rnn_tpu_torch.train.step import batch_to_device
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params, loader = train_setup()
    batch = batch_to_device(loader.next_batch(), DEV)
    strokes = batch["strokes"].transpose(0, 1).float()
    g = torch.Generator().manual_seed(7)
    b = hps.batch_size
    z = torch.randn((b, hps.z_size), generator=g).to(DEV)
    extra = model._decoder_extra(params, z, batch["labels"])
    c0, h0 = (x.contiguous()
              for x in model.decoder_initial_carry(params, z, b))
    seeds = [prng.randint(prng.key(s), 0, 2 ** 31 - 1).to(DEV)
             for s in (1, 2)]
    t = hps.max_seq_len

    def cot(h):
        return (0.01 * torch.randn((t, b, h), generator=g)).to(DEV)

    return {"hps": hps, "model": model, "params": params,
            "x_in": strokes[:-1].contiguous(),
            "x_tgt": strokes[1:].contiguous(),
            "x_bias": extra @ params["dec"]["wx"][5:], "c0": c0, "h0": h0,
            "seed_enc": seeds[0], "seed_dec": seeds[1],
            "dhs_enc": cot(hps.enc_rnn_size), "dhs_dec": cot(hps.dec_rnn_size),
            "dcT": (0.01 * torch.randn((b, hps.dec_rnn_size),
                                       generator=g)).to(DEV),
            "dhT": (0.01 * torch.randn((b, hps.dec_rnn_size),
                                       generator=g)).to(DEV)}


def hold_fused(name, run, ref, seed_kw, masks_kw, rows):
    """One training kernel against its plain version on the same inputs
    (``run``/``ref`` take keyword dropout arguments): outputs within
    FUSED_TOL, the in-kernel masks bitwise the streamed ``prng_mask``
    ones (the kernel's outputs with either are identical), the kernel
    deterministic run to run. Returns the outputs."""
    import torch

    got = run(**seed_kw)
    again = run(**seed_kw)
    streamed = run(**masks_kw)
    torch.cuda.synchronize()
    want = ref(**seed_kw)
    ab, rel, per = rel_errs(FUSED_OUTPUTS[name], got, want)
    same = lambda x, y: all(torch.equal(a, b) for a, b in zip(x, y))
    masks_bitwise, deterministic = same(got, streamed), same(got, again)
    if not (rel <= FUSED_TOL and masks_bitwise and deterministic):
        raise AssertionError(
            f"{name}: rel err {rel} (tol {FUSED_TOL}), masks bitwise "
            f"{masks_bitwise}, deterministic {deterministic}")
    rows[name] = {"err": ab, "rel_err": rel, "errs": per,
                  "masks_bitwise": masks_bitwise,
                  "deterministic": deterministic}
    return got


def time_fused(name, run, ref, kw, iters, flops, moved, rows, **extra):
    ms = cuda_ms(lambda: run(**kw), iters)
    plain_ms = cuda_ms(lambda: ref(**kw), 2)
    bms, by = bound_ms(flops, moved)
    rows[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=None, **extra)
    log("kernel", name=name, tol=FUSED_TOL, flops=flops, bytes=moved,
        **rows[name])


def cudnn_lstm(ep, forget_bias):
    """``torch.nn.LSTM`` (cuDNN) holding the same weights: gates permuted
    from (i, g, f, o) to (i, f, g, o), the forget bias folded into the
    input bias. A yardstick only: the port never calls it."""
    import torch

    d, g4 = ep["wx"].shape
    lstm = torch.nn.LSTM(d, g4 // 4).to(DEV)

    def perm(w):
        i, g, f, o = w.chunk(4, 0)
        return torch.cat([i, f, g, o], 0)

    b = ep["b"].clone()
    b[g4 // 2:3 * g4 // 4] += forget_bias
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(perm(ep["wx"].T))
        lstm.weight_hh_l0.copy_(perm(ep["wh"].T))
        lstm.bias_ih_l0.copy_(perm(b))
        lstm.bias_hh_l0.zero_()
    return lstm


def check_lstm_seq(inp, rows):
    """fused_lstm_seq forward and backward (the encoder's forward
    direction) at B=100, T=250, H=256, dropout seeded."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    ep, cell = inp["params"]["enc_fwd"], inp["model"].enc_fwd
    xs, dhs = inp["x_tgt"], inp["dhs_enc"]
    t, b, d = xs.shape
    h = ep["wh"].shape[0]
    zero = torch.zeros((b, h), device=DEV)
    fargs = dict(xs=xs, wx=ep["wx"], b=ep["b"], wh=ep["wh"], c0=zero,
                 h0=zero, forget_bias=cell.forget_bias)
    seed_kw = dict(dropout_seed=inp["seed_enc"], keep_prob=KEEP)
    masks_kw = dict(masks=streamed_masks(inp["seed_enc"], t, b, h),
                    keep_prob=KEEP)
    hs, cs = hold_fused("fused_lstm_seq_fwd",
                        lambda **k: CF.lstm_seq_fwd(**fargs, **k),
                        lambda **k: CF.lstm_seq_fwd_reference(**fargs, **k),
                        seed_kw, masks_kw, rows)
    bargs = dict(xs=xs, wx=ep["wx"], b=ep["b"], wh=ep["wh"], h0=zero, hs=hs,
                 cs=cs, dhs=dhs, forget_bias=cell.forget_bias)
    grads = hold_fused("fused_lstm_seq_bwd",
                       lambda **k: CF.lstm_seq_bwd(**bargs, **k),
                       lambda **k: CF.lstm_seq_bwd_reference(**bargs, **k),
                       seed_kw, masks_kw, rows)

    # cuDNN's LSTM computes the same function without dropout: check it
    # does, then time its training forward and its backward
    lstm = cudnn_lstm(ep, cell.forget_bias)
    hc = (zero[None], zero[None])
    out, _ = lstm(xs, hc)
    nodrop = CF.lstm_seq_fwd(**fargs)[0]
    lib_err = float((out.detach() - nodrop).abs().max())
    if not lib_err <= FUSED_TOL:
        raise AssertionError(f"cuDNN LSTM vs fused_lstm_seq: {lib_err}")
    lib_fwd = cuda_ms(lambda: lstm(xs, hc), 20)
    params = list(lstm.parameters())
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, params, dhs,
                                                  retain_graph=True), 10)

    g4 = 4 * h
    fwd_flops = 2 * t * b * (d + h) * g4
    time_fused("fused_lstm_seq_fwd", CF.lstm_seq_fwd,
               CF.lstm_seq_fwd_reference, {**fargs, **seed_kw}, 20,
               fwd_flops, nbytes(xs, ep["wx"], ep["b"], ep["wh"], zero, zero,
                                 inp["seed_enc"], hs, cs), rows,
               cudnn_err_no_dropout=lib_err)
    rows["fused_lstm_seq_fwd"]["library_ms"] = lib_fwd
    time_fused("fused_lstm_seq_bwd", CF.lstm_seq_bwd,
               CF.lstm_seq_bwd_reference, {**bargs, **seed_kw}, 10,
               fwd_flops + 2 * t * b * h * g4 + 2 * t * b * (d + h + 1) * g4,
               nbytes(xs, ep["wx"], ep["b"], ep["wh"], zero, hs, cs, dhs,
                      inp["seed_enc"], *grads), rows)
    rows["fused_lstm_seq_bwd"]["library_ms"] = lib_bwd
    log("kernel_library", name="fused_lstm_seq", library="torch.nn.LSTM "
        "(cuDNN), TF32 off", fwd_ms=lib_fwd, bwd_ms=lib_bwd,
        err_vs_kernel_no_dropout=lib_err)


def check_ln_lstm(inp, rows):
    """fused_ln_lstm forward and backward (the decoder) at B=100, T=250,
    H=512, with its x_bias, dropout seeded."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    dp, cell = inp["params"]["dec"], inp["model"].dec
    xs, dhs = inp["x_in"], inp["dhs_dec"]
    t, b, d = xs.shape
    h = dp["wh"].shape[0]
    ln = dict(ln_gamma=dp["ln_gamma"], ln_beta=dp["ln_beta"],
              lnc_gamma=dp["lnc_gamma"], lnc_beta=dp["lnc_beta"])
    common = dict(xs=xs, wx=dp["wx"][:d], wh=dp["wh"], **ln,
                  forget_bias=cell.forget_bias, x_bias=inp["x_bias"])
    fargs = dict(common, c0=inp["c0"], h0=inp["h0"])
    seed_kw = dict(dropout_seed=inp["seed_dec"], keep_prob=KEEP)
    masks_kw = dict(masks=streamed_masks(inp["seed_dec"], t, b, h),
                    keep_prob=KEEP)
    hs, cs, ct, ht = hold_fused(
        "fused_ln_lstm_fwd", lambda **k: CF.ln_lstm_fwd(**fargs, **k),
        lambda **k: CF.ln_lstm_fwd_reference(**fargs, **k), seed_kw,
        masks_kw, rows)
    bargs = dict(common, h0=inp["h0"], hs=hs, cs=cs, dhs=dhs,
                 dcT=inp["dcT"], dhT=inp["dhT"])
    grads = hold_fused(
        "fused_ln_lstm_bwd", lambda **k: CF.ln_lstm_bwd(**bargs, **k),
        lambda **k: CF.ln_lstm_bwd_reference(**bargs, **k), seed_kw,
        masks_kw, rows)
    g4 = 4 * h
    fwd_flops = 2 * t * b * (d + h) * g4
    params_in = (dp["wx"][:d], dp["wh"], *ln.values(), inp["x_bias"])
    time_fused("fused_ln_lstm_fwd", CF.ln_lstm_fwd,
               CF.ln_lstm_fwd_reference, {**fargs, **seed_kw}, 10,
               fwd_flops, nbytes(xs, *params_in, inp["c0"], inp["h0"],
                                 inp["seed_dec"], hs, cs, ct, ht), rows)
    time_fused("fused_ln_lstm_bwd", CF.ln_lstm_bwd,
               CF.ln_lstm_bwd_reference, {**bargs, **seed_kw}, 5,
               3 * fwd_flops,
               nbytes(xs, *params_in, inp["h0"], hs, cs, dhs, inp["dcT"],
                      inp["dhT"], inp["seed_dec"], *grads), rows)


def train_main_path(card):
    """The training main path: ``train/loop.train`` on the flagship model
    at full width, a WARM_STEPS-step warm-up run, then a TRAIN_STEPS-step
    run from the same weights, timed, with the kernels' launch counters
    zeroed just before and read just after."""
    import math

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.train.loop import train

    hps, model, params, loader = train_setup()
    train(hps, loader, seed=0, num_steps=WARM_STEPS, params=params,
          device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CF.reset_launch_counts()
    t0 = time.perf_counter()
    state, rows = train(hps, loader, seed=0, num_steps=TRAIN_STEPS,
                        params=params, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CF.launch_counts()
    n = TRAIN_STEPS
    want = {"fused_lstm_seq_fwd": 2 * n, "fused_lstm_seq_bwd": 2 * n,
            "fused_ln_lstm_fwd": n, "fused_ln_lstm_bwd": n}
    if launches != want:
        raise AssertionError(f"training kernel launches {launches}, "
                             f"expected {want}")
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("loss", "grad_norm", "kl")):
            raise AssertionError(f"step {r['step']}: non-finite metrics {r}")
    log("train", card=card, preset="quickdraw345_dp (float32)",
        batch=hps.batch_size, max_seq_len=hps.max_seq_len,
        steps=n, warmup_steps=WARM_STEPS, launches=launches,
        ms_per_step=wall * 1e3 / n, steps_per_s=n / wall,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        per_step=[{k: r[k] for k in ("step", "loss", "recon", "kl",
                                     "grad_norm", "lr")} for r in rows])
    return launches, (hps, model, loader, state)


@contextlib.contextmanager
def plain_kernels():
    """Run the training kernels' plain versions on CUDA tensors (for the
    reference step only): swaps the four kernel wrappers of
    ``ops/cuda_fused.py`` for their plain versions, then restores them."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    names = ("lstm_seq_fwd", "lstm_seq_bwd", "ln_lstm_fwd", "ln_lstm_bwd")
    saved = {n: getattr(CF, n) for n in names}
    for n in names:
        setattr(CF, n, getattr(CF, n + "_reference"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(CF, n, fn)


def state_to(state, device):
    from sketch_rnn_tpu_torch.train.state import (AdamState, OptState,
                                                  TrainState)
    from sketch_rnn_tpu_torch.utils.device import tree_to

    a = state.opt_state.adam
    return TrainState(tree_to(state.params, device), OptState(
        AdamState(a.count, tree_to(a.mu, device), tree_to(a.nu, device)),
        state.opt_state.schedule_count), state.step)


def compare_steps(state, a, b):
    """Loss, grad-norm and parameter-update gaps between two steps taken
    from the same ``state``; ``a``/``b`` are ``(new_state, metrics)``."""
    from sketch_rnn_tpu_torch.train.state import tree_items

    rel = lambda k: abs(float(a[1][k]) - float(b[1][k])) / max(
        abs(float(b[1][k])), 1e-30)
    upd_err = upd_max = 0.0
    for (_, p0), (_, pa), (_, pb) in zip(tree_items(state.params),
                                         tree_items(a[0].params),
                                         tree_items(b[0].params)):
        p0 = p0.to(pb.device)
        ua, ub = pa.to(pb.device) - p0, pb - p0
        upd_err = max(upd_err, float((ua - ub).abs().max()))
        upd_max = max(upd_max, float(ub.abs().max()))
    return {"loss": float(b[1]["loss"]), "loss_rel_err": rel("loss"),
            "grad_norm_rel_err": rel("grad_norm"), "update_err": upd_err,
            "update_max": upd_max}


def hold_step(what, gaps):
    if not (gaps["loss_rel_err"] <= STEP_REL_TOL
            and gaps["grad_norm_rel_err"] <= STEP_REL_TOL
            and gaps["update_err"] <= UPDATE_TOL):
        raise AssertionError(f"{what}: {gaps} (tol rel {STEP_REL_TOL}, "
                             f"update {UPDATE_TOL})")


def train_reference(hps, model, loader, state):
    """One full-width step through the kernels against the same step
    (state, batch, key) through the plain versions on the card, from the
    main path's final state (Adam's moments carry history there, so an
    update is not the sign of a first gradient). Then one small step on
    the card against the same step on the CPU."""
    import torch

    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.train.state import make_train_state
    from sketch_rnn_tpu_torch.train.step import make_train_step
    from sketch_rnn_tpu_torch.utils import prng

    step = make_train_step(model, hps, device=DEV)
    batch, key = loader.next_batch(), prng.fold_in(prng.key(11), state.step)
    kern = step(state, batch, key)
    with plain_kernels():
        plain = step(state, batch, key)
    full = compare_steps(state, kern, plain)
    hold_step("full-width step, kernels vs plain versions", full)

    small = train_hps(batch_size=8, max_seq_len=24, enc_rnn_size=16,
                      dec_rnn_size=32, z_size=8, num_mixture=3,
                      num_classes=5, class_embed_size=4)
    sm = SketchRNN(small)
    params = sm.init_params(torch.Generator().manual_seed(4), device="cpu")
    sl, _ = synthetic_loader(small, num=64, seed=4)
    cpu_step = make_train_step(sm, small, device="cpu")
    st, _ = cpu_step(make_train_state(params), sl.next_batch(), prng.key(4))
    batch, key = sl.next_batch(), prng.fold_in(prng.key(4), 1)
    on_cpu = cpu_step(st, batch, key)
    on_card = make_train_step(sm, small, device=DEV)(state_to(st, DEV),
                                                     batch, key)
    vs_cpu = compare_steps(st, on_card, on_cpu)
    hold_step("small step, card vs CPU", vs_cpu)
    log("train_reference", step=state.step, kernels_vs_plain=full,
        small_card_vs_cpu=vs_cpu, rel_tol=STEP_REL_TOL,
        update_tol=UPDATE_TOL)


def profile_train(hps, loader, state):
    """Two train steps from the main path's final weights timed, then
    two more profiled: device time by kernel, kernels per step, and the
    device's busy share of the unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sketch_rnn_tpu_torch.train.loop import train

    def two():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train(hps, loader, seed=0, num_steps=2, params=state.params,
              device=DEV)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = two()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = two()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    log("train_profile", steps=2, wall_ms=wall * 1e3,
        profiled_wall_ms=wall_prof * 1e3, device_ms=total / 1e3,
        device_busy_share=total / 1e6 / wall,
        device_kernels_per_step=sum(e.count for e in kernels) / 2,
        top=[{"name": e.key[:60], "device_ms": e.self_device_time_total
              / 1e3, "count": e.count} for e in top])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    log("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    from sketch_rnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log("build", seconds=time.perf_counter() - t0,
        flags=" ".join(_build.NVCC_FLAGS))

    dec = {cell: check_decode(cell) for cell in ("layer_norm", "lstm")}
    rep = {cell: check_replay(cell) for cell in ("layer_norm", "lstm")}
    fused = {}
    inp = fused_inputs()
    check_lstm_seq(inp, fused)
    check_ln_lstm(inp, fused)
    del inp
    launches = serve_main_path(card)
    serve_small_vs_cpu()
    profile_generate()
    train_launches, (hps, model, loader, state) = train_main_path(card)
    train_reference(hps, model, loader, state)
    profile_train(hps, loader, state)

    def row(name, line, res):
        main_ = res["layer_norm"]
        return {"name": name, "route": "cuda",
                "source": "sketch_rnn_tpu_torch/csrc/decode.cu",
                "replaces": f"sketch_rnn_tpu/ops/pallas_decode.py:{line}",
                "launches": launches[name],
                "max_abs_err": max(r["err"] for r in res.values()),
                "ms": main_["ms"], "plain_ms": main_["plain_ms"],
                "bound_ms": main_["bound_ms"],
                "bound_by": main_["bound_by"], "library_ms": None}

    def fused_row(name):
        r = fused[name]
        return {"name": name, "route": "cuda", "source": FUSED_SRC,
                "replaces": FUSED_REPLACES[name],
                "launches": train_launches[name], "max_abs_err": r["err"],
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}

    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [row("decode_chunk", 182, dec),
                                  row("replay_chunk", 339, rep)]
                      + [fused_row(n) for n in FUSED_REPLACES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
