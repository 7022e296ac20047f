#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100:
the kernels are built for sm_90a) and the CUDA toolkit. Every phase
prints one JSON line; any failure raises and the script exits non-zero
without the final line. With no CUDA device it exits 2 at once.

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — builds the kernels of ``sketch_rnn_tpu_torch/csrc`` with
   nvcc (ops/_build.py) and reports the build time.
3. kernel  — each kernel against its plain PyTorch version on the same
   CUDA tensors, at the serving shapes of the full-width model (B=64
   slots, K=8 steps, H=512, M=20, Nz=128; replay at E=64): errors,
   exact agreement of t/done/pen away from CDF near-ties, and times
   (CUDA events) beside the card's bound for the same work.
4. serve   — the main path: ``ServeEngine`` at the full ``layer_norm``
   preset (conditional VAE, bi-LSTM encoder 256, LayerNorm-LSTM decoder
   512, serve_slots=64, serve_chunk=8, max_seq_len=250) on seeded random
   weights serves 128 ``generate`` requests, then ``serve_requests``
   serves 32 ``complete`` and 32 ``reconstruct`` requests on synthetic
   prefixes. The kernels' launch counters are zeroed just before and
   read just after, and must show both kernels launched. A small burst
   served on the card is then held against the same burst served by the
   plain versions on the CPU.
5. profile — a 64-request burst timed, then profiled: device time by
   kernel and the device's busy share of the burst.
6. the kernels line, the ``nvidia-smi`` line, and the result line.

Random weights carry the pen-suppression sentinel ``out_b[2] = -1e9``
(an untrained model ends a sketch after a few steps) and requests carry
seeded caps in [16, 250], so sketches run to QuickDraw-like lengths.
"""

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
    launches = serve_main_path(card)
    serve_small_vs_cpu()
    profile_generate()

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

    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [row("decode_chunk", 182, dec),
                                  row("replay_chunk", 339, rep)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
