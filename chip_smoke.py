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
   CUDA tensors, at float32 and at bfloat16 (``dtype`` in each line),
   with times (CUDA events) beside the card's bound for the same work:
   - the serving kernels at the serving shapes of the full-width model
     (B=64 slots, K=8 steps, H=512, M=20, Nz=128; replay at E=64), at
     compute_dtype float32 and bfloat16, both cells: errors, exact
     agreement of t/done/pen away from CDF near-ties; for replay of the
     lstm cell beside cuDNN's LSTM over ``[x; z]`` packed at seq_len
     (``pack_padded_sequence``), its carry held to the plain replay;
   - decode_chunk_ab / replay_chunk_ab: ``srt_decode_chunk`` and
     ``srt_replay_chunk`` (the persistent cooperative loop, four / three
     grid barriers a step for the layer_norm cell, two / one for lstm)
     against the row-block design they replaced
     (``srt_*_chunk_rowblock``) on the same inputs: t, done and pens exact
     away from near-ties, offsets and carries within SERVE_TOL of the
     row-block entry's and of the plain version's, identical run to run,
     both timed in turns (new, old, old, new; medians); for the lstm cell
     whether one step's carry is bit for bit the row-block design's;
     replay also at E=250 (the terminal prefix edge); then decode_profile:
     cycles per phase of a decode step from an instrumented build
     (``sketch_rnn_tpu_torch/scripts/profile_decode.py``), both cells and
     dtypes;
   - the training kernels at the training shapes (B=100, T=250, dropout
     seeded at keep 0.9): ``fused_lstm_seq`` (encoder H=256) and
     ``fused_ln_lstm`` (decoder H=512 with its x_bias) of the flagship
     model, ``fused_lstm`` (the ``vae`` preset's lstm decoder, H=512 with
     x_bias [100, 2048] and a nonzero initial carry), ``fused_hyper_lstm``
     (the ``hyper`` preset's decoder, H=512, HH=256, e=32, both
     per-example biases, four nonzero carries; also at the narrow shapes
     H=16/HH=32 and H=40/HH=8), each forward and backward, at float32 and
     at bfloat16 weights and residuals: every output and gradient within
     FUSED_TOL of its dtype, the in-kernel dropout masks bitwise the plain
     ``prng_mask`` ones, every result identical run to run; for the
     HyperLSTM backward also its scratch and peak bytes;
   - lstm_fwd_ab: ``srt_lstm_fwd`` (the cooperative loop, one grid
     barrier per step) against the row-block design it replaced,
     ``srt_lstm_fwd_rowblock``, at the shapes of ``fused_lstm_seq`` and
     ``fused_lstm`` above and both dtypes: every output bitwise equal,
     both timed in turns with CUDA events (new, old, old, new; medians);
   - lstm_bwd_ab: ``srt_lstm_bwd`` (the hoisted recompute, the
     cooperative loop, the weight pass) against the row-block design it
     replaced, ``srt_lstm_bwd_rowblock``, at the shapes of
     ``fused_lstm_seq`` and ``fused_lstm`` above and both dtypes: outputs
     within FUSED_TOL of each other, the new entry identical run to run,
     both timed in turns with CUDA events, and the split of the new entry
     into its three launches;
   - ln_lstm_fwd_ab: ``srt_ln_lstm_fwd`` (the cooperative loop, the layer
     norms' row moments exchanged between its blocks, three grid barriers
     a step) against the row-block design it replaced,
     ``srt_ln_lstm_fwd_rowblock``, at the decoder's shape of
     ``fused_ln_lstm`` above (x_bias, seeded dropout) at both dtypes and
     at the ladder's B=4096 (the decoder's rows tiled) at bfloat16: every
     output within FUSED_TOL of the row-block entry's and of the plain
     version's, the new entry identical run to run, both timed in turns
     with CUDA events (new, old, old, new; medians);
   - ln_lstm_bwd_ab: ``srt_ln_lstm_bwd`` (the hoisted recompute and
     layer-norm statistics, the cooperative loop with three grid barriers
     a step, the weight pass) against the row-block design it replaced,
     ``srt_ln_lstm_bwd_rowblock``, at the decoder's shape of
     ``fused_ln_lstm`` above (x_bias, seeded dropout) and both dtypes: the
     same checks and timings, the split into its four launches;
   - hyper_lstm_bwd_ab: ``srt_hyper_bwd`` (the hoisted recompute and
     statistics, the cooperative loop with five grid barriers a step,
     dxs, the eleven products on the split-K weight pass, the row sums)
     against the row-block design it replaced, ``srt_hyper_bwd_rowblock``,
     at the ``hyper`` preset's shape of ``fused_hyper_lstm`` above and
     both dtypes: the same checks and timings, the split into its six
     stages; the backward's kernel line also carries its loop's plan;
   - hyper_lstm_fwd_ab: ``srt_hyper_fwd`` (the cooperative loop over
     resident weight columns, five grid barriers a step) against the
     row-block design it replaced, ``srt_hyper_fwd_rowblock``, at the
     ``hyper`` preset's shape of ``fused_hyper_lstm`` above and both
     dtypes: every output within FUSED_TOL of the row-block entry's and of
     the plain version's, the new entry identical run to run, both timed
     in turns with CUDA events (new, old, old, new; medians); the
     forward's kernel line also carries its loop's plan;
   - kernel_library: cuDNN's LSTM (``torch.nn.LSTM``, TF32 off) timed
     beside ``fused_lstm_seq`` and ``fused_lstm`` (over the unfolded
     inputs [x; z], D=133) as a yardstick only;
   - batch_windows: each persistent entry (``srt_lstm_fwd``,
     ``srt_lstm_bwd``, ``srt_ln_lstm_fwd``, ``srt_ln_lstm_bwd``) at
     H=512, B=8192, float32, and ``srt_lstm_bwd`` at bench.py's encoder
     shape (H=256, B=4096, bfloat16), T=8: batches whose tiles do not fit
     in shared memory at once, run as launches over windows of rows,
     against the row-block entry (bitwise for ``srt_lstm_fwd``, FUSED_TOL
     for the others), identical run to run, both timed in turns; then
     ``srt_hyper_fwd`` and ``srt_hyper_bwd`` at H=512, HH=256, e=32,
     B=8192, T=8, float32 (their loops over windows of rows), as in
     hyper_lstm_fwd_ab and hyper_lstm_bwd_ab.
4. serve   — the serving main path: ``ServeEngine`` at the full
   ``layer_norm`` preset (conditional VAE, bi-LSTM encoder 256,
   LayerNorm-LSTM decoder 512, serve_slots=64, serve_chunk=8,
   max_seq_len=250) at the flagship's compute_dtype bfloat16, on seeded
   random weights, serves 128 ``generate`` requests, then
   ``serve_requests`` serves 32 ``complete`` and 32 ``reconstruct``
   requests on synthetic prefixes. The serving kernels' launch counters
   are zeroed just before and read just after, and must show both
   kernels launched. The same burst is then served at float32. A small
   burst served on the card is held against the same burst served by the
   plain versions on the CPU, at both dtypes.
5. profile — a 64-request bfloat16 burst timed, then profiled: device
   time by kernel and the device's busy share of the burst.
6. train   — the training main path: ``train/loop.train`` on the
   flagship ``quickdraw345_dp`` model at its own bfloat16 compute and
   residuals (seeded random weights, the synthetic 345-class corpus), 2
   warm-up steps, then 10 steps timed with the training kernels' launch
   counters zeroed just before and read just after: exactly 2 launches
   per step of each ``fused_lstm_seq`` kernel and 1 of each
   ``fused_ln_lstm`` kernel, finite losses.
7. train_reference — one full-width step through the kernels against the
   same step through the plain versions on the card, and one small step
   on the card against the same step on the CPU.
8. train_profile — two train steps timed, then profiled.
9. train_workdir — the two ends of the main path at the flagship's full
   width (bfloat16, B=100, T=250): ``write_synthetic_npz`` writes one
   ``.npz`` file for each of the 345 classes (30 train, 4 valid, 4 test
   sketches each, integer deltas) and ``load_dataset`` reads them; run A
   trains 4 steps with a workdir, evaluating the valid split and saving
   in the background every 2 steps, logging every step, then sweeps the
   test split, with the training kernels' counters zeroed just before and
   read just after (2 + 2 ``fused_lstm_seq`` and 1 + 1 ``fused_ln_lstm``
   launches a step, 2 + 1 forwards an eval batch); run B trains to its
   step-2 save, then to step 4 with fresh loaders, and must end on run A's
   state bit for bit; ``restore_checkpoint`` of A's last save must equal
   A's state, and 8 ``generate``, 4 ``complete`` and 4 ``reconstruct``
   requests served from it must give the strokes served from A's live
   parameters, with the serving kernels launched. Logged: the corpus's
   write and read seconds, ms a step without and with a workdir (eval and
   saves every 2 steps, a log row every step in both) in turns, a
   synchronous save's ms and bytes, the eval sweep's batches, ms,
   launches and extra peak memory. Then train_spc: ``steps_per_call`` 5
   against 1 in turns (one CUDA graph replay a K=5 call), the replay bit
   for bit five eager steps, ``train()`` at K=5 to step 7 with exact
   launches, the eval sweep at ``eval_steps_per_call`` 8 against 1. Then
   train_feed: ``data/prefetch.py`` on bench.py's corpus and on the
   ``.npz`` train split, at K=5 and K=1, float32 at depth 0, float32 at
   depth 2 and int16 at depth 2 in turns: ms a step, the producer's host
   ms a batch by part, the consumer's wait and host ms a call, the busy
   share over two calls, the full queue's reserved memory; the synthetic
   turns bit for bit one another, an int16 step bit for bit the float32
   step and a bfloat16-transfer step within STEP_TOL of it; ``train()``
   at depth 2 and int16, K=5, to step 7 with exact launches, bit for bit
   ``train()`` at float32 and depth 0. Then cli_flow: the port's command
   line in this process (``cli.main``) on the flagship preset at full
   width, seeded weights and the synthetic corpus: ``train --preset
   quickdraw345_dp --synthetic`` to step 4 (an eval sweep and a save
   every 2 steps), ``eval --split test``, ``sample -n 16``, ``sample
   --temperatures 0.2,0.5,1.0 -n 8``, ``sample --interpolate -n 8
   --strokes_out`` and ``sample --reconstruct -n 4 --strokes_out``:
   every exit code 0, every SVG parsed and holding its grid, rows
   4f/4b/5f/5b launched in ``train`` and rows 1 and 2 in each endpoint
   demo (none in the plain ``sample``), the ``--strokes_out`` arrays bit
   for bit a direct ``serve_requests`` call on the restored checkpoint;
   the plain sampler on the card against the CPU (float32, 8 rows of 8
   steps); the sampler's ms per call at n=16 and n=64 (as trained and
   at full length), its steps and host syncs (also as torch's sync
   debug mode counts them) beside the engine's ``generate``; the
   interpolate request's latency and the phase's seconds.
10. train_lstm — the ``vae`` preset (lstm decoder) with ``fused_rnn=true``
   at full width and float32: 1 warm-up step, then 5 timed steps with the
   counters zeroed just before and read just after (2 launches per step
   of each ``fused_lstm_seq`` kernel, 1 of each ``fused_lstm`` kernel),
   then its one-step references as in 7.
11. train_hyper — the ``hyper`` preset (HyperLSTM decoder 512 with its
   auxiliary LSTM 256 and embeddings 32) with ``fused_rnn=true`` at full
   width and float32: 1 warm-up step, then 5 timed steps with the
   counters zeroed just before and read just after (2 launches per step
   of each ``fused_lstm_seq`` kernel, 1 of each ``fused_hyper_lstm``
   kernel), losses finite and falling, then its one-step references as
   in 7 and its profile as in 8.
12. serve_hyper — the ``hyper`` preset served at full width through the
   engine's plain chunk program (the JAX package has no decode kernel for
   this cell either): the same burst as in 4, ``decode_kernel`` reported
   as ``plain``, no ``decode_chunk``/``replay_chunk`` launch; a small
   burst against the CPU; a profiled 64-request burst.
13. lstm_seq — the cuDNN-layout LSTM with its reserve space
   (``ops/cuda_lstm.py``, ``csrc/lstm_seq.cu``) at the ``vae`` decoder's
   full width (B=100, T=250, H=512; ``xp`` projected from ``[x; z]``,
   D=133; nonzero carries; masks from ``make_dropout_masks`` at keep
   0.9): forward and backward against their plain versions (1e-4
   relative), identical run to run, timed beside the bound and cuDNN's
   LSTM; lstm_seq_ab, the loops of ``csrc/lstm_loops.cuh`` that both
   entries run against the row-block design they replaced
   (``srt_lstm_seq_*_rowblock``) on the same inputs: the forward bit for
   bit, the backward within FUSED_TOL and identical run to run, both timed
   in turns (new, old, old, new; medians), the backward's split (loop,
   weight pass); again at B=4096, T=100 (the backward's loop over windows
   of rows). Then its main path, ``hoisted_lstm``: the decoder's loss and
   gradients through the public ``lstm_seq`` with its counters zeroed
   just before and read just after (one launch each way), against the
   same loss through the plain ``run_rnn(hoist=True)``.
   Then weight_grad_ab: the weight pass every backward entry ends with
   (``csrc/weight_grad.cuh``, split-K: the tensor cores at bfloat16, a
   register-tiled SIMT product at float32) against the pass it replaced
   (``srt_weight_grad`` variants 0 and 1) over one seeded ``d_pre``
   scratch, at the decoder's shape (H=512, D=5, no row of ones: 5b;
   with it: 3b) and the encoder's (H=256, D=5, ones: 4b) at B=100,
   T=250 and both dtypes, ``lstm_seq``'s dwh (H=512, D=0) at float32,
   and the decoder and the encoder at B=4096, bfloat16: both within
   FUSED_TOL of the plain version (and of each other), the new pass
   identical run to run, both timed in turns (new, old, old, new;
   medians), beside ``torch.mm`` of the same rounded operands (TF32
   off) and the bound.
14. train_plain — the ``vae`` preset exactly as it says, ``fused_rnn=
   false`` (the plain cell loop under autograd, recurrent dropout from
   ``(key, t)``), float32, full width: 1 warm-up step, then 2 timed
   steps with every training kernel's counter zeroed just before and
   read just after, all 0; one step without dropout against the same
   step through the kernels; one small ``layer_norm`` step on the card
   against the CPU; two steps profiled (device time by kernel, busy
   share).
15. probes — ``dual_seq_fwd`` and ``seq_fwd`` (``csrc/probe_seq.cu``,
   ``sketch_rnn_tpu_torch/scripts/probe_*.py``) against their plain
   versions at the probes' shape, B=4096, T=250, H=256 (1e-2 relative;
   the dual forward bit for bit two launches of the float32-gates arm,
   both within 1e-2 of the ``fused_lstm_seq`` forward), timed beside
   cuDNN's bfloat16 LSTM forward (bidirectional for the dual);
   probe_seq_ab, the persistent tensor-core loop of each against the
   row-block design it replaced (3 turns of new, old, old, new); then
   each probe's A/B (its ``run_probe``) with 4 calls per timing and 3
   reps, counters zeroed just before and read just after, its record on
   one line, and the dual probe's production arm (the ``fused_lstm_seq``
   forward at B=4096, bench.py's encoder) on its own ``encoder_fwd``
   line.
16. probe_ladder — the LayerNorm ladder (``csrc/probe_ln.cu``, every arm on
   the production loops of ``csrc/ln_lstm.cuh``,
   ``sketch_rnn_tpu_torch/scripts/probe_dec_bwd_split.py`` and
   ``probe_ln_stats.py``) at the reference probes' shape, B=4096, T=250,
   H=512, D=5, bfloat16: the four forward arms, the six backward arms and
   the fake-stats backward against their plain versions (1e-2 relative;
   the forward arms also step by step at float32 residuals, 1e-4; the two
   arms whose dh chain overflows by T=250 at T=32, float32, 1e-4), each
   identical on two runs, the ``prod`` arms bit for bit the production
   kernels they are (``srt_ln_lstm_fwd``, ``srt_ln_lstm_bwd``) and timed
   beside them; each arm against its row-block design
   (``srt_ln_probe_*_rowblock``, whose ``prod`` arms are bit for bit
   ``srt_ln_lstm_*_rowblock``) in turns of new, old, old, new, one
   ``ln_probe_ab`` line each (3 turns forward, 2 backward); then both
   ladders (with ``grid_scaling_ms``: ``prod`` at 1, 2 and 4 forced
   windows of rows) and the LN-stats A/B through their run functions
   with 1 call per timing and 2 reps, the ladder's counters zeroed just
   before each and read just after, each record on one line, and the
   phase's seconds.
17. the kernels line (seventeen kernels; the ladder's three rows carry
   every arm's numbers under ``arms``, and ``rowblock_ms``, ``speedup``
   and each arm's A/B under ``ab``), the ``nvidia-smi`` line, and the
   result line.

Random serving weights carry the pen-suppression sentinel ``out_b[2] =
-1e9`` (an untrained model ends a sketch after a few steps) and requests
carry seeded caps in [16, 250], so sketches run to QuickDraw-like
lengths.
"""

import contextlib
import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# dense bfloat16 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
DTYPES = ("float32", "bfloat16")
DEV = "cuda"

B, K, E = 64, 8, 64
E_LONG = 250       # the terminal prefix edge: a long prefix's replay
# serving kernels vs their plain versions on the card. float32: both sum
# 512-term dot products, in different orders, so they round differently
# (~1e-7 relative per step), and the gaps compound through the recurrence
# and the sampler's exp(log_sigma) * normal scaling. Measured on an H100
# (PERF.md): decode (8 steps) <= 1.5e-6 on carries and offsets, replay (64
# steps) <= 7.7e-6 on carries; 1e-4 keeps a 13x margin, a wrong gate order
# or layer-norm association errs by ~1e-1. bfloat16: where the two float
# sums straddle a rounding boundary a product operand moves by one
# bfloat16 ulp (up to 2**-7 relative) and the step by ~1e-4; measured on
# an H100: decode <= 1.2e-3, replay <= 2.5e-3. 1e-2 holds that and still
# catches a wrong association.
SERVE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# a draw whose uniform is this close to a CDF edge may flip under
# rounding; such rows are counted, not held
NEAR_TIE = {"float32": 1e-5, "bfloat16": 1e-3}
# cuDNN's packed LSTM (a yardstick) vs the plain replay's carry: float32
# sums in another order; at bfloat16 cuDNN also rounds its activations and
# its carry to bfloat16, which the port's contract keeps in float
LIBRARY_TOL = {"float32": 1e-4, "bfloat16": 1e-1}


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


def bound_ms(flops, moved_bytes, dt, f32_flops=0):
    """The least time for the work: the products at the peak of their
    operand dtype (``f32_flops``: products whose operands stay float32
    whatever ``dt``), the bytes at HBM bandwidth; the larger of the two."""
    t_ops = (flops / PEAK_FLOPS[dt]
             + f32_flops / PEAK_FLOPS["float32"]) * 1e3
    t_bytes = moved_bytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def torch_dtype(dt):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]


def dtype_over(dt):
    """The hparams of a compute and residual dtype."""
    return dict(compute_dtype=dt, fused_residual_dtype=dt)


def full_width(cell, seed=0, dt="float32"):
    import torch

    from sketch_rnn_tpu_torch import HParams
    from sketch_rnn_tpu_torch.models.vae import SketchRNN

    hps = HParams(conditional=True, dec_model=cell, serve_slots=B,
                  serve_chunk=K, compute_dtype=dt)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device=DEV)
    return hps, model, params


def serving_weights(model, params):
    """The decoder's weight matrices in the kernels' weight dtype."""
    from sketch_rnn_tpu_torch.ops import cuda_decode as cd

    cdt = model.dec.compute_dtype
    return (cd.cast_weights(params["dec"], cdt),
            params["out_w"].to(cd.weight_dtype(cdt)))


def decode_inputs(cell, dt):
    """decode_chunk's arguments at the serving shapes: ``(hps, args, kw,
    t0)``."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params = full_width(cell, dt=dt)
    # a p3 logit bias of -3 keeps most rows drawing through the chunk
    # while some still end on their own; every 4th row hits its cap
    # mid-chunk and every 16th starts done
    params["out_b"][2] = -3.0
    dec, out_w = serving_weights(model, params)
    dev = torch.device(DEV)
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
    args = (dec, out_w, params["out_b"], c0, h0, prev0, z, u, temps, t0,
            done0, caps, end)
    kw = dict(cell_kind=cell, num_mixture=hps.num_mixture,
              compute_dtype=model.dec.compute_dtype)
    return hps, args, kw, t0


def hold_decode(what, got, want, near, dt):
    """t, done and pen states exact away from CDF near-ties (``near``),
    offsets and carries within SERVE_TOL; returns ``(offset err, carry
    err)``."""
    import torch

    keep = ~near
    tol = SERVE_TOL[dt]
    s_k, s_p = got[0].cpu()[:, keep], want[0].cpu()[:, keep]
    for name, a, b in (("t", got[3], want[3]), ("done", got[4], want[4])):
        a, b = a.cpu()[keep], b.cpu()[keep]
        if name == "done":      # the entries' int32, the wrapper's bool
            a, b = a != 0, b != 0
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")
    if not torch.equal(s_k[..., 2:], s_p[..., 2:]):
        raise AssertionError(f"{what}: pen states differ")
    off_err = float((s_k[..., :2] - s_p[..., :2]).abs().max())
    carry_err = max(float((a.cpu()[keep] - b.cpu()[keep]).abs().max())
                    for a, b in ((got[1], want[1]), (got[2], want[2])))
    if not (off_err <= tol and carry_err <= tol):
        raise AssertionError(f"{what}: offsets err {off_err}, carry err "
                             f"{carry_err} (tol {tol})")
    return off_err, carry_err


def check_decode(cell, dt, inp):
    """decode_chunk vs its plain version at the serving shapes."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd

    hps, args, kw, t0 = inp
    dec, out_w = args[0], args[1]
    got = cd.decode_chunk(*args, **kw)
    torch.cuda.synchronize()
    *want, margin = cd.decode_chunk_reference(*args, **kw,
                                              return_margin=True)
    near = (margin < NEAR_TIE[dt]).cpu()
    off_err, carry_err = hold_decode(f"decode_chunk[{cell}, {dt}]", got,
                                     want, near, dt)
    ms = cuda_ms(lambda: cd.decode_chunk(*args, **kw), 50)
    plain_ms = cuda_ms(lambda: cd.decode_chunk_reference(*args, **kw), 5)
    # the work this run's data needs: the live row-steps' products
    h, p = hps.dec_rnn_size, 6 * hps.num_mixture + 3
    live = int((got[3] - t0).sum())
    flops = 2 * live * (5 * 4 * h + h * 4 * h + h * p)
    ws = out_w.element_size()
    moved = (nbytes(*(dec[k] for k in dec if k != "wx"), out_w,
                    *args[2:6], *args[7:], *got)
             + 5 * 4 * h * ws + B * 4 * h * 4)  # wx[:5], extra @ wx[5:]
    bms, by = bound_ms(flops, moved, dt)
    log("kernel", name="decode_chunk", cell=cell, dtype=dt, B=B, K=K, H=h,
        M=hps.num_mixture, near_tie_rows=int(near.sum()),
        offset_err=off_err, carry_err=carry_err, tol=SERVE_TOL[dt], ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, live_row_steps=live,
        flops=flops, bytes=moved)
    return {"err": max(off_err, carry_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def decode_chunk_ab(cell, dt, inp):
    """``srt_decode_chunk`` (the persistent cooperative loop) against the
    row-block design it replaced, ``srt_decode_chunk_rowblock``, on one set
    of inputs (``cuda_decode.decode_chunk_entries``, uncounted): t, done and
    pens exact away from near-ties, offsets and carries within SERVE_TOL,
    the new entry identical run to run; for the lstm cell also whether one
    step's carry is bit for bit the row-block design's; then both timed in
    turns (new, old, old, new; AB_REPS turns, medians)."""
    import statistics

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd

    hps, args, kw, _ = inp
    run, outs = cd.decode_chunk_entries(*args, **kw)
    snap = lambda: [o.clone() for o in outs]
    run("srt_decode_chunk")
    new = snap()
    run("srt_decode_chunk")
    again = snap()
    run("srt_decode_chunk_rowblock")
    old = snap()
    torch.cuda.synchronize()
    *_, margin = cd.decode_chunk_reference(*args, **kw, return_margin=True)
    near = (margin < NEAR_TIE[dt]).cpu()
    det = all(torch.equal(a, b) for a, b in zip(new, again))
    if not det:
        raise AssertionError(f"decode_chunk [{cell}, {dt}]: the loop is not "
                             f"identical run to run")
    off_err, carry_err = hold_decode(
        f"decode_chunk [{cell}, {dt}] vs the row-block design", new, old,
        near, dt)
    del new, again, old
    res = {"cell": cell}
    if cell == "lstm":   # one step: the carry's expressions are the same
        one = list(args)
        one[7] = args[7][:1].contiguous()
        run1, outs1 = cd.decode_chunk_entries(*one, **kw)
        run1("srt_decode_chunk")
        c_new, h_new = outs1[1].clone(), outs1[2].clone()
        run1("srt_decode_chunk_rowblock")
        torch.cuda.synchronize()
        res["step_bitwise_rowblock"] = bool(
            torch.equal(c_new, outs1[1]) and torch.equal(h_new, outs1[2]))
        del run1, outs1
    times, _ = ab_turns({"new": lambda: run("srt_decode_chunk"),
                         "old": lambda: run("srt_decode_chunk_rowblock")})
    res.update({"ms": statistics.median(times["new"]),
                "rowblock_ms": statistics.median(times["old"]),
                "new_ms_all": times["new"], "rowblock_ms_all": times["old"],
                "offset_err_vs_rowblock": off_err,
                "carry_err_vs_rowblock": carry_err,
                "near_tie_rows": int(near.sum()), "deterministic": det,
                "plan": cd.decode_plan(B, hps.dec_rnn_size, hps.num_mixture,
                                       cd.weight_dtype(kw["compute_dtype"]))
                ._asdict()})
    res["speedup"] = res["rowblock_ms"] / res["ms"]
    log("decode_chunk_ab", name="decode_chunk", dtype=dt, B=B, K=K,
        reps=AB_REPS, **res)
    return res


def replay_inputs(cell, dt, e=E):
    """replay_chunk's arguments at B=64 and ``e`` steps: ``(hps, params,
    args, kw)``; seq_len from 1 to ``e``."""
    import torch

    hps, model, params = full_width(cell, dt=dt)
    dec, _ = serving_weights(model, params)
    dev = torch.device(DEV)
    g = torch.Generator().manual_seed(2)
    z = torch.randn((B, hps.z_size), generator=g).to(dev)
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, B))
    xs = torch.zeros((e, B, 5))
    xs[..., :2] = torch.randn((e, B, 2), generator=g)
    pen = torch.randint(0, 2, (e, B), generator=g)
    xs[..., 2] = (pen == 0).float()
    xs[..., 3] = (pen == 1).float()
    xs = xs.to(dev)
    seq_len = torch.randint(1, e + 1, (B,), generator=g,
                            dtype=torch.int32).to(dev)
    args = (dec, c0, h0, xs, z, seq_len)
    kw = dict(cell_kind=cell, compute_dtype=model.dec.compute_dtype)
    return hps, params, args, kw


def replay_library(params, args, dt):
    """cuDNN's LSTM (``torch.nn.LSTM``, TF32 off) over ``[x; z]`` (D=133)
    packed at ``seq_len`` with ``pack_padded_sequence``: its final carry is
    each row's at its own length, what ``replay_chunk`` returns. Returns
    ``(ms, err)``: the LSTM call's time (the packing made once, outside)
    and its carry's largest gap to the plain replay at float32 weights. A
    yardstick only: the port never calls it."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd

    dec, c0, h0, xs, z, seq_len = args
    cd_ = torch_dtype(dt)
    p = params["dec"]
    lstm = cudnn_lstm(p["wx"], p["wh"], p["b"], 1.0, cd_)
    e = xs.shape[0]
    inp = torch.cat([xs, z[None].expand(e, *z.shape)], -1).to(cd_)
    packed = pack_padded_sequence(inp, seq_len.cpu(), enforce_sorted=False)
    hc = (h0[None].to(cd_), c0[None].to(cd_))
    with torch.no_grad():
        _, (hn, cn) = lstm(packed, hc)
        ms = cuda_ms(lambda: lstm(packed, hc), 20)
    want = cd.replay_chunk_reference(p, c0, h0, xs, z, seq_len,
                                     cell_kind="lstm")
    err = max(float((cn[0].float() - want[0]).abs().max()),
              float((hn[0].float() - want[1]).abs().max()))
    if not err <= LIBRARY_TOL[dt]:
        raise AssertionError(f"cuDNN's packed replay [{dt}]: carry err "
                             f"{err} (tol {LIBRARY_TOL[dt]})")
    return ms, err


def check_replay(cell, dt, inp):
    """replay_chunk vs its plain version at B=64, E=64 (for the lstm cell
    beside cuDNN's packed LSTM)."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd

    hps, params, args, kw = inp
    dec, c0, h0, xs, z, seq_len = args
    tol = SERVE_TOL[dt]
    got = cd.replay_chunk(*args, **kw)
    torch.cuda.synchronize()
    want = cd.replay_chunk_reference(*args, **kw)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not err <= tol:
        raise AssertionError(f"replay_chunk[{cell}, {dt}]: carry err {err} "
                             f"(tol {tol})")
    ms = cuda_ms(lambda: cd.replay_chunk(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: cd.replay_chunk_reference(*args, **kw), 3)
    lib_ms = lib_err = None
    if cell == "lstm":
        lib_ms, lib_err = replay_library(params, args, dt)
    h = hps.dec_rnn_size
    live = int(seq_len.sum())
    flops = 2 * live * (5 * 4 * h + h * 4 * h)
    ws = dec["wh"].element_size()
    moved = (nbytes(*(dec[k] for k in dec if k != "wx"), c0, h0, xs,
                    seq_len, *got) + 5 * 4 * h * ws + B * 4 * h * 4)
    bms, by = bound_ms(flops, moved, dt)
    log("kernel", name="replay_chunk", cell=cell, dtype=dt, B=B,
        E=xs.shape[0], H=h, carry_err=err, tol=tol, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_err=lib_err, live_row_steps=live, flops=flops, bytes=moved)
    return {"err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def replay_chunk_ab(cell, dt, inp):
    """``srt_replay_chunk`` (the persistent cooperative loop) against
    ``srt_replay_chunk_rowblock`` on one set of inputs (uncounted): the
    carry within SERVE_TOL of the row-block entry's and of the plain
    version's, the new entry identical run to run, both timed in turns
    (new, old, old, new; AB_REPS turns, medians)."""
    import statistics

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd

    hps, params, args, kw = inp
    e = args[3].shape[0]
    run, outs = cd.replay_chunk_entries(*args, **kw)
    snap = lambda: [o.clone() for o in outs]
    run("srt_replay_chunk")
    new = snap()
    run("srt_replay_chunk")
    again = snap()
    run("srt_replay_chunk_rowblock")
    old = snap()
    torch.cuda.synchronize()
    want = cd.replay_chunk_reference(*args, **kw)
    det = all(torch.equal(a, b) for a, b in zip(new, again))
    err = max(float((a - b).abs().max()) for a, b in zip(new, old))
    perr = max(float((a - b).abs().max()) for a, b in zip(new, want))
    if not (det and err <= SERVE_TOL[dt] and perr <= SERVE_TOL[dt]):
        raise AssertionError(f"replay_chunk [{cell}, {dt}, E={e}]: vs the "
                             f"row-block design {err}, vs the plain version "
                             f"{perr}, deterministic {det}")
    del new, again, old
    times, _ = ab_turns({"new": lambda: run("srt_replay_chunk"),
                         "old": lambda: run("srt_replay_chunk_rowblock")})
    res = {"cell": cell, "E": e, "ms": statistics.median(times["new"]),
           "rowblock_ms": statistics.median(times["old"]),
           "new_ms_all": times["new"], "rowblock_ms_all": times["old"],
           "err_vs_rowblock": err, "err_vs_plain": perr,
           "deterministic": det,
           "plan": cd.decode_plan(B, hps.dec_rnn_size, 1, cd.weight_dtype(
               kw["compute_dtype"]), "replay")._asdict()}
    res["speedup"] = res["rowblock_ms"] / res["ms"]
    log("replay_chunk_ab", name="replay_chunk", dtype=dt, B=B, reps=AB_REPS,
        **res)
    return res


def check_serving_kernels(rows):
    """Rows 1 and 2 at both dtypes and both cells: each kernel against its
    plain version, its A/B against the row-block design, replay also at
    E=250 (the terminal prefix edge a long ``complete`` prefix replays);
    the rows' numbers are the ``layer_norm`` cell's (the main path's), the
    ``lstm`` cell's beside them. A row's ``ms`` is the public wrapper's
    time called back to back, as on every other row (its checks, the
    hoisted ``extra @ wx[5:]`` and the allocations included);
    ``kernel_ms`` the C entry's alone (the A/B's median)."""
    for dt in DTYPES:
        rec = {"decode_chunk": {}, "replay_chunk": {}}
        for cell in ("layer_norm", "lstm"):
            inp = decode_inputs(cell, dt)
            res = check_decode(cell, dt, inp)
            res["ab"] = decode_chunk_ab(cell, dt, inp)
            res["kernel_ms"] = res["ab"]["ms"]
            rec["decode_chunk"][cell] = res
            inp = replay_inputs(cell, dt)
            res = check_replay(cell, dt, inp)
            res["ab"] = replay_chunk_ab(cell, dt, inp)
            res["kernel_ms"] = res["ab"]["ms"]
            rec["replay_chunk"][cell] = res
        res = replay_chunk_ab("layer_norm", dt,
                              replay_inputs("layer_norm", dt, E_LONG))
        rec["replay_chunk"]["layer_norm"]["ab_e250"] = res
        for name, by_cell in rec.items():
            ln, lstm = by_cell["layer_norm"], by_cell["lstm"]
            rows[name][dt] = dict(
                ln, err=max(r["err"] for r in by_cell.values()),
                lstm={k: lstm[k] for k in ("err", "ms", "kernel_ms",
                                           "plain_ms", "bound_ms",
                                           "library_ms", "ab")})


def decode_profile():
    """Cycles per phase of a decode step (``profile_decode.py``'s
    instrumented build of the serving loop), both cells and dtypes; the
    instrumented outputs bit for bit the production build's."""
    import torch

    from sketch_rnn_tpu_torch.scripts import profile_decode

    cases = tuple(c for c in profile_decode.CASES if c[0] == "decode")
    for rec in profile_decode.run(cases):
        if not rec["bitwise"]:
            raise AssertionError(f"decode_profile {rec['cell']} "
                                 f"{rec['dtype']}: the instrumented build "
                                 f"is not bitwise the production build")
        log("decode_profile", **rec)
    torch.cuda.empty_cache()


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


def serve_main_path(card, dt, cell="layer_norm"):
    """The serving main path at the full-width ``cell`` preset. The
    ``lstm``/``layer_norm`` decoders go through the serving kernels (one
    ``decode_chunk`` launch per chunk, one ``replay_chunk`` launch for the
    encode batch); the ``hyper`` decoder through the plain chunk program
    and the plain replay loop, with no launch of either kernel."""
    import numpy as np
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params = full_width(cell, dt=dt)
    params["out_b"][2] = -1e9          # pen-suppression sentinel
    engine = ServeEngine(model, hps, params, device=DEV)
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
    plain = cell == "hyper"
    # one encode batch: the 64 prefixes share the edge 64 and fill the
    # 64 encode rows
    want = ({"decode_chunk": 0, "replay_chunk": 0} if plain
            else {"decode_chunk": chunks, "replay_chunk": 1})
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    kernel = "plain" if plain else "cuda"
    if not m_gen["decode_kernel"] == m_enc["decode_kernel"] == kernel:
        raise AssertionError(
            f"decode_kernel {m_gen['decode_kernel']}/"
            f"{m_enc['decode_kernel']}, expected {kernel}")
    log("serve_hyper" if plain else "serve", card=card, preset=cell,
        dtype=dt, slots=B, chunk=K, launches=launches, decode_kernel=kernel,
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


def serve_small_vs_cpu(dt, cell="layer_norm"):
    """A small full-width burst served on the card and by the plain
    versions on the CPU: steps and pens equal, offsets within tolerance.
    8 requests x 8 steps: a near-tie flip has a chance of order 1e-4
    here."""
    import numpy as np

    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.utils import prng
    from sketch_rnn_tpu_torch.utils.device import tree_to

    hps, model, params = full_width(cell, seed=3, dt=dt)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(8, hps.z_size)).astype(np.float32)

    def burst(device, p):
        reqs = [Request(key=prng.fold_in(prng.key(3), i), z=z[i],
                        temperature=0.8, max_len=K) for i in range(8)]
        out = ServeEngine(model, hps, p, slots=8, device=device).run(reqs)
        return {r.uid: r for r in out["results"]}

    card = burst(DEV, params)
    cpu = burst("cpu", tree_to(params, "cpu"))
    err = 0.0
    for uid, r in cpu.items():
        a = card[uid]
        if a.steps != r.steps or not np.array_equal(
                a.strokes5[:, 2:], r.strokes5[:, 2:]):
            raise AssertionError(f"request {uid}: card and CPU differ in "
                                 f"steps or pen states ({dt})")
        err = max(err, float(np.abs(a.strokes5 - r.strokes5).max()))
    if not err <= SERVE_TOL[dt]:
        raise AssertionError(f"card vs CPU offsets err {err} ({dt})")
    log("reference", preset=cell, dtype=dt, requests=8, steps=K,
        max_abs_err=err, tol=SERVE_TOL[dt])


def profile_generate(dt, cell="layer_norm"):
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

    hps, model, params = full_width(cell, dt=dt)
    params["out_b"][2] = -1e9          # pen-suppression sentinel
    engine = ServeEngine(model, hps, params, device=DEV)
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
    log("profile", preset=cell, dtype=dt, requests=B, chunks=m["chunks"],
        wall_ms=wall * 1e3, host_ms_per_chunk=wall * 1e3 / m["chunks"],
        profiled_wall_ms=wall_prof * 1e3, device_ms=total / 1e3,
        device_busy_share=total / 1e6 / wall,
        device_kernels_per_chunk=sum(e.count for e in kernels)
        / m["chunks"],
        top=[{"name": e.key[:60], "device_ms": e.self_device_time_total
              / 1e3, "count": e.count} for e in top])


# -- the training path -----------------------------------------------------

KEEP = 0.9             # recurrent-dropout keep probability (hps default)
TRAIN_STEPS, WARM_STEPS = 10, 2
LSTM_STEPS = HYPER_STEPS = 5
FUSED_SRC = "sketch_rnn_tpu_torch/csrc/fused_rnn.cu"
HYPER_SRC = "sketch_rnn_tpu_torch/csrc/fused_hyper.cu"
FUSED_REPLACES = {     # the Pallas kernel bodies each CUDA kernel replaces
    "fused_lstm_seq_fwd": "sketch_rnn_tpu/ops/pallas_fused.py:621",
    "fused_lstm_seq_bwd": "sketch_rnn_tpu/ops/pallas_fused.py:648",
    "fused_lstm_fwd": "sketch_rnn_tpu/ops/pallas_fused.py:240",
    "fused_lstm_bwd": "sketch_rnn_tpu/ops/pallas_fused.py:279",
    "fused_ln_lstm_fwd": "sketch_rnn_tpu/ops/pallas_fused.py:826",
    "fused_ln_lstm_bwd": "sketch_rnn_tpu/ops/pallas_fused.py:900",
}
HYPER_REPLACES = {
    "fused_hyper_lstm_fwd": "sketch_rnn_tpu/ops/pallas_fused.py:1246",
    "fused_hyper_lstm_bwd": "sketch_rnn_tpu/ops/pallas_fused.py:1297",
}
LSTM_SEQ_SRC = "sketch_rnn_tpu_torch/csrc/lstm_seq.cu"
PROBE_SRC = "sketch_rnn_tpu_torch/csrc/probe_seq.cu"
# training kernels vs their plain versions on the card, as the largest
# error of each output relative to that output's largest magnitude.
# float32: both sum 256/512-term (and, for the weight gradients,
# 25,000-term) products in different orders; the gaps compound through
# 250 steps of recurrence. Measured on an H100 (PERF.md): seq fwd 2.1e-7,
# seq bwd 4.2e-6, LN fwd 1.5e-6, LN bwd 5.0e-6; 1e-4 keeps a 20x margin,
# a wrong gate, mask or LN term errs by ~1e-1. bfloat16: a stored value
# or a weight gradient whose two float sums straddle a rounding boundary
# moves by one ulp, at most 2**-7 = 7.8e-3 of its magnitude (measured on
# an H100: largest 5.2e-3, fused_lstm fwd's cs).
FUSED_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# one train step through the kernels vs the same step (state, batch,
# key) through the plain versions: loss and grad norm relative, the
# parameter update absolute (Adam's updates are ~lr = 1e-3). float32,
# measured on an H100: loss and grad norm 0 (full width) and 1.2e-7
# (small step, card vs CPU), updates 6.0e-8 and 3.0e-8; margins 85x and
# 17x. bfloat16: a rounding flip moves an activation or a gradient
# element by an ulp; in a parameter whose gradient is at that noise level
# Adam's normalisation turns it into a few percent of lr. Measured on an
# H100: loss 2.2e-5 and grad norm 3.8e-5 relative, updates 3.4e-5 (full
# width) and 2.5e-5 (small step); margins 26x and 2.9x.
STEP_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-3, 1e-4)}


def train_hps(**over):
    """The model of the flagship ``quickdraw345_dp`` preset
    (``sketch_rnn_tpu/cli.py`` PRESETS): conditional VAE, bi-LSTM encoder
    256, LayerNorm-LSTM decoder 512, Nz=128, M=20, 345 classes, fused
    RNN kernels, recurrent dropout at keep 0.9, B=100, T=250; the preset's
    bfloat16 compute and residuals come from ``over``."""
    from sketch_rnn_tpu_torch import HParams

    return HParams(**{**dict(conditional=True, dec_model="layer_norm",
                             num_classes=345, fused_rnn=True), **over})


def vae_hps(**over):
    """The ``vae`` preset (``sketch_rnn_tpu/cli.py`` PRESETS): conditional
    VAE, bi-LSTM encoder 256, lstm decoder 512, Nz=128, M=20, no classes,
    here with the fused RNN kernels, B=100, T=250."""
    from sketch_rnn_tpu_torch import HParams

    return HParams(**{**dict(conditional=True, dec_model="lstm",
                             fused_rnn=True), **over})


def hyper_hps(**over):
    """The ``hyper`` preset (``sketch_rnn_tpu/cli.py`` PRESETS): conditional
    VAE, bi-LSTM encoder 256, HyperLSTM decoder 512 with its auxiliary
    LSTM 256 and embeddings 32, Nz=128, M=20, no classes, float32, here
    with the fused RNN kernels, B=100, T=250."""
    from sketch_rnn_tpu_torch import HParams

    return HParams(**{**dict(conditional=True, dec_model="hyper",
                             fused_rnn=True), **over})


def setup(hps, seed=0):
    import torch

    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.models.vae import SketchRNN

    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device=DEV)
    loader, _ = synthetic_loader(hps, num=10 * hps.batch_size, seed=seed)
    return hps, model, params, loader


FUSED_OUTPUTS = {
    "fused_lstm_seq_fwd": ("hs", "cs"),
    "fused_lstm_seq_bwd": ("dwx", "db", "dwh"),
    "fused_lstm_fwd": ("hs", "cs", "cT", "hT"),
    "fused_lstm_bwd": ("dxs", "dx_bias", "dwx", "db", "dwh", "dc0", "dh0"),
    "fused_ln_lstm_fwd": ("hs", "cs", "cT", "hT"),
    "fused_ln_lstm_bwd": ("dxs", "dx_bias", "dwx", "dwh", "dln_gamma",
                          "dln_beta", "dlnc_gamma", "dlnc_beta", "dc0",
                          "dh0"),
    "fused_hyper_lstm_fwd": ("hs", "cs", "hycs", "hyhs", "cT", "hT", "hcT",
                             "hhT"),
    "fused_hyper_lstm_bwd": (
        "dxs", "dx_bias", "dx_bias_hyper", "dwx", "db", "dwh", "dwxh_x",
        "dwxh_h", "dbh", "dwhh", "dw_hz_x", "db_hz_x", "dw_hz_h", "db_hz_h",
        "dw_hz_b", "dzd_x", "dzd_h", "dzd_b", "dln_gamma", "dln_beta",
        "dlnc_gamma", "dlnc_beta", "dc0", "dh0", "dhc0", "dhh0"),
}


def rel_errs(names, got, want):
    """``(max abs error, max error relative to each output's largest
    magnitude, {output: max abs error})`` over the paired outputs."""
    ab = rel = 0.0
    per = {}
    for n, a, b in zip(names, got, want):
        if a.dtype != b.dtype:
            raise AssertionError(f"{n}: dtype {a.dtype} vs {b.dtype}")
        a, b = a.float(), b.float()
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


def fused_inputs(hps_fn, dt):
    """The training kernels' inputs as the main path builds them at
    compute and residual dtype ``dt``: one synthetic batch, the model's
    own weights (cast to the weight dtype), the decoder's per-example
    gate bias and initial carry from a seeded z, dropout seeds drawn as
    ``ops/rnn.py`` draws them, and seeded output cotangents (in the
    residual dtype, as autograd hands them over)."""
    import torch

    from sketch_rnn_tpu_torch.ops import linear as L
    from sketch_rnn_tpu_torch.train.step import batch_to_device
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params, loader = setup(hps_fn(**dtype_over(dt)))
    cdt = model.dec.compute_dtype
    wdt = rdt = torch_dtype(dt)
    batch = batch_to_device(loader.next_batch(), DEV)
    strokes = batch["strokes"].transpose(0, 1).float()
    g = torch.Generator().manual_seed(7)
    b = hps.batch_size
    z = torch.randn((b, hps.z_size), generator=g).to(DEV)
    extra = model._decoder_extra(params, z, batch.get("labels"))
    c0, h0 = (x.contiguous() for x in model.dec.carry_leaves(
        model.decoder_initial_carry(params, z, b))[:2])
    seeds = [prng.randint(prng.key(s), 0, 2 ** 31 - 1).to(DEV)
             for s in (1, 2)]
    t = hps.max_seq_len
    dp, ep = params["dec"], params["enc_fwd"]

    def cot(h):
        return (0.01 * torch.randn((t, b, h), generator=g)).to(DEV).to(rdt)

    return {"dt": dt, "hps": hps, "model": model, "params": params,
            "rdt": None if dt == "float32" else rdt,
            "enc": {"wx": ep["wx"].to(wdt), "b": ep["b"],
                    "wh": ep["wh"].to(wdt)},
            "dec": {"wx": dp["wx"][:5].to(wdt), "wh": dp["wh"].to(wdt)},
            "x_in": strokes[:-1].contiguous(),
            "x_tgt": strokes[1:].contiguous(), "z": z,
            "x_bias": L.matmul(extra, dp["wx"][5:], cdt), "c0": c0,
            "h0": h0, "seed_enc": seeds[0], "seed_dec": seeds[1],
            "dhs_enc": cot(hps.enc_rnn_size),
            "dhs_dec": cot(hps.dec_rnn_size),
            "dcT": (0.01 * torch.randn((b, hps.dec_rnn_size),
                                       generator=g)).to(DEV),
            "dhT": (0.01 * torch.randn((b, hps.dec_rnn_size),
                                       generator=g)).to(DEV)}


def hold_fused(name, dt, run, ref, seed_kw, masks_kw, rows):
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
    same = lambda x, y: all(a is None and b is None or torch.equal(a, b)
                            for a, b in zip(x, y))
    masks_bitwise, deterministic = same(got, streamed), same(got, again)
    if not (rel <= FUSED_TOL[dt] and masks_bitwise and deterministic):
        raise AssertionError(
            f"{name} [{dt}]: rel err {rel} (tol {FUSED_TOL[dt]}), per "
            f"output {per}, masks bitwise {masks_bitwise}, deterministic "
            f"{deterministic}")
    rows.setdefault(name, {})[dt] = {
        "err": ab, "rel_err": rel, "errs": per,
        "masks_bitwise": masks_bitwise, "deterministic": deterministic}
    return got


def time_fused(name, dt, run, ref, kw, iters, flops, moved, rows,
               f32_flops=0, **extra):
    ms = cuda_ms(lambda: run(**kw), iters)
    plain_ms = cuda_ms(lambda: ref(**kw), 2)
    bms, by = bound_ms(flops, moved, dt, f32_flops)
    r = rows[name][dt]
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
             library_ms=None, **extra)
    log("kernel", name=name, dtype=dt, tol=FUSED_TOL[dt], flops=flops,
        bytes=moved, **r)


def cudnn_lstm(wx, wh, b, forget_bias, dtype):
    """``torch.nn.LSTM`` (cuDNN) holding the same weights (``wx [D, 4H]``,
    float32 masters): gates permuted from (i, g, f, o) to (i, f, g, o),
    the forget bias folded into the input bias, in ``dtype``. A yardstick
    only: the port never calls it."""
    import torch

    d, g4 = wx.shape
    lstm = torch.nn.LSTM(d, g4 // 4).to(DEV)

    def perm(w):
        i, g, f, o = w.chunk(4, 0)
        return torch.cat([i, f, g, o], 0)

    b = b.clone()
    b[g4 // 2:3 * g4 // 4] += forget_bias
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(perm(wx.T))
        lstm.weight_hh_l0.copy_(perm(wh.T))
        lstm.bias_ih_l0.copy_(perm(b))
        lstm.bias_hh_l0.zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()
    return lstm


def library_times(lstm, xs, h0, c0, dhs, grad_inputs):
    """cuDNN's training forward and its backward alone (weights, and the
    ``grad_inputs`` among ``(xs, h0, c0)``); ``(fwd_ms, bwd_ms, out)``."""
    import torch

    hc = (h0[None], c0[None])
    out, _ = lstm(xs, hc)
    fwd = cuda_ms(lambda: lstm(xs, hc), 20)
    wrt = list(lstm.parameters()) + list(grad_inputs)
    bwd = cuda_ms(lambda: torch.autograd.grad(
        out, wrt, dhs.to(out.dtype), retain_graph=True), 10)
    return fwd, bwd, out.detach()


AB_REPS = 5        # turns of (new, row-block, row-block, new) per A/B
LSTM_BWD_STAGES = ("recompute", "loop", "weight_pass")
LN_BWD_STAGES = ("recompute", "statistics", "loop", "weight_pass")
HYPER_BWD_STAGES = ("recompute", "statistics", "loop", "dxs", "products",
                    "row_sums")


def timed_calls(calls):
    """Run ``calls`` in order with a CUDA event before and after each;
    returns the events (read them after a synchronize)."""
    import torch

    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(len(calls) + 1)]
    evs[0].record()
    for fn, ev in zip(calls, evs[1:]):
        fn()
        ev.record()
    return evs


def ab_turns(entry, extra=None, reps=AB_REPS):
    """``reps`` turns of (new, old, old, new) over ``entry``'s two calls,
    each between its own CUDA events, after one warm-up call of each;
    ``extra`` calls, when given, run after each turn, timed the same way.
    Returns ``({"new": [ms], "old": [ms]}, [events of each extra run])``."""
    import torch

    for fn in (*entry.values(), *(extra or ())):
        fn()
    turns, extras = [], []
    for _ in range(reps):
        order = ("new", "old", "old", "new")
        turns.append((order, timed_calls([entry[w] for w in order])))
        if extra:
            extras.append(timed_calls(extra))
    torch.cuda.synchronize()
    times = {"new": [], "old": []}
    for order, evs in turns:
        for i, w in enumerate(order):
            times[w].append(evs[i].elapsed_time(evs[i + 1]))
    return times, extras


def lstm_fwd_ab(name, dt, fargs, drop_kw, full, rows):
    """``srt_lstm_fwd`` (the cooperative loop) against the row-block
    design it replaced, ``srt_lstm_fwd_rowblock``, on the same inputs:
    every output bitwise equal, then both timed in turns with CUDA events
    (new, old, old, new; AB_REPS turns, medians). Uncounted launches."""
    import statistics

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    run, outs = CF.lstm_fwd_entries(**fargs, **drop_kw, full=full)
    names = [n for n, o in zip(FUSED_OUTPUTS["fused_lstm_fwd"], outs)
             if o is not None]
    snap = lambda: [o.clone() for o in outs if o is not None]
    run("srt_lstm_fwd")
    new = snap()
    run("srt_lstm_fwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(new, old)):
        ab, rel, per = rel_errs(names, new, old)
        raise AssertionError(f"{name} [{dt}]: srt_lstm_fwd is not bitwise "
                             f"the row-block design: rel err {rel}, per "
                             f"output {per}")
    del new, old
    times, _ = ab_turns({"new": lambda: run("srt_lstm_fwd"),
                         "old": lambda: run("srt_lstm_fwd_rowblock")})
    res = {"ms": statistics.median(times["new"]),
           "rowblock_ms": statistics.median(times["old"]),
           "new_ms_all": times["new"], "rowblock_ms_all": times["old"],
           "bitwise_rowblock": True}
    res["speedup"] = res["rowblock_ms"] / res["ms"]
    rows[name][dt]["ab"] = res
    log("lstm_fwd_ab", name=name, dtype=dt, reps=AB_REPS, **res)


def bwd_ab(phase, name, dt, entry, stages, run, outs, names, rows,
           label=None):
    """``entry`` (a backward's new design) against the row-block design it
    replaced, ``entry + "_rowblock"``, through the ``run``/``outs`` of a
    ``cuda_fused.*_bwd_entries`` helper on one set of inputs: every output
    (``names``) within FUSED_TOL of the other's and the new entry's
    identical run to run, then both timed in turns with CUDA events (new,
    old, old, new; AB_REPS turns, medians), and the new entry's split: its
    launches one at a time (``entry + "_stage"``, ``stages`` in order),
    each between its own events. Uncounted launches. ``label`` names the
    shape in the record when given."""
    import statistics

    import torch

    names = [n for n, o in zip(names, outs) if o is not None]
    snap = lambda: [o.clone() for o in outs if o is not None]
    run(entry)
    new = snap()
    run(entry)
    again = snap()
    run(entry + "_rowblock")
    old = snap()
    torch.cuda.synchronize()
    ab, rel, per = rel_errs(names, new, old)
    det = all(torch.equal(a, b) for a, b in zip(new, again))
    if not (rel <= FUSED_TOL[dt] and det):
        raise AssertionError(f"{name} [{dt}]: {entry} vs the row-block "
                             f"design, rel err {rel}, per output {per}; "
                             f"deterministic {det}")
    del new, again, old
    times, splits = ab_turns(
        {"new": lambda: run(entry), "old": lambda: run(entry + "_rowblock")},
        [lambda k=k: run(entry + "_stage", k)
         for k in range(1, len(stages) + 1)])
    split = {st: statistics.median(evs[i].elapsed_time(evs[i + 1])
                                   for evs in splits)
             for i, st in enumerate(stages)}
    res = {"ms": statistics.median(times["new"]),
           "rowblock_ms": statistics.median(times["old"]),
           "new_ms_all": times["new"], "rowblock_ms_all": times["old"],
           "split_ms": split, "err_vs_rowblock": ab,
           "rel_err_vs_rowblock": rel, "deterministic": det,
           "ab_phase": phase}
    if label is not None:
        res["shape"] = label
    res["speedup"] = res["rowblock_ms"] / res["ms"]
    rows[name][dt]["ab"] = res
    log(phase, name=name, dtype=dt, reps=AB_REPS, **res)


def lstm_bwd_ab(name, dt, bargs, drop_kw, full, rows):
    """``srt_lstm_bwd`` (the hoisted recompute, the cooperative loop, the
    weight pass) against ``srt_lstm_bwd_rowblock`` (``bwd_ab``)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    run, outs = CF.lstm_bwd_entries(**bargs, **drop_kw, full=full)
    bwd_ab("lstm_bwd_ab", name, dt, "srt_lstm_bwd", LSTM_BWD_STAGES, run,
           outs, FUSED_OUTPUTS["fused_lstm_bwd"], rows)


def ln_lstm_bwd_ab(dt, bargs, drop_kw, rows):
    """``srt_ln_lstm_bwd`` (the hoisted recompute and statistics, the
    cooperative loop, the weight pass) against
    ``srt_ln_lstm_bwd_rowblock`` (``bwd_ab``)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    run, outs = CF.ln_lstm_bwd_entries(**bargs, **drop_kw)
    bwd_ab("ln_lstm_bwd_ab", "fused_ln_lstm_bwd", dt, "srt_ln_lstm_bwd",
           LN_BWD_STAGES, run, outs, FUSED_OUTPUTS["fused_ln_lstm_bwd"],
           rows)


def hyper_lstm_bwd_ab(dt, bargs, drop_kw, rows, label=None):
    """``srt_hyper_bwd`` (the hoisted recompute and statistics, the
    cooperative loop, dxs, the eleven products on the split-K pass, the
    row sums) against ``srt_hyper_bwd_rowblock`` (``bwd_ab``)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    run, outs = CF.hyper_lstm_bwd_entries(**bargs, **drop_kw)
    bwd_ab("hyper_lstm_bwd_ab", "fused_hyper_lstm_bwd", dt, "srt_hyper_bwd",
           HYPER_BWD_STAGES, run, outs, FUSED_OUTPUTS["fused_hyper_lstm_bwd"],
           rows, label)


def fwd_ab(phase, name, entry, entries, reference, dt, fargs, drop_kw,
           label):
    """``entry`` (a forward's cooperative loop) against the row-block
    design it replaced, ``entry + "_rowblock"``, through ``entries`` (a
    ``cuda_fused.*_fwd_entries`` helper) on one set of inputs: every output
    (``FUSED_OUTPUTS[name]``) within FUSED_TOL of the row-block entry's and
    of ``reference``'s (the plain version), the new entry identical run to
    run, then both timed in turns with CUDA events (new, old, old, new;
    AB_REPS turns, medians). Uncounted launches. Returns the record."""
    import statistics

    import torch

    names = FUSED_OUTPUTS[name]
    run, outs = entries(**fargs, **drop_kw)
    snap = lambda: [o.clone() for o in outs]
    run(entry)
    new = snap()
    run(entry)
    again = snap()
    run(entry + "_rowblock")
    old = snap()
    torch.cuda.synchronize()
    ab, rel, per = rel_errs(names, new, old)
    pab, prel, pper = rel_errs(names, new, reference(**fargs, **drop_kw))
    det = all(torch.equal(a, b) for a, b in zip(new, again))
    if not (rel <= FUSED_TOL[dt] and prel <= FUSED_TOL[dt] and det):
        raise AssertionError(
            f"{name} [{dt}, {label}]: {entry} vs the row-block design, rel "
            f"err {rel}, per output {per}; vs the plain version {prel}, "
            f"{pper}; deterministic {det}")
    del new, again, old
    times, _ = ab_turns({"new": lambda: run(entry),
                         "old": lambda: run(entry + "_rowblock")})
    res = {"shape": label, "ms": statistics.median(times["new"]),
           "rowblock_ms": statistics.median(times["old"]),
           "new_ms_all": times["new"], "rowblock_ms_all": times["old"],
           "err_vs_rowblock": ab, "rel_err_vs_rowblock": rel,
           "err_vs_plain": pab, "rel_err_vs_plain": prel,
           "deterministic": det, "ab_phase": phase}
    res["speedup"] = res["rowblock_ms"] / res["ms"]
    log(phase, name=name, dtype=dt, reps=AB_REPS, **res)
    return res


def ln_lstm_fwd_ab(dt, fargs, drop_kw, label):
    """``srt_ln_lstm_fwd`` (the cooperative loop, the layer norms' row
    moments exchanged between its blocks) against
    ``srt_ln_lstm_fwd_rowblock`` (:func:`fwd_ab`)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    return fwd_ab("ln_lstm_fwd_ab", "fused_ln_lstm_fwd", "srt_ln_lstm_fwd",
                  CF.ln_lstm_fwd_entries, CF.ln_lstm_fwd_reference, dt,
                  fargs, drop_kw, label)


def hyper_lstm_fwd_ab(dt, fargs, drop_kw, label):
    """``srt_hyper_fwd`` (the cooperative loop over resident weight
    columns) against ``srt_hyper_fwd_rowblock`` (:func:`fwd_ab`)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    return fwd_ab("hyper_lstm_fwd_ab", "fused_hyper_lstm_fwd",
                  "srt_hyper_fwd", CF.hyper_lstm_fwd_entries,
                  CF.hyper_lstm_fwd_reference, dt, fargs, drop_kw, label)


def tiled_rows(x, b, dim):
    """``x`` repeated along ``dim`` and cut to ``b`` rows there."""
    import torch

    reps = -(-b // x.shape[dim])
    return torch.cat([x] * reps, dim).narrow(dim, 0, b).contiguous()


def check_lstm_seq(inp, rows):
    """fused_lstm_seq forward and backward (the encoder's forward
    direction) at B=100, T=250, H=256, dropout seeded."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    dt, ep = inp["dt"], inp["enc"]
    cell = inp["model"].enc_fwd
    xs, dhs = inp["x_tgt"], inp["dhs_enc"]
    t, b, d = xs.shape
    h = ep["wh"].shape[0]
    zero = torch.zeros((b, h), device=DEV)
    fargs = dict(xs=xs, wx=ep["wx"], b=ep["b"], wh=ep["wh"], c0=zero,
                 h0=zero, forget_bias=cell.forget_bias,
                 residual_dtype=inp["rdt"])
    seed_kw = dict(dropout_seed=inp["seed_enc"], keep_prob=KEEP)
    masks_kw = dict(masks=streamed_masks(inp["seed_enc"], t, b, h),
                    keep_prob=KEEP)
    hs, cs = hold_fused("fused_lstm_seq_fwd", dt,
                        lambda **k: CF.lstm_seq_fwd(**fargs, **k),
                        lambda **k: CF.lstm_seq_fwd_reference(**fargs, **k),
                        seed_kw, masks_kw, rows)
    lstm_fwd_ab("fused_lstm_seq_fwd", dt, fargs, seed_kw, False, rows)
    bargs = dict(xs=xs, wx=ep["wx"], b=ep["b"], wh=ep["wh"], h0=zero, hs=hs,
                 cs=cs, dhs=dhs, forget_bias=cell.forget_bias)
    grads = hold_fused("fused_lstm_seq_bwd", dt,
                       lambda **k: CF.lstm_seq_bwd(**bargs, **k),
                       lambda **k: CF.lstm_seq_bwd_reference(**bargs, **k),
                       seed_kw, masks_kw, rows)
    lstm_bwd_ab("fused_lstm_seq_bwd", dt, bargs, seed_kw, False, rows)

    # cuDNN's LSTM computes the same function without dropout: check it
    # does (at float32), then time its training forward and its backward
    master = inp["params"]["enc_fwd"]
    lstm = cudnn_lstm(master["wx"], master["wh"], master["b"],
                      cell.forget_bias, torch_dtype(dt))
    lib_fwd, lib_bwd, out = library_times(
        lstm, xs.to(torch_dtype(dt)), zero.to(torch_dtype(dt)),
        zero.to(torch_dtype(dt)), dhs, ())
    nodrop = CF.lstm_seq_fwd(**fargs)[0]
    lib_err = float((out.float() - nodrop.float()).abs().max())
    if dt == "float32" and not lib_err <= FUSED_TOL[dt]:
        raise AssertionError(f"cuDNN LSTM vs fused_lstm_seq: {lib_err}")

    g4 = 4 * h
    fwd_flops = 2 * t * b * (d + h) * g4
    time_fused("fused_lstm_seq_fwd", dt, CF.lstm_seq_fwd,
               CF.lstm_seq_fwd_reference, {**fargs, **seed_kw}, 20,
               fwd_flops, nbytes(xs, ep["wx"], ep["b"], ep["wh"], zero, zero,
                                 inp["seed_enc"], hs, cs), rows,
               cudnn_err_no_dropout=lib_err)
    rows["fused_lstm_seq_fwd"][dt]["library_ms"] = lib_fwd
    time_fused("fused_lstm_seq_bwd", dt, CF.lstm_seq_bwd,
               CF.lstm_seq_bwd_reference, {**bargs, **seed_kw}, 10,
               fwd_flops + 2 * t * b * h * g4 + 2 * t * b * (d + h + 1) * g4,
               nbytes(xs, ep["wx"], ep["b"], ep["wh"], zero, hs, cs, dhs,
                      inp["seed_enc"], *grads), rows)
    rows["fused_lstm_seq_bwd"][dt]["library_ms"] = lib_bwd
    log("kernel_library", name="fused_lstm_seq", dtype=dt,
        library=f"torch.nn.LSTM (cuDNN, {dt}), TF32 off", fwd_ms=lib_fwd,
        bwd_ms=lib_bwd, err_vs_kernel_no_dropout=lib_err)


def check_lstm(inp, rows):
    """fused_lstm forward and backward (the ``vae`` preset's lstm
    decoder) at B=100, T=250, H=512, D=5, with its x_bias and its
    nonzero initial carry, dropout seeded; cuDNN's LSTM over the unfolded
    inputs [x; z] (D=133) as its yardstick."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    dt, w = inp["dt"], inp["dec"]
    dp, cell = inp["params"]["dec"], inp["model"].dec
    xs, dhs = inp["x_in"], inp["dhs_dec"]
    t, b, d = xs.shape
    h = w["wh"].shape[0]
    common = dict(xs=xs, wx=w["wx"], b=dp["b"], wh=w["wh"],
                  forget_bias=cell.forget_bias, x_bias=inp["x_bias"])
    fargs = dict(common, c0=inp["c0"], h0=inp["h0"],
                 residual_dtype=inp["rdt"])
    seed_kw = dict(dropout_seed=inp["seed_dec"], keep_prob=KEEP)
    masks_kw = dict(masks=streamed_masks(inp["seed_dec"], t, b, h),
                    keep_prob=KEEP)
    hs, cs, ct, ht = hold_fused(
        "fused_lstm_fwd", dt, lambda **k: CF.lstm_fwd(**fargs, **k),
        lambda **k: CF.lstm_fwd_reference(**fargs, **k), seed_kw, masks_kw,
        rows)
    lstm_fwd_ab("fused_lstm_fwd", dt, fargs, seed_kw, True, rows)
    bargs = dict(common, h0=inp["h0"], hs=hs, cs=cs, dhs=dhs,
                 dcT=inp["dcT"], dhT=inp["dhT"])
    grads = hold_fused(
        "fused_lstm_bwd", dt, lambda **k: CF.lstm_bwd(**bargs, **k),
        lambda **k: CF.lstm_bwd_reference(**bargs, **k), seed_kw, masks_kw,
        rows)
    lstm_bwd_ab("fused_lstm_bwd", dt, bargs, seed_kw, True, rows)

    # the same function without dropout, x_bias unfolded: cuDNN over
    # [x; z] with the full input weight, from the same (h0, c0)
    tdt = torch_dtype(dt)
    lstm = cudnn_lstm(dp["wx"], dp["wh"], dp["b"], cell.forget_bias, tdt)
    x_full = torch.cat([xs, inp["z"][None].expand(t, b, -1)], -1).to(tdt)
    x_full.requires_grad_(True)
    h0 = inp["h0"].to(tdt).requires_grad_(True)
    c0 = inp["c0"].to(tdt).requires_grad_(True)
    lib_fwd, lib_bwd, out = library_times(lstm, x_full, h0, c0, dhs,
                                          (x_full, h0, c0))
    nodrop = CF.lstm_fwd(**fargs)[0]
    lib_err = float((out.float() - nodrop.float()).abs().max())
    if dt == "float32" and not lib_err <= FUSED_TOL[dt]:
        raise AssertionError(f"cuDNN LSTM vs fused_lstm: {lib_err}")

    g4 = 4 * h
    fwd_flops = 2 * t * b * (d + h) * g4
    params_in = (w["wx"], dp["b"], w["wh"], inp["x_bias"])
    time_fused("fused_lstm_fwd", dt, CF.lstm_fwd, CF.lstm_fwd_reference,
               {**fargs, **seed_kw}, 10, fwd_flops,
               nbytes(xs, *params_in, inp["c0"], inp["h0"],
                      inp["seed_dec"], hs, cs, ct, ht), rows,
               cudnn_err_no_dropout=lib_err)
    rows["fused_lstm_fwd"][dt]["library_ms"] = lib_fwd
    time_fused("fused_lstm_bwd", dt, CF.lstm_bwd, CF.lstm_bwd_reference,
               {**bargs, **seed_kw}, 5,
               fwd_flops + 2 * t * b * (d + h) * g4
               + 2 * t * b * (d + h + 1) * g4,
               nbytes(xs, *params_in, inp["h0"], hs, cs, dhs, inp["dcT"],
                      inp["dhT"], inp["seed_dec"], *grads), rows)
    rows["fused_lstm_bwd"][dt]["library_ms"] = lib_bwd
    log("kernel_library", name="fused_lstm", dtype=dt,
        library=f"torch.nn.LSTM (cuDNN, {dt}) over [x; z], D={d + 128}, "
                f"TF32 off", fwd_ms=lib_fwd, bwd_ms=lib_bwd,
        err_vs_kernel_no_dropout=lib_err)


def check_ln_lstm(inp, rows):
    """fused_ln_lstm forward and backward (the decoder) at B=100, T=250,
    H=512, with its x_bias, dropout seeded; the forward's and the
    backward's A/B against their row-block designs (the forward's also at
    the ladder's B=4096 at bfloat16)."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    dt, w = inp["dt"], inp["dec"]
    dp, cell = inp["params"]["dec"], inp["model"].dec
    xs, dhs = inp["x_in"], inp["dhs_dec"]
    t, b, d = xs.shape
    h = w["wh"].shape[0]
    ln = dict(ln_gamma=dp["ln_gamma"], ln_beta=dp["ln_beta"],
              lnc_gamma=dp["lnc_gamma"], lnc_beta=dp["lnc_beta"])
    common = dict(xs=xs, wx=w["wx"], wh=w["wh"], **ln,
                  forget_bias=cell.forget_bias, x_bias=inp["x_bias"])
    fargs = dict(common, c0=inp["c0"], h0=inp["h0"],
                 residual_dtype=inp["rdt"])
    seed_kw = dict(dropout_seed=inp["seed_dec"], keep_prob=KEEP)
    masks_kw = dict(masks=streamed_masks(inp["seed_dec"], t, b, h),
                    keep_prob=KEEP)
    hs, cs, ct, ht = hold_fused(
        "fused_ln_lstm_fwd", dt, lambda **k: CF.ln_lstm_fwd(**fargs, **k),
        lambda **k: CF.ln_lstm_fwd_reference(**fargs, **k), seed_kw,
        masks_kw, rows)
    ab = ln_lstm_fwd_ab(dt, fargs, seed_kw, f"B={b}, T={t}, H={h}")
    if dt == "bfloat16":     # the ladder's batch: the decoder's rows tiled
        lb = LADDER["b"]
        wide = dict(fargs, xs=tiled_rows(xs, lb, 1),
                    x_bias=tiled_rows(inp["x_bias"], lb, 0),
                    c0=tiled_rows(inp["c0"], lb, 0),
                    h0=tiled_rows(inp["h0"], lb, 0))
        ab[f"at_B{lb}"] = ln_lstm_fwd_ab(
            dt, wide, seed_kw, f"B={lb} (the decoder's rows tiled), "
                               f"T={t}, H={h}")
        del wide
        torch.cuda.empty_cache()
    rows["fused_ln_lstm_fwd"][dt]["ab"] = ab
    bargs = dict(common, h0=inp["h0"], hs=hs, cs=cs, dhs=dhs,
                 dcT=inp["dcT"], dhT=inp["dhT"])
    grads = hold_fused(
        "fused_ln_lstm_bwd", dt, lambda **k: CF.ln_lstm_bwd(**bargs, **k),
        lambda **k: CF.ln_lstm_bwd_reference(**bargs, **k), seed_kw,
        masks_kw, rows)
    ln_lstm_bwd_ab(dt, bargs, seed_kw, rows)
    g4 = 4 * h
    fwd_flops = 2 * t * b * (d + h) * g4
    params_in = (w["wx"], w["wh"], *ln.values(), inp["x_bias"])
    time_fused("fused_ln_lstm_fwd", dt, CF.ln_lstm_fwd,
               CF.ln_lstm_fwd_reference, {**fargs, **seed_kw}, 10,
               fwd_flops, nbytes(xs, *params_in, inp["c0"], inp["h0"],
                                 inp["seed_dec"], hs, cs, ct, ht), rows)
    time_fused("fused_ln_lstm_bwd", dt, CF.ln_lstm_bwd,
               CF.ln_lstm_bwd_reference, {**bargs, **seed_kw}, 5,
               3 * fwd_flops,
               nbytes(xs, *params_in, inp["h0"], hs, cs, dhs, inp["dcT"],
                      inp["dhT"], inp["seed_dec"], *grads), rows)


# batches whose tiles do not fit in one block's shared memory at once:
# each persistent entry at H=512, B=8192 (float32, the weights' most
# shared memory) and the LSTM backward at bench.py's encoder shape
WINDOW_CASES = (("srt_lstm_fwd", 512, 8192, "float32"),
                ("srt_lstm_bwd", 512, 8192, "float32"),
                ("srt_ln_lstm_fwd", 512, 8192, "float32"),
                ("srt_ln_lstm_bwd", 512, 8192, "float32"),
                ("srt_lstm_bwd", 256, 4096, "bfloat16"))
WINDOW_T = 8


def window_entries(entry, h, b, dt, t=WINDOW_T, d=5, seed=11):
    """The A/B helper's ``(run, outs)`` of one persistent entry on seeded
    inputs at ``(T, B, H)``: wh N(0, 1 / H), wx N(0, 0.16), both in the
    weight dtype, x_bias, carries, LN parameters near (1, 0), dropout
    seeded at keep 0.9, residuals in ``dt``; a backward over the residuals
    of the matching forward wrapper, with nonzero carry cotangents."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (sc * torch.randn(s, generator=g)).to(DEV)
    wdt = torch_dtype(dt)
    ln = entry.startswith("srt_ln_")
    xs, c0, h0 = r(t, b, d), r(b, h, sc=0.3), r(b, h, sc=0.3)
    wx = r(d, 4 * h, sc=0.4).to(wdt)
    wh = r(h, 4 * h, sc=h ** -0.5).to(wdt)
    w = ((xs, wx, wh, 1 + r(4, h, sc=0.1), r(4, h, sc=0.1),
          1 + r(h, sc=0.1), r(h, sc=0.1)) if ln
         else (xs, wx, r(4 * h, sc=0.1), wh))
    drop = dict(dropout_seed=torch.tensor(4242, dtype=torch.int32,
                                          device=DEV), keep_prob=KEEP,
                x_bias=r(b, 4 * h, sc=0.3))
    rdt = None if dt == "float32" else wdt
    if entry.endswith("_fwd"):
        if ln:
            return CF.ln_lstm_fwd_entries(*w, c0, h0, **drop,
                                          residual_dtype=rdt)
        return CF.lstm_fwd_entries(*w, c0, h0, **drop, residual_dtype=rdt)
    hs, cs, _, _ = (CF.ln_lstm_fwd if ln else CF.lstm_fwd)(
        *w, c0, h0, **drop, residual_dtype=rdt)
    cot = dict(dhs=r(t, b, h, sc=0.1).to(hs.dtype), dcT=r(b, h, sc=0.1),
               dhT=r(b, h, sc=0.1))
    return (CF.ln_lstm_bwd_entries if ln else CF.lstm_bwd_entries)(
        *w, h0, hs, cs, **cot, **drop)


def check_batch_windows():
    """Each WINDOW_CASES entry, which runs as cooperative launches over
    windows of rows, against its row-block entry on the same inputs
    (bitwise for ``srt_lstm_fwd``, whose sums keep the row-block order;
    FUSED_TOL for the others), identical run to run, then both timed in
    turns (``ab_turns``). Uncounted launches; one line per case."""
    import statistics

    import torch

    t_phase = time.perf_counter()
    for entry, h, b, dt in WINDOW_CASES:
        run, outs = window_entries(entry, h, b, dt)
        snap = lambda: [o.clone() for o in outs if o is not None]
        run(entry)
        new = snap()
        run(entry)
        again = snap()
        run(entry + "_rowblock")
        old = snap()
        torch.cuda.synchronize()
        ab, rel, _ = rel_errs([str(i) for i in range(len(new))], new, old)
        det = all(torch.equal(x, y) for x, y in zip(new, again))
        bitwise = all(torch.equal(x, y) for x, y in zip(new, old))
        ok = bitwise if entry == "srt_lstm_fwd" else rel <= FUSED_TOL[dt]
        if not (ok and det):
            raise AssertionError(
                f"{entry} at H={h}, B={b} [{dt}] in windows: rel err {rel} "
                f"vs the row-block entry (bitwise {bitwise}), "
                f"deterministic {det}")
        del new, again, old
        times, _ = ab_turns({"new": lambda: run(entry),
                             "old": lambda: run(entry + "_rowblock")})
        log("batch_windows", entry=entry, H=h, B=b, T=WINDOW_T, dtype=dt,
            err_vs_rowblock=ab, rel_err_vs_rowblock=rel,
            bitwise_rowblock=bitwise, deterministic=det,
            tol=None if entry == "srt_lstm_fwd" else FUSED_TOL[dt],
            ms=statistics.median(times["new"]),
            rowblock_ms=statistics.median(times["old"]))
        del run, outs
        torch.cuda.empty_cache()
    log("batch_windows_done", seconds=time.perf_counter() - t_phase)


# the weight pass's A/B: (label, the kernel row it serves, T, B, D, H,
# ones, dtypes, turns). At B=4096 the old pass takes ~0.3 s a call: 2
# turns there.
WG_AB = (("decoder (5b)", "fused_ln_lstm_bwd", 250, 100, 5, 512, 0, DTYPES,
          AB_REPS),
         ("decoder, ones (3b)", "fused_lstm_bwd", 250, 100, 5, 512, 1, DTYPES,
          AB_REPS),
         ("encoder (4b)", "fused_lstm_seq_bwd", 250, 100, 5, 256, 1, DTYPES,
          AB_REPS),
         ("lstm_seq dwh (7b)", "lstm_seq_bwd", 250, 100, 0, 512, 0,
          ("float32",), AB_REPS),
         ("decoder (5b, 8b, 9)", None, 250, 4096, 5, 512, 0, ("bfloat16",), 2),
         ("encoder (4b)", None, 250, 4096, 5, 256, 1, ("bfloat16",), 2))
WG_SRC = "sketch_rnn_tpu_torch/csrc/weight_grad.cuh"


def weight_grad_ab(rows):
    """The weight pass (``cuda_fused.weight_grad_entries``: the split-K
    pass every backward entry runs, variant 0, and the pass it replaced,
    variant 1) at each shape of WG_AB over one seeded ``d_pre`` scratch
    (N(0, 0.01)) with seeded ``xs``, ``h0`` and ``hs`` (the residual
    dtype = the weight dtype): every output within FUSED_TOL of the plain
    version (``weight_grad_reference``) and of the old pass, relative to
    each output's largest magnitude; the new pass identical run to run;
    both timed in turns with CUDA events (new, old, old, new; medians);
    ``torch.mm`` of the same rounded operands ``[x; h; 1]^T @ d_pre``
    (TF32 off) as the library time; the bound. Uncounted launches. The
    B=100 records also go to the kernel row they serve (``weight_pass``).
    """
    import statistics

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    t_phase = time.perf_counter()
    for label, row, t, b, d, h, ones, dts, reps in WG_AB:
        for dt in dts:
            wdt = torch_dtype(dt)
            g = torch.Generator(device=DEV).manual_seed(t * b + h + ones)
            r = lambda *sh, sc=1.0: sc * torch.randn(sh, generator=g,
                                                     device=DEV)
            xs, h0 = r(t, b, d), r(b, h, sc=0.3)
            hs = r(t, b, h, sc=0.3).to(wdt)
            d_pre = r(t, b, 4 * h, sc=0.01)
            run, outs = CF.weight_grad_entries(xs, h0, hs, d_pre, ones, wdt)
            # the outputs there are (no dwx at D=0, no db without ones)
            kept = [i for i, o in enumerate(outs)
                    if o is not None and o.numel()]
            names = [("dwx", "dwh", "db")[i] for i in kept]
            snap = lambda: [outs[i].clone() for i in kept]
            run(0)
            new = snap()
            run(0)
            again = snap()
            run(1)
            old = snap()
            torch.cuda.synchronize()
            det = all(torch.equal(a, q) for a, q in zip(new, again))
            ref = lambda: CF.weight_grad_reference(xs, h0, hs, d_pre, d, h,
                                                   ones, wdt)
            want = [ref()[i] for i in kept]
            ab, rel, per = rel_errs(names, new, want)
            ab_old, rel_old, _ = rel_errs(names, new, old)
            del new, again, old, want
            if not (rel <= FUSED_TOL[dt] and rel_old <= FUSED_TOL[dt]
                    and det):
                raise AssertionError(
                    f"weight pass {label} B={b} [{dt}]: rel err {rel} vs "
                    f"plain, {rel_old} vs the old pass (tol "
                    f"{FUSED_TOL[dt]}), per output {per}; deterministic "
                    f"{det}")
            times, _ = ab_turns({"new": lambda: run(0),
                                 "old": lambda: run(1)}, reps=reps)
            # the library: one product of the same rounded operands
            k = t * b
            cols = [xs.reshape(k, d), torch.cat(
                [h0.to(hs.dtype)[None], hs[:-1]]).reshape(k, h).float()]
            if ones:
                cols.append(torch.ones((k, 1), device=DEV))
            a_op = torch.cat(cols, dim=1).to(wdt)
            d_op = d_pre.reshape(k, 4 * h).to(wdt)
            library = cuda_ms(lambda: torch.mm(a_op.t(), d_op), 10)
            del a_op, d_op, cols
            plain = cuda_ms(ref, 2)
            flops = 2 * k * (d + h + ones) * 4 * h
            moved = nbytes(xs, h0, hs, d_pre) + (d + h + ones) * 4 * h * 4
            bms, by = bound_ms(flops, moved, dt)
            plan = CF.weight_grad_plan(t, b, d, h, ones, wdt)
            res = {"ms": statistics.median(times["new"]),
                   "old_ms": statistics.median(times["old"]),
                   "new_ms_all": times["new"], "old_ms_all": times["old"],
                   "library_ms": library, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "flops": flops,
                   "bytes": moved, "slices": plan.slices,
                   "kslice": plan.kslice, "err": ab, "rel_err": rel,
                   "errs": per, "rel_err_vs_old": rel_old,
                   "deterministic": det}
            res["speedup"] = res["old_ms"] / res["ms"]
            res["x_library"] = res["ms"] / library
            res["x_bound"] = res["ms"] / bms
            log("weight_grad_ab", shape=label, T=t, B=b, D=d, H=h,
                ones=ones, dtype=dt, tol=FUSED_TOL[dt], reps=reps, **res)
            if row is not None:
                rows[row][dt]["weight_pass"] = res
            del run, outs, xs, h0, hs, d_pre
            torch.cuda.empty_cache()
    log("weight_grad_ab_done", seconds=time.perf_counter() - t_phase)


def flat_hyper(out):
    """A HyperLSTM kernel's outputs as a flat tuple of tensors (the
    backward's ``HyperWeights`` of gradients unpacked in place)."""
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, tuple) else (o,))
    return tuple(flat)


def hyper_kernel_inputs(t, b, d, h, hh, e, dt, seed=0):
    """Seeded HyperLSTM operands at any widths (every projection dense):
    ``(xs, weights, carries, (x_bias, x_bias_hyper), cotangents)``."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    g = torch.Generator().manual_seed(seed)
    f = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(DEV)
    w = CF.HyperWeights(
        wx=f(d, 4 * h, sc=0.4), b=f(4 * h, sc=0.1),
        wh=f(h, 4 * h, sc=h ** -0.5), wxh_x=f(d, 4 * hh, sc=0.4),
        wxh_h=f(h, 4 * hh, sc=h ** -0.5), bh=f(4 * hh, sc=0.1),
        whh=f(hh, 4 * hh, sc=hh ** -0.5), w_hz_x=f(hh, 4 * e, sc=0.1),
        b_hz_x=1 + f(4 * e, sc=0.1), w_hz_h=f(hh, 4 * e, sc=0.1),
        b_hz_h=1 + f(4 * e, sc=0.1), w_hz_b=f(hh, 4 * e, sc=0.1),
        zd_x=0.1 / e + f(4, e, h, sc=0.02),
        zd_h=0.1 / e + f(4, e, h, sc=0.02), zd_b=f(4, e, h, sc=0.02),
        ln_gamma=1 + f(4, h, sc=0.1), ln_beta=f(4, h, sc=0.1),
        lnc_gamma=1 + f(h, sc=0.1), lnc_beta=f(h, sc=0.1))
    w = w._replace(**{n: getattr(w, n).to(torch_dtype(dt))
                      for n in CF.HYPER_MATRICES})
    carries = (f(b, h, sc=0.3), f(b, h, sc=0.3), f(b, hh, sc=0.3),
               f(b, hh, sc=0.3))
    biases = (f(b, 4 * h, sc=0.3), f(b, 4 * hh, sc=0.3))
    cots = (f(t, b, h, sc=0.01).to(torch_dtype(dt)), f(b, h, sc=0.01),
            f(b, h, sc=0.01), f(b, hh, sc=0.01), f(b, hh, sc=0.01))
    return f(t, b, d), w, carries, biases, cots


def hold_hyper(dt, xs, w, carries, biases, cots, seed, rows):
    """``fused_hyper_lstm`` forward and backward against their plain
    versions on the same operands (:func:`hold_fused`); returns the
    keyword arguments of the two kernels and their outputs."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    t, b, _ = xs.shape
    h = w.wh.shape[0]
    c0, h0, hc0, hh0 = carries
    rdt = None if dt == "float32" else torch_dtype(dt)
    common = dict(xs=xs, w=w, forget_bias=1.0, x_bias=biases[0],
                  x_bias_hyper=biases[1])
    fargs = dict(common, c0=c0, h0=h0, hc0=hc0, hh0=hh0, residual_dtype=rdt)
    seed_kw = dict(dropout_seed=seed, keep_prob=KEEP)
    masks_kw = dict(masks=streamed_masks(seed, t, b, h), keep_prob=KEEP)
    fwd = hold_fused(
        "fused_hyper_lstm_fwd", dt, lambda **k: CF.hyper_lstm_fwd(**fargs, **k),
        lambda **k: CF.hyper_lstm_fwd_reference(**fargs, **k), seed_kw,
        masks_kw, rows)
    hs, cs, hycs, hyhs = fwd[:4]
    dhs, dcT, dhT, dhcT, dhhT = cots
    bargs = dict(common, h0=h0, hh0=hh0, hs=hs, cs=cs, hycs=hycs, hyhs=hyhs,
                 dhs=dhs, dcT=dcT, dhT=dhT, dhcT=dhcT, dhhT=dhhT)
    grads = hold_fused(
        "fused_hyper_lstm_bwd", dt,
        lambda **k: flat_hyper(CF.hyper_lstm_bwd(**bargs, **k)),
        lambda **k: flat_hyper(CF.hyper_lstm_bwd_reference(**bargs, **k)),
        seed_kw, masks_kw, rows)
    return fargs, bargs, seed_kw, fwd, grads


def check_hyper_narrow(dt):
    """The HyperLSTM kernels where the widths stand in another order than
    at full width: H=16 under HH=32 and 4e=32, and H=40 over HH=8 with a
    part-filled last warp (T=6, B=5, D=5)."""
    import torch

    from sketch_rnn_tpu_torch.utils import prng

    seed = prng.randint(prng.key(5), 0, 2 ** 31 - 1).to(DEV)
    for h, hh, e in ((16, 32, 8), (40, 8, 4)):
        rows = {}
        hold_hyper(dt, *hyper_kernel_inputs(6, 5, 5, h, hh, e, dt), seed,
                   rows)
        torch.cuda.synchronize()
        for name, r in rows.items():
            log("kernel", name=name, dtype=dt, shape="narrow", T=6, B=5, H=h,
                HH=hh, e=e, tol=FUSED_TOL[dt], **r[dt])


def check_hyper(inp, rows):
    """fused_hyper_lstm forward and backward (the ``hyper`` preset's
    decoder) at B=100, T=250, H=512, HH=256, e=32, D=5, with both
    per-example biases (the projections of z) and the four nonzero initial
    carries, dropout seeded. The model's zero- and constant-initialised
    projections (``w_hz_x``, ``w_hz_h``, ``w_zd_*``) are perturbed, so
    every product and every gradient works on dense values."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.ops import linear as L

    dt, model = inp["dt"], inp["model"]
    dp, cell = inp["params"]["dec"], inp["model"].dec
    cdt = cell.compute_dtype
    wdt = torch_dtype(dt)
    xs = inp["x_in"]
    t, b, d = xs.shape
    h, hh, e = cell.hidden_size, cell.hyper_size, cell.embed_size
    g = torch.Generator().manual_seed(13)
    noisy = lambda n, sc: dp[n] + (sc * torch.randn(
        dp[n].shape, generator=g)).to(DEV)
    d_in = dp["hyper"]["wx"].shape[0] - h
    wxh = dp["hyper"]["wx"]
    w = CF.HyperWeights(
        wx=dp["wx"][:d], b=dp["b"], wh=dp["wh"], wxh_x=wxh[:d],
        wxh_h=wxh[d_in:], bh=dp["hyper"]["b"], whh=dp["hyper"]["wh"],
        w_hz_x=noisy("w_hz_x", 0.05), b_hz_x=dp["b_hz_x"],
        w_hz_h=noisy("w_hz_h", 0.05), b_hz_h=dp["b_hz_h"],
        w_hz_b=dp["w_hz_b"], zd_x=noisy("w_zd_x", 0.002),
        zd_h=noisy("w_zd_h", 0.002), zd_b=noisy("w_zd_b", 0.002),
        ln_gamma=dp["ln_gamma"], ln_beta=dp["ln_beta"],
        lnc_gamma=dp["lnc_gamma"], lnc_beta=dp["lnc_beta"])
    w = w._replace(**{n: getattr(w, n).to(wdt).contiguous()
                      for n in CF.HYPER_MATRICES})
    extra = inp["z"]
    biases = (inp["x_bias"], L.matmul(extra, wxh[d:d_in], cdt))
    carries = tuple(x.contiguous() for x in cell.carry_leaves(
        model.decoder_initial_carry(inp["params"], extra, b)))
    gc = torch.Generator().manual_seed(17)
    cots = (inp["dhs_dec"], inp["dcT"], inp["dhT"],
            (0.01 * torch.randn((b, hh), generator=gc)).to(DEV),
            (0.01 * torch.randn((b, hh), generator=gc)).to(DEV))
    fargs, bargs, seed_kw, fwd, grads = hold_hyper(
        dt, xs, w, carries, biases, cots, inp["seed_dec"], rows)

    # products per row-step: main, auxiliary LSTM, z (matrices of the
    # weight dtype); the block scales (float32 at either dtype)
    w_flops = 2 * t * b * ((d + h) * 4 * h + (d + h + hh) * 4 * hh
                           + 3 * hh * 4 * e)
    zd_flops = 2 * t * b * 3 * 4 * e * h
    if dt == "float32":
        w_flops, zd_flops = w_flops + zd_flops, 0
    operands = (xs, *w, *biases, inp["seed_dec"])
    time_fused("fused_hyper_lstm_fwd", dt, CF.hyper_lstm_fwd,
               CF.hyper_lstm_fwd_reference, {**fargs, **seed_kw}, 5, w_flops,
               nbytes(*operands, *carries, *fwd), rows, f32_flops=zd_flops,
               plan=CF.hyper_fwd_plan(b, d, h, hh, e, wdt)._asdict())
    rows["fused_hyper_lstm_fwd"][dt]["ab"] = hyper_lstm_fwd_ab(
        dt, fargs, seed_kw, f"B={b}, T={t}, H={h}, HH={hh}, e={e}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    CF.hyper_lstm_bwd(**bargs, **seed_kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # recompute + transposed products + weight-gradient products
    time_fused("fused_hyper_lstm_bwd", dt,
               lambda **k: CF.hyper_lstm_bwd(**k),
               lambda **k: CF.hyper_lstm_bwd_reference(**k),
               {**bargs, **seed_kw}, 3, 3 * w_flops,
               nbytes(*operands, carries[1], carries[3], *fwd[:4], *cots,
                      *grads), rows, f32_flops=3 * zd_flops,
               scratch_bytes=CF.hyper_scratch_bytes(t, b, d, h, hh, e, wdt),
               call_peak_bytes=peak,
               plan=CF.hyper_bwd_plan(b, h, hh, e, wdt)._asdict())
    hyper_lstm_bwd_ab(dt, bargs, seed_kw, rows)


# the HyperLSTM backward's loop over windows of rows: (T, B, H, HH, e)
HYPER_WINDOW_CASE = (WINDOW_T, 8192, 512, 256, 32)


def check_hyper_windows():
    """``srt_hyper_fwd`` and ``srt_hyper_bwd`` at a batch whose tiles take
    several windows of rows (HYPER_WINDOW_CASE, float32, seeded operands,
    dropout seeded) against their row-block entries on the same inputs
    (:func:`hyper_lstm_fwd_ab`; ``bwd_ab``: within FUSED_TOL, identical
    run to run, timed in turns, the backward with its split); uncounted
    launches, their own records (not a kernel row's)."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    t, b, h, hh, e = HYPER_WINDOW_CASE
    xs, w, carries, biases, cots = hyper_kernel_inputs(t, b, 5, h, hh, e,
                                                       "float32", seed=3)
    seed = prng.randint(prng.key(9), 0, 2 ** 31 - 1).to(DEV)
    c0, h0, hc0, hh0 = carries
    common = dict(xs=xs, w=w, forget_bias=1.0, x_bias=biases[0],
                  x_bias_hyper=biases[1])
    drop = dict(dropout_seed=seed, keep_prob=KEEP)
    fargs = dict(common, c0=c0, h0=h0, hc0=hc0, hh0=hh0)
    fplan = CF.hyper_fwd_plan(b, 5, h, hh, e)
    hyper_lstm_fwd_ab("float32", fargs, drop,
                      f"windows: T={t}, B={b}, H={h}, HH={hh}, e={e}, "
                      f"{fplan.windows} windows")
    log("batch_windows", entry="srt_hyper_fwd", H=h, HH=hh, e=e, B=b, T=t,
        dtype="float32", plan=fplan._asdict(),
        seconds=time.perf_counter() - t_phase)
    hs, cs, hycs, hyhs = CF.hyper_lstm_fwd(**fargs, **drop)[:4]
    dhs, dcT, dhT, dhcT, dhhT = cots
    bargs = dict(common, h0=h0, hh0=hh0, hs=hs, cs=cs, hycs=hycs, hyhs=hyhs,
                 dhs=dhs, dcT=dcT, dhT=dhT, dhcT=dhcT, dhhT=dhhT)
    plan = CF.hyper_bwd_plan(b, h, hh, e)
    rows = {"fused_hyper_lstm_bwd": {"float32": {}}}
    hyper_lstm_bwd_ab("float32", bargs, drop, rows,
                      label=f"windows: T={t}, B={b}, H={h}, HH={hh}, e={e}, "
                            f"{plan.windows} windows")
    log("batch_windows", entry="srt_hyper_bwd", H=h, HH=hh, e=e, B=b, T=t,
        dtype="float32", plan=plan._asdict(),
        seconds=time.perf_counter() - t_phase)
    del bargs, hs, cs, hycs, hyhs, xs, w, carries, biases, cots
    torch.cuda.empty_cache()


def train_main_path(card, hps, phase, label, per_step, steps, warm,
                    falling=False):
    """A training main path: ``train/loop.train`` at full width, a
    ``warm``-step warm-up run, then a ``steps``-step run from the same
    weights, timed, with the training kernels' launch counters
    (``cuda_fused``, ``cuda_lstm``) zeroed just before and read just
    after; ``per_step``: the launches each step must make (any other
    count must read 0);
    ``falling``: the last loss must lie under the first."""
    import math

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.ops import cuda_lstm as CL
    from sketch_rnn_tpu_torch.train.loop import train

    hps, model, params, loader = setup(hps)
    train(hps, loader, seed=0, num_steps=warm, params=params, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CF.reset_launch_counts()
    CL.reset_launch_counts()
    t0 = time.perf_counter()
    state, rows = train(hps, loader, seed=0, num_steps=steps,
                        params=params, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**CF.launch_counts(), **CL.launch_counts()}
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"training kernel launches {launches}, "
                             f"expected {want}")
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("loss", "grad_norm", "kl")):
            raise AssertionError(f"step {r['step']}: non-finite metrics {r}")
    if falling and not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"loss did not fall: {rows[0]['loss']} -> "
                             f"{rows[-1]['loss']}")
    log(phase, card=card, preset=label, batch=hps.batch_size,
        max_seq_len=hps.max_seq_len, steps=steps, warmup_steps=warm,
        launches=launches, ms_per_step=wall * 1e3 / steps,
        steps_per_s=steps / wall,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        per_step=[{k: r[k] for k in ("step", "loss", "recon", "kl",
                                     "grad_norm", "lr")} for r in rows])
    return launches, (hps, model, loader, state)


@contextlib.contextmanager
def plain_kernels():
    """Run the training kernels' plain versions on CUDA tensors (for the
    reference step only): swaps the eight kernel wrappers of
    ``ops/cuda_fused.py`` for their plain versions, then restores them."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF

    names = ("lstm_seq_fwd", "lstm_seq_bwd", "lstm_fwd", "lstm_bwd",
             "ln_lstm_fwd", "ln_lstm_bwd", "hyper_lstm_fwd",
             "hyper_lstm_bwd")
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


def hold_step(what, gaps, dt):
    rel_tol, upd_tol = STEP_TOL[dt]
    if not (gaps["loss_rel_err"] <= rel_tol
            and gaps["grad_norm_rel_err"] <= rel_tol
            and gaps["update_err"] <= upd_tol):
        raise AssertionError(f"{what} [{dt}]: {gaps} (tol rel {rel_tol}, "
                             f"update {upd_tol})")


def train_reference(hps_fn, dt, hps, model, loader, state):
    """One full-width step through the kernels against the same step
    (state, batch, key) through the plain versions on the card, from the
    main path's final state (Adam's moments carry history there, so an
    update is not the sign of a first gradient). Then one small step on
    the card against the same step on the CPU."""
    from sketch_rnn_tpu_torch.train.step import make_train_step
    from sketch_rnn_tpu_torch.utils import prng

    step = make_train_step(model, hps, device=DEV)
    batch, key = loader.next_batch(), prng.fold_in(prng.key(11), state.step)
    kern = step(state, batch, key)
    with plain_kernels():
        plain = step(state, batch, key)
    full = compare_steps(state, kern, plain)
    hold_step("full-width step, kernels vs plain versions", full, dt)

    small = hps_fn(batch_size=8, max_seq_len=24, enc_rnn_size=16,
                   dec_rnn_size=32, z_size=8, num_mixture=3,
                   **({"num_classes": 5, "class_embed_size": 4}
                      if hps.num_classes else {}), **dtype_over(dt))
    vs_cpu = small_step_vs_cpu(small, dt)
    log("train_reference", dec_model=hps.dec_model, dtype=dt,
        step=state.step, kernels_vs_plain=full, small_card_vs_cpu=vs_cpu,
        rel_tol=STEP_TOL[dt][0], update_tol=STEP_TOL[dt][1])


def small_step_vs_cpu(small, dt):
    """One step of the small model ``small`` on the card against the same
    step (state with one step of history, batch, key) on the CPU, held
    within STEP_TOL; returns the gaps."""
    import torch

    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.train.state import make_train_state
    from sketch_rnn_tpu_torch.train.step import make_train_step
    from sketch_rnn_tpu_torch.utils import prng

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
    hold_step(f"small {small.dec_model} step, card vs CPU", vs_cpu, dt)
    return vs_cpu


def profile_train(hps, loader, state, preset="quickdraw345_dp"):
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
    log("train_profile", preset=preset, dtype=hps.compute_dtype, steps=2,
        wall_ms=wall * 1e3, profiled_wall_ms=wall_prof * 1e3,
        device_ms=total / 1e3, device_busy_share=total / 1e6 / wall,
        device_kernels_per_step=sum(e.count for e in kernels) / 2,
        top=[{"name": e.key[:60], "device_ms": e.self_device_time_total
              / 1e3, "count": e.count} for e in top])


# -- the two ends of the main path: .npz files, eval, checkpoints ----------

# the train_workdir phase's corpus: one file a class, QuickDraw's integer
# deltas; 345 x 4 valid sketches are 14 eval batches at B=100
WORKDIR_CLASSES = 345
WORKDIR_SPLITS = dict(num_train=30, num_valid=4, num_test=4)
WORKDIR_STEPS = 4          # run A; run B stops at its step-2 save
WORKDIR_AB_STEPS = 10      # each timed run without / with a workdir
SERVE_FROM_CKPT = dict(generate=8, complete=4, reconstruct=4)


def serve_from(hps, model, params, seed=0):
    """``SERVE_FROM_CKPT``'s requests through ``serve_requests`` at the
    flagship's serving settings, with the serving kernels' counters zeroed
    just before and read just after: ``(results by uid, launches)``."""
    import numpy as np

    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
    from sketch_rnn_tpu_torch.serve.engine import Request
    from sketch_rnn_tpu_torch.utils import prng

    rng = np.random.default_rng(seed)
    reqs = []
    for ep, n in SERVE_FROM_CKPT.items():
        for _ in range(n):
            i = len(reqs)
            reqs.append(Request(
                key=prng.fold_in(prng.key(seed), i), endpoint=ep,
                label=int(rng.integers(hps.num_classes)), temperature=0.8,
                max_len=int(rng.integers(16, 65)),
                z=(rng.normal(size=hps.z_size).astype(np.float32)
                   if ep == "generate" else None),
                prefix=(None if ep == "generate" else
                        synthetic_prefix(rng, int(rng.integers(20, 60))))))
    cd.reset_launch_counts()
    out = serve_requests(model, hps, params, reqs, device=DEV)
    launches = {"decode_chunk": cd.decode_chunk_launches,
                "replay_chunk": cd.replay_chunk_launches}
    if out["metrics"]["completed"] != len(reqs):
        raise AssertionError(f"served {out['metrics']['completed']} of "
                             f"{len(reqs)}")
    for res in out["results"]:
        check_result(res, reqs[res.uid].max_len)
    return {r.uid: r for r in out["results"]}, launches


def train_workdir(card):
    """The two ends of the main path at the flagship's full width (bf16,
    B=100, T=250): ``write_synthetic_npz`` writes one ``.npz`` file for
    each of the 345 classes into a temporary directory and
    ``load_dataset`` reads them; run A trains 4 steps with a workdir,
    evaluating the valid split and saving in the background every 2
    steps, logging every step, then sweeping the test split, with the
    training kernels' counters zeroed just before and read just after
    (exact launches a step and an eval batch); run B trains to its step-2
    save, then again to step 4 with fresh loaders, and must end on run
    A's state bit for bit. ``restore_checkpoint`` of A's last save must
    equal A's state, and serve the same strokes as A's live parameters.
    Also timed: the steps without and with a workdir (eval and saves
    every 2 steps) in turns, a synchronous save, the eval sweep alone
    (with its peak memory)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sketch_rnn_tpu_torch.data.loader import (load_dataset,
                                                  write_synthetic_npz)
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.ops import cuda_lstm as CL
    from sketch_rnn_tpu_torch.train import checkpoint as ck
    from sketch_rnn_tpu_torch.train.loop import evaluate, train
    from sketch_rnn_tpu_torch.train.state import states_equal
    from sketch_rnn_tpu_torch.train.step import make_eval_step

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workdir_")
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        names = tuple(f"class{c:03d}.npz" for c in range(WORKDIR_CLASSES))
        t0 = time.perf_counter()
        for c, name in enumerate(names):
            write_synthetic_npz(os.path.join(data, name), class_id=c,
                                seed=c, integer_grid=255.0, **WORKDIR_SPLITS)
        write_s = time.perf_counter() - t0
        hps = train_hps(**dtype_over("bfloat16"), data_set=names,
                        save_every=2, eval_every=2, log_every=1)
        t0 = time.perf_counter()
        tr, va, te, scale = load_dataset(hps, data)
        read_s = time.perf_counter() - t0
        model = SketchRNN(hps)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=DEV)

        def fresh():
            return load_dataset(hps, data)[:3]

        workdir = lambda name: os.path.join(tmp, name)
        n_eval = 2 * va.num_eval_batches + te.num_eval_batches
        torch.cuda.synchronize()
        CF.reset_launch_counts()
        CL.reset_launch_counts()
        state_a, rows = train(hps, tr, va, te, scale, workdir=workdir("A"),
                              num_steps=WORKDIR_STEPS, params=params,
                              device=DEV)
        torch.cuda.synchronize()
        launches = {**CF.launch_counts(), **CL.launch_counts()}
        per_step = {"fused_lstm_seq_fwd": 2, "fused_lstm_seq_bwd": 2,
                    "fused_ln_lstm_fwd": 1, "fused_ln_lstm_bwd": 1}
        per_eval = {"fused_lstm_seq_fwd": 2, "fused_ln_lstm_fwd": 1}
        want = {k: WORKDIR_STEPS * per_step.get(k, 0)
                + n_eval * per_eval.get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"train_workdir launches {launches}, "
                                 f"expected {want}")
        files = sorted(os.listdir(workdir("A")))
        want_files = sorted(
            [f"ckpt_{s:08d}.{e}" for s in (2, 4) for e in ("json",
                                                          "msgpack")]
            + [f"{n}_metrics.{e}" for n in ("train", "valid", "test")
               for e in ("csv", "jsonl")])
        if files != want_files:
            raise AssertionError(f"workdir A holds {files}")
        if not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"non-finite losses {rows}")

        train(hps, *fresh(), scale, workdir=workdir("B"), num_steps=2,
              params=params, device=DEV)
        state_b, _ = train(hps, *fresh(), scale, workdir=workdir("B"),
                           num_steps=WORKDIR_STEPS, device=DEV)
        resume_bitwise = states_equal(state_a, state_b)
        if not resume_bitwise:
            raise AssertionError("run B resumed at step 2 does not end on "
                                 "run A's state bit for bit")
        restored, r_scale, _ = ck.restore_checkpoint(workdir("A"), state_a,
                                                     device=DEV)
        if not (states_equal(state_a, restored) and r_scale == scale):
            raise AssertionError("restore_checkpoint(A) differs from run "
                                 "A's state")

        def sentinel(p):
            # the pen-suppression sentinel of serve_main_path, on a copy:
            # a 4-step model ends its sketches after a few steps
            p = dict(p, out_b=p["out_b"].clone())
            p["out_b"][2] = -1e9
            return p

        served = [serve_from(hps, model, sentinel(p))
                  for p in (restored.params, state_a.params)]
        (got, got_launches), (live, live_launches) = served
        for uid, a in live.items():
            b = got[uid]
            if not (a.steps == b.steps and np.array_equal(a.strokes5,
                                                          b.strokes5)):
                raise AssertionError(f"request {uid}: strokes from the "
                                     f"checkpoint differ from the live "
                                     f"state's")
        for ln in (got_launches, live_launches):
            if not (ln["decode_chunk"] > 0 and ln["replay_chunk"] > 0):
                raise AssertionError(f"serving kernel launches {ln}")

        # steps without and with a workdir, in turns (plain, workdir,
        # workdir, plain), from the same weights, at run A's cadences: the
        # workdir arm evaluates the valid split and saves every 2 steps;
        # both arms drain a log row every step
        walls = {"plain": [], "workdir": []}
        for i, way in enumerate(("plain", "workdir", "workdir", "plain")):
            extra = (dict(valid_loader=va, workdir=workdir(f"ab{i}"))
                     if way == "workdir" else {})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(hps, tr, scale_factor=scale, num_steps=WORKDIR_AB_STEPS,
                  params=params, device=DEV, **extra)
            torch.cuda.synchronize()
            walls[way].append(time.perf_counter() - t0)
        ms = {k: [w * 1e3 / WORKDIR_AB_STEPS for w in v]
              for k, v in walls.items()}
        ms_step = {**ms, **{f"{k}_median": float(np.median(v))
                            for k, v in ms.items()}}

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ck.save_checkpoint(workdir("sync"), state_a, scale, hps)
        save_ms = (time.perf_counter() - t0) * 1e3

        eval_step = make_eval_step(model, hps, device=DEV)
        evaluate(state_a.params, va, eval_step)          # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        CF.reset_launch_counts()
        t0 = time.perf_counter()
        ev = evaluate(state_a.params, va, eval_step)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        eval_launches = {k: v for k, v in CF.launch_counts().items() if v}
        want = {k: va.num_eval_batches * v for k, v in per_eval.items()}
        if eval_launches != want:
            raise AssertionError(f"eval sweep launches {eval_launches}, "
                                 f"expected {want}")
        if not all(math.isfinite(v) for v in ev.values()):
            raise AssertionError(f"non-finite eval metrics {ev}")
        log("train_workdir", card=card,
            preset="quickdraw345_dp (bfloat16 compute and residuals)",
            batch=hps.batch_size, max_seq_len=hps.max_seq_len,
            files=len(names), corpus_write_s=write_s, corpus_read_s=read_s,
            sketches={"train": len(tr), "valid": len(va), "test": len(te)},
            scale_factor=scale, steps=WORKDIR_STEPS, launches=launches,
            eval_batches_per_sweep=va.num_eval_batches,
            test_batches=te.num_eval_batches, resume_bitwise=resume_bitwise,
            restore_bitwise=True, served_identical=True,
            serve_launches={"restored": got_launches,
                            "live": live_launches},
            ms_per_step={"steps": WORKDIR_AB_STEPS, "turns":
                         ["plain", "workdir", "workdir", "plain"],
                         **ms_step},
            sync_save_ms=save_ms, checkpoint_bytes=os.path.getsize(path),
            eval_sweep={"batches": va.num_eval_batches, "ms": eval_ms,
                        "ms_per_batch": eval_ms / va.num_eval_batches,
                        "launches": eval_launches,
                        "peak_extra_bytes":
                        torch.cuda.max_memory_allocated() - before,
                        "loss": ev["loss"]},
            per_step=[{k: r[k] for k in ("step", "loss", "grad_norm")}
                      for r in rows],
            seconds=time.perf_counter() - t_phase)
        return (hps, model, va, state_a.params), tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- K steps, and K eval batches, a call: one CUDA graph replay -------------

SPC = 5             # steps_per_call: bench.py's BENCH_SPC default
SPC_STEPS = 20      # each arm's steps a turn, after its warm-up and capture
SPC_REMAINDER = 7   # the remainder run: one K call, then two single steps
SPC_TURNS = (1, SPC, SPC, 1)
FLAGSHIP_PER_STEP = {"fused_lstm_seq_fwd": 2, "fused_lstm_seq_bwd": 2,
                     "fused_ln_lstm_fwd": 1, "fused_ln_lstm_bwd": 1}


def csrc_kernels():
    """The names of the ``__global__`` functions in the port's CUDA
    sources: the hand-written kernels a profile can show."""
    import re

    from sketch_rnn_tpu_torch.ops import _build

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    names = set()
    for f in sorted(_build.CSRC.glob("*.cu*")):
        names.update(pat.findall(f.read_text()))
    return names


def kernel_events(prof, names):
    """``{kernel name: count}`` of the profile's device events whose name
    is one of ``names`` (the hand-written kernels)."""
    import re

    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        hit = [n for n in names if re.search(rf"(?<!\w){n}(?!\w)", e.key)]
        if hit:
            out[hit[0]] = out.get(hit[0], 0) + e.count
    return out


def train_spc(card, workdir_eval):
    """``steps_per_call`` and ``eval_steps_per_call`` on the card, at the
    flagship's full width (bf16, B=100, T=250, synthetic loader). The
    phase builds the single step and the K=5 step once and drives both as
    ``train()`` does without a workdir (key ``fold_in(root_key, step)``,
    K ``next_batch()`` draws stacked a call). Each arm's first two calls
    (at K=5 the first is five eager steps and the capture) give its
    device memory beyond what was live before it; then ``SPC_STEPS`` steps
    an arm in turns (K=1, K=5, K=5, K=1), ms a step and the host's ms a
    step in the feed and inside the step's calls. Two K=1 steps and two
    K=5 calls (replays) are profiled: the device's busy share, events a
    step, and each hand-written kernel's launches: the replays' must be 5x
    the eager steps', which the launch counters count, and the counters
    (added at each replay) must read the flagship's launches a step times
    10. One K=5 replay from a state with moment history against five
    eager single steps with keys ``fold_in(key, i)``: bit for bit, else
    held within the train step's tolerance. ``train()`` at K=5 to
    ``num_steps=7``, the counters zeroed just before and read just after:
    one K call and two single steps, exactly seven steps' launches. Then
    ``workdir_eval`` (``train_workdir``'s model, valid split and trained
    parameters): the 14-batch sweep at ``eval_steps_per_call=8`` (spans 8
    + 6; one sweep first to capture both graphs) and at 1, in turns."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.ops import cuda_lstm as CL
    from sketch_rnn_tpu_torch.train.loop import (evaluate, stack_batches,
                                                 train)
    from sketch_rnn_tpu_torch.train.state import (make_train_state,
                                                  states_equal)
    from sketch_rnn_tpu_torch.train.step import (make_eval_step,
                                                 make_multi_eval_step,
                                                 make_multi_train_step,
                                                 make_train_step,
                                                 replay_window_metrics)
    from sketch_rnn_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    hps1, model, params, loader = setup(train_hps(**dtype_over("bfloat16")))
    hps5 = hps1.replace(steps_per_call=SPC)
    single = make_train_step(model, hps1, device=DEV)
    multi = make_multi_train_step(model, hps5, device=DEV)
    graphed = multi.graphed
    fns = {1: single, SPC: multi}
    root_key = prng.split(prng.key(0), 2)[0]

    host = {}

    def drive(k, steps, state=None):
        """``steps`` steps from ``state`` (the seeded weights' fresh state
        by default) in calls of ``k``; ``(wall s, state)``. ``host`` gets
        the host's seconds in the feed (``next_batch`` and the stack) and
        in the step function's calls (staging, copies in, the launches or
        the replay, until it returns)."""
        state = make_train_state(params) if state is None else state
        metrics = []
        feed_s = call_s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps // k):
            t1 = time.perf_counter()
            batch = (loader.next_batch() if k == 1 else stack_batches(
                [loader.next_batch() for _ in range(k)]))
            t2 = time.perf_counter()
            state, m = fns[k](state, batch, prng.fold_in(root_key,
                                                         state.step))
            feed_s += t2 - t1
            call_s += time.perf_counter() - t2
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host.update(feed_ms_per_step=feed_s * 1e3 / steps,
                    call_ms_per_step=call_s * 1e3 / steps)
        losses = [float(m["loss"]) for m in metrics]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"K={k}: non-finite losses {losses}")
        return wall, state

    def counts():
        return {**CF.launch_counts(), **CL.launch_counts()}

    def reset():
        CF.reset_launch_counts()
        CL.reset_launch_counts()

    # each arm's first two calls: its device memory beyond what was live
    first_s, memory = {}, {}
    for k in (1, SPC):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        first_s[f"k{k}"], st = drive(k, k)
        drive(k, k, st)
        del st
        torch.cuda.synchronize()
        peak_r = torch.cuda.max_memory_reserved() - r0
        peak_a = torch.cuda.max_memory_allocated() - a0
        torch.cuda.empty_cache()
        memory[f"k{k}"] = {
            "peak_reserved_bytes": peak_r, "peak_allocated_bytes": peak_a,
            "held_reserved_bytes": torch.cuda.memory_reserved() - r0,
            "held_allocated_bytes": torch.cuda.memory_allocated() - a0}
    if graphed.captured != 1:
        raise AssertionError(f"{graphed.captured} graphs after the warm-up")

    walls = {k: [] for k in fns}
    hosts = {f"k{k}": [] for k in fns}
    for k in SPC_TURNS:
        walls[k].append(drive(k, SPC_STEPS)[0])
        hosts[f"k{k}"].append(dict(host))
    if graphed.captured != 1:
        raise AssertionError("the turns captured again")
    ms = {f"k{k}": [w * 1e3 / SPC_STEPS for w in v] for k, v in walls.items()}
    med = {f"k{k}_median": float(np.median(v)) for k, v in
           ((k, [w * 1e3 / SPC_STEPS for w in walls[k]]) for k in fns)}

    # two K=1 steps and two K=5 replays profiled, as profile_train reads it
    names = csrc_kernels()
    profiles, ours = {}, {}
    for k, calls in ((1, 2), (SPC, 2)):
        steps = k * calls
        wall = drive(k, steps)[0]
        reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof = drive(k, steps)[0]
        launched = counts()
        want = {n: FLAGSHIP_PER_STEP.get(n, 0) * steps for n in launched}
        if launched != want:
            raise AssertionError(f"K={k}: launch counters {launched}, "
                                 f"expected {want}")
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        ours[k] = kernel_events(prof, names)
        profiles[f"k{k}"] = {
            "steps": steps, "wall_ms": wall * 1e3,
            "profiled_wall_ms": wall_prof * 1e3, "device_ms": device_ms,
            "device_ms_per_step": device_ms / steps,
            "device_busy_share": device_ms / 1e3 / wall,
            "device_events_per_step": sum(e.count for e in events) / steps,
            "kernels": ours[k]}
    # the replays ran, kernel by kernel, five times the two eager steps'
    # launches, which the counters counted one by one
    if (not ours[1] or set(ours[SPC]) != set(ours[1])
            or any(ours[SPC][n] != SPC * c for n, c in ours[1].items())):
        raise AssertionError(f"kernels launched: two K=5 replays "
                             f"{ours[SPC]}, two K=1 steps {ours[1]}")
    if graphed.captured != 1:
        raise AssertionError("the profiled calls captured again")

    # one replay against five eager single steps, from a state with history
    _, state = drive(SPC, SPC)
    batches, key = [loader.next_batch() for _ in range(SPC)], prng.key(21)
    got = multi(state, stack_batches(batches), key)
    st, per = state, []
    for i, b in enumerate(batches):
        st, m = single(st, b, prng.fold_in(key, i))
        per.append(m)
    want = (st, replay_window_metrics(per))
    bitwise = (states_equal(got[0], st) and sorted(got[1]) == sorted(want[1])
               and all(torch.equal(got[1][k], want[1][k]) for k in want[1]))
    bits = {"bitwise": bitwise, "step": state.step}
    if not bitwise:
        bits.update(compare_steps(state, got, want))
        hold_step("K=5 replay vs five eager steps", bits, "bfloat16")
    del state, st, got, want

    # train() at K=5 to step 7: one K call, two single steps
    torch.cuda.synchronize()
    reset()
    st7, rows7 = train(hps5, loader, seed=0, num_steps=SPC_REMAINDER,
                       params=params, device=DEV)
    torch.cuda.synchronize()
    launches = counts()
    want7 = {k: FLAGSHIP_PER_STEP.get(k, 0) * SPC_REMAINDER
             for k in launches}
    if launches != want7:
        raise AssertionError(f"remainder run: launches {launches} "
                             f"(expected {want7})")
    if st7.step != SPC_REMAINDER or [r["step"] for r in rows7] != [0, SPC]:
        raise AssertionError(f"remainder run: step {st7.step}, rows "
                             f"{[r['step'] for r in rows7]}")
    del st7

    # the eval sweep at eval_steps_per_call=8 and 1, in turns
    hps_wd, model_wd, va, wd_params = workdir_eval
    eval_step = make_eval_step(model_wd, hps_wd, device=DEV)
    eval_multi = (make_multi_eval_step(model_wd, hps_wd, device=DEV),
                  hps_wd.eval_steps_per_call)
    if (va.num_eval_batches, eval_multi[1]) != (14, 8):
        raise AssertionError(f"{va.num_eval_batches} eval batches at "
                             f"eval_steps_per_call={eval_multi[1]}")
    eval_graphs = eval_multi[0].graphed
    t0 = time.perf_counter()
    evaluate(wd_params, va, eval_step, multi=eval_multi)
    torch.cuda.synchronize()
    eval_first_ms = (time.perf_counter() - t0) * 1e3
    sweeps = {8: [], 1: []}
    results = {}
    for k in (8, 1, 1, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[k] = evaluate(wd_params, va, eval_step,
                              multi=eval_multi if k == 8 else None)
        torch.cuda.synchronize()
        sweeps[k].append((time.perf_counter() - t0) * 1e3)
    if eval_graphs.captured != 2:
        raise AssertionError(f"eval graphs: {eval_graphs.captured}, "
                             f"expected 2 (spans 8 and 6)")
    eval_bitwise = results[8] == results[1]
    if not eval_bitwise:
        gaps = {k: abs(results[8][k] - results[1][k])
                / max(abs(results[1][k]), 1e-30) for k in results[1]}
        if max(gaps.values()) > STEP_TOL["bfloat16"][0]:
            raise AssertionError(f"eval at 8 vs 1: relative gaps {gaps}")
    log("train_spc", card=card,
        preset="quickdraw345_dp (bfloat16 compute and residuals)",
        batch=hps1.batch_size, max_seq_len=hps1.max_seq_len,
        steps_per_call=SPC, steps_per_turn=SPC_STEPS,
        turns=[f"k{k}" for k in SPC_TURNS],
        ms_per_step={**ms, **med,
                     "k1_over_k5": med["k1_median"] / med[f"k{SPC}_median"]},
        host_ms_per_step=hosts,
        first_call_s=first_s, capture_s=graphed.capture_seconds,
        memory=memory, profile=profiles, replay_vs_eager=bits,
        remainder={"num_steps": SPC_REMAINDER, "launches": launches,
                   "rows": [r["step"] for r in rows7]},
        eval_sweep={"batches": va.num_eval_batches, "spans": [8, 6],
                    "first_sweep_ms": eval_first_ms,
                    "turns": ["k8", "k1", "k1", "k8"],
                    "ms": {f"k{k}": v for k, v in sweeps.items()},
                    **{f"k{k}_median_ms": float(np.median(v))
                       for k, v in sweeps.items()},
                    "capture_s": eval_graphs.capture_seconds,
                    "bitwise": eval_bitwise, "loss": results[8]["loss"]},
        seconds=time.perf_counter() - t_phase)


# -- the input pipeline: transfer dtypes and the prefetch thread ------------

FEED_ARMS = {"f32_d0": ("float32", 0), "f32_d2": ("float32", 2),
             "i16_d2": ("int16", 2)}
FEED_TURNS = ("f32_d0", "f32_d2", "i16_d2", "i16_d2", "f32_d2", "f32_d0")
FEED_CALLS = {1: 6, SPC: 3}     # timed calls a turn, after FEED_WARM calls
FEED_WARM = 1       # the step functions capture once, before the turns


def train_feed(card, tr):
    """``data/prefetch.py`` on the card at the flagship's full width (bf16,
    B=100, T=250), on two corpora: ``synthetic``, bench.py's (the
    synthetic loader over B sketches at ``integer_grid=255``, unaugmented)
    and ``npz``, ``train_workdir``'s augmented train split (``tr``, its
    train loader, drawn here by fresh loaders over the same strokes).

    At K=5 and K=1 the phase drives one single and one K=5 step function
    (``train()``'s key per call) from feeders of three arms in turns
    (FEED_TURNS): ``transfer_dtype=float32`` at depth 0 (the synchronous
    feed), float32 at depth 2 (``train()``'s default) and ``int16`` at
    depth 2 (bench.py's defaults), each turn from the
    seeded weights' fresh state and a fresh loader, ``FEED_WARM`` calls,
    then ``FEED_CALLS`` timed: ms a step, the producer's host ms a batch by
    part (the loader's draws with the int16 quantization, the bf16 cast,
    pinning, issuing the copies; the quantization also timed alone), the
    consumer's wait in ``get()`` a call and its host ms inside the step
    function's calls. On the synthetic corpus every turn must end on the
    same state bit for bit (int16 is exact there, and the capture of the
    int16 graph happens while the producer runs). Each arm's first turn
    is followed, on its feeder, by two calls timed and two profiled: the
    device's busy share. At depth 2, the reserved memory a full queue
    adds (a feeder filled with no step running). Checks: one eager int16
    step bit for bit the float32 step, and one bfloat16-transfer step
    finite and within STEP_TOL of it, from a state with history;
    ``train()`` at its default depth 2 and int16, K=5, to step 7 with the
    training kernels' counters zeroed just before and read just after,
    exactly seven steps' launches, ending on the state of ``train()`` at
    float32 and depth 0 bit for bit."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sketch_rnn_tpu_torch.data.loader import (DataLoader, quantize_int16,
                                                  synthetic_loader)
    from sketch_rnn_tpu_torch.data.prefetch import prefetch_batches
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.ops import cuda_lstm as CL
    from sketch_rnn_tpu_torch.train.loop import train
    from sketch_rnn_tpu_torch.train.state import (make_train_state,
                                                  states_equal)
    from sketch_rnn_tpu_torch.train.step import (make_multi_train_step,
                                                 make_train_step)
    from sketch_rnn_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    hps = train_hps(**dtype_over("bfloat16"))
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(0), device=DEV)

    def npz_loader():
        loader = DataLoader(tr.strokes, hps, labels=tr.labels, augment=True,
                            seed=1)
        loader.scale_factor = tr.scale_factor     # strokes already normal
        return loader

    corpora = {
        "synthetic": lambda: synthetic_loader(
            hps, num=hps.batch_size, seed=0, integer_grid=255.0)[0],
        "npz": npz_loader}
    fns = {1: make_train_step(model, hps, device=DEV),
           SPC: make_multi_train_step(
               model, hps.replace(steps_per_call=SPC), device=DEV)}
    root_key = prng.split(prng.key(0), 2)[0]

    def feed_turn(corpus, k, arm, calls, state=None, after=None):
        """``FEED_WARM`` calls, then ``calls`` timed calls of K=``k`` from
        a fresh feeder of ``arm`` over a fresh ``corpus`` loader;
        ``after(feeder, state)`` runs on the open feeder then. Returns
        ``(wall s, state, the feeder's timings over the timed calls,
        after's result)``."""
        dtype, depth = FEED_ARMS[arm]
        state = make_train_state(params) if state is None else state
        feeder = prefetch_batches(corpora[corpus](), DEV, depth, stack=k,
                                  transfer_dtype=dtype)
        losses = []
        inside = [0.0]

        def call(st):
            batch = feeder.get()
            t0 = time.perf_counter()
            st, m = fns[k](st, batch, prng.fold_in(root_key, st.step))
            inside[0] += time.perf_counter() - t0
            losses.append(m["loss"])
            return st

        try:
            for _ in range(FEED_WARM):
                state = call(state)
            torch.cuda.synchronize()
            snap = lambda: dict(feeder.timings, call_s=inside[0])
            t0_feed = snap()
            t0 = time.perf_counter()
            for _ in range(calls):
                state = call(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            timings = {n: v - t0_feed[n] for n, v in snap().items()}
            extra = after(feeder, state) if after is not None else None
        finally:
            feeder.close()
        losses = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{corpus} K={k} {arm}: losses {losses}")
        return wall, state, timings, extra

    def per_batch(t, k):
        n = t["batches"] * k
        return {"assemble_ms": t["assemble_s"] * 1e3 / n,
                "cast_ms": t["cast_s"] * 1e3 / n,
                "pin_ms": t["pin_s"] * 1e3 / n,
                "copy_ms": t["copy_s"] * 1e3 / n,
                "wait_ms_per_call": t["wait_s"] * 1e3 / t["gets"],
                "call_ms_per_call": t["call_s"] * 1e3 / t["gets"]}

    def profiled(feeder, state, k):
        """Two calls timed, then two profiled, on the open feeder."""
        def two(st):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                st, _ = fns[k](st, feeder.get(),
                               prng.fold_in(root_key, st.step))
            torch.cuda.synchronize()
            return time.perf_counter() - t0, st

        wall, state = two(state)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof, _ = two(state)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        return {"calls": 2, "steps": 2 * k, "wall_ms": wall * 1e3,
                "profiled_wall_ms": wall_prof * 1e3, "device_ms": device_ms,
                "device_busy_share": device_ms / 1e3 / wall}

    def queue_memory(corpus, k, arm):
        """The reserved memory that a depth-2 feeder's full queue adds (the
        cache emptied first; no step runs), and the bytes of its batches:
        the queue holds ``depth`` batches, the producer one more."""
        dtype, depth = FEED_ARMS[arm]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        with prefetch_batches(corpora[corpus](), DEV, depth, stack=k,
                              transfer_dtype=dtype) as feeder:
            t0 = time.perf_counter()
            while feeder.timings["batches"] < depth + 1:
                if time.perf_counter() - t0 > 60:
                    raise AssertionError("the producer did not fill its "
                                         "queue")
                time.sleep(0.01)
            time.sleep(0.1)            # the last batch's copies issued
            torch.cuda.synchronize()
            held = torch.cuda.memory_reserved() - r0
        b = ({"float32": 4, "int16": 2}[dtype] * hps.batch_size
             * (hps.max_seq_len + 1) * 5
             + 4 * hps.batch_size * (3 if dtype == "int16" else 2))
        return {"queue_reserved_bytes": held,
                "queue_batch_bytes": (depth + 1) * k * b}

    results = {}
    for corpus in corpora:
        for k in (SPC, 1):
            calls = FEED_CALLS[k]
            walls = {arm: [] for arm in FEED_ARMS}
            feed = {arm: [] for arm in FEED_ARMS}
            ends, prof = [], {}
            for arm in FEED_TURNS:
                # each arm's first turn is profiled after its timed calls
                first = arm not in prof
                wall, state, t, p = feed_turn(
                    corpus, k, arm, calls,
                    after=(lambda feeder, st: profiled(feeder, st, k))
                    if first else None)
                walls[arm].append(wall * 1e3 / (calls * k))
                feed[arm].append(per_batch(t, k))
                ends.append(state)
                if first:
                    prof[arm] = p
            for arm, (_, depth) in FEED_ARMS.items():
                if depth:
                    prof[arm].update(queue_memory(corpus, k, arm))
            if corpus == "synthetic" and not all(
                    states_equal(ends[0], s) for s in ends[1:]):
                raise AssertionError(f"synthetic K={k}: the turns do not "
                                     f"all end on one state")
            del ends, state
            med = {arm: float(np.median(v)) for arm, v in walls.items()}
            results[f"{corpus}_k{k}"] = {
                "ms_per_step": {**walls, **{f"{a}_median": v
                                            for a, v in med.items()},
                                **{f"f32_d0_over_{a}": med["f32_d0"] / v
                                   for a, v in med.items()
                                   if a != "f32_d0"}},
                "host_per_batch": feed, "profile": prof}

    # the int16 quantization alone, on float32 batches of each corpus
    quantize_ms = {}
    for corpus, make in corpora.items():
        loader = make()
        batches = [loader.next_batch()["strokes"] for _ in range(10)]
        t0 = time.perf_counter()
        for b in batches:
            quantize_int16(b, loader.scale_factor)
        quantize_ms[corpus] = (time.perf_counter() - t0) * 1e3 / len(batches)

    # one eager step at int16 and at bfloat16 against the float32 step,
    # from a state with history
    _, state, _, _ = feed_turn("synthetic", 1, "f32_d0", 2)
    key = prng.fold_in(prng.key(31), state.step)
    steps = {}
    for dtype in ("float32", "int16", "bfloat16"):
        with prefetch_batches(corpora["synthetic"](), DEV, 0,
                              transfer_dtype=dtype) as feeder:
            batch = feeder.get()
        if batch["strokes"].dtype != getattr(torch, dtype):
            raise AssertionError(f"{dtype} feed gave {batch['strokes'].dtype}")
        steps[dtype] = fns[1](state, batch, key)
    i16_bitwise = (states_equal(steps["int16"][0], steps["float32"][0])
                   and all(torch.equal(steps["int16"][1][n],
                                       steps["float32"][1][n])
                           for n in steps["float32"][1]))
    if not i16_bitwise:
        raise AssertionError("the int16 step is not the float32 step bit "
                             "for bit")
    bf16_gaps = compare_steps(state, steps["bfloat16"], steps["float32"])
    if not all(math.isfinite(float(v)) for v in steps["bfloat16"][1].values()):
        raise AssertionError("non-finite bfloat16-transfer step")
    hold_step("bfloat16 transfer vs float32", bf16_gaps, "bfloat16")
    del state, steps

    # train() at its defaults (depth 2) with int16, K=5, to step 7
    hps7 = hps.replace(steps_per_call=SPC)
    if (hps7.prefetch_depth, hps7.transfer_dtype) != (2, "float32"):
        raise AssertionError("HParams' defaults moved")
    ref7, _ = train(hps7.replace(prefetch_depth=0), corpora["synthetic"](),
                    seed=0, num_steps=SPC_REMAINDER, params=params,
                    device=DEV)
    torch.cuda.synchronize()
    CF.reset_launch_counts()
    CL.reset_launch_counts()
    st7, rows7 = train(hps7.replace(transfer_dtype="int16"),
                       corpora["synthetic"](), seed=0,
                       num_steps=SPC_REMAINDER, params=params, device=DEV)
    torch.cuda.synchronize()
    launches = {**CF.launch_counts(), **CL.launch_counts()}
    want = {n: FLAGSHIP_PER_STEP.get(n, 0) * SPC_REMAINDER for n in launches}
    if launches != want:
        raise AssertionError(f"train() at int16, depth 2: launches "
                             f"{launches} (expected {want})")
    if [r["step"] for r in rows7] != [0, SPC] or st7.step != SPC_REMAINDER:
        raise AssertionError(f"train() at int16: rows {rows7}")
    if not states_equal(st7, ref7):
        raise AssertionError("train() at int16 and depth 2 does not end on "
                             "train() at float32 and depth 0 bit for bit")
    log("train_feed", card=card,
        preset="quickdraw345_dp (bfloat16 compute and residuals)",
        batch=hps.batch_size, max_seq_len=hps.max_seq_len,
        arms={a: {"transfer_dtype": d, "prefetch_depth": p}
              for a, (d, p) in FEED_ARMS.items()},
        turns=list(FEED_TURNS), warm_calls=FEED_WARM,
        timed_calls={f"k{k}": c for k, c in FEED_CALLS.items()},
        corpora={"synthetic": f"synthetic_loader, {hps.batch_size} "
                              f"sketches, integer_grid=255, unaugmented",
                 "npz": f"train_workdir's train split, {len(tr)} sketches, "
                        f"augmented"},
        cells=results, quantize_ms_per_batch=quantize_ms,
        synthetic_turns_bitwise=True, int16_step_bitwise=i16_bitwise,
        bf16_step_vs_float32=bf16_gaps,
        train_int16_depth2={"steps_per_call": SPC,
                            "num_steps": SPC_REMAINDER, "launches": launches,
                            "rows": [r["step"] for r in rows7],
                            "bitwise_float32_depth0": True},
        seconds=time.perf_counter() - t_phase)


# -- the hoisted LSTM, the probes, the plain training path -----------------

# one step of the plain cell path (fused_rnn=false) against the same step
# through the kernels (fused_rnn=true), recurrent dropout off: the same
# function summed in other orders (cuBLAS products and torch's gate ops
# against the kernels' chains), float32 rounding carried through 250
# steps and Adam's normalisation. Loss and grad norm relative, the
# parameter update absolute (lr = 1e-3).
PATH_TOL = (1e-4, 1e-5)
PLAIN_STEPS = 2
# the probes: their kernels against the plain versions, then each probe's
# A/B, at the probes' own shape with K calls per timing
PROBE = dict(t=250, b=4096, h=256, d=5, k=4, reps=3)


def vae_decoder_inputs():
    """The ``vae`` preset's decoder operands at full width (B=100, T=250,
    H=512, Nz=128): model, parameters, the teacher-forcing inputs and
    targets of one synthetic batch, a seeded z, and recurrent-dropout
    masks from ``make_dropout_masks`` at keep 0.9."""
    import torch

    from sketch_rnn_tpu_torch.ops.rnn import make_dropout_masks
    from sketch_rnn_tpu_torch.train.step import batch_to_device
    from sketch_rnn_tpu_torch.utils import prng

    hps, model, params, loader = setup(vae_hps())
    batch = batch_to_device(loader.next_batch(), DEV)
    strokes = batch["strokes"].transpose(0, 1).float()
    b, t, h = hps.batch_size, hps.max_seq_len, hps.dec_rnn_size
    z = torch.randn((b, hps.z_size),
                    generator=torch.Generator().manual_seed(19)).to(DEV)
    masks = make_dropout_masks(prng.key(21).to(DEV), KEEP, t, b, h)
    return (hps, model, params, strokes[:-1].contiguous(),
            strokes[1:].contiguous(), z, masks)


def check_hoisted_lstm(rows):
    """lstm_seq forward and backward (``csrc/lstm_seq.cu``) at the
    ``vae`` decoder's full width: ``xp = LSTMCell.precompute_inputs`` over
    ``[x; z]`` (D=133), the decoder's nonzero initial carry, masks from
    ``make_dropout_masks`` at keep 0.9, seeded cotangents. Every output
    within FUSED_TOL of the plain version (relative to its largest
    magnitude), identical run to run. cuDNN's LSTM over the same ``[x;
    z]`` is the yardstick; it also computes the input projection, which
    lstm_seq takes precomputed."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_lstm as CL

    hps, model, params, x_in, _, z, masks = vae_decoder_inputs()
    cell, dp = model.dec, params["dec"]
    t, b, _ = x_in.shape
    h = cell.hidden_size
    x_full = torch.cat([x_in, z[None].expand(t, b, -1)], -1)
    xp = cell.precompute_inputs(dp, x_full).contiguous()
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, b))
    g = torch.Generator().manual_seed(23)
    cot = lambda *s: (0.01 * torch.randn(s, generator=g)).to(DEV)
    dhs, dcT, dhT = cot(t, b, h), cot(b, h), cot(b, h)
    wh, fb, dt = dp["wh"], cell.forget_bias, "float32"
    fwd = lambda: CL.lstm_seq_fwd(xp, wh, c0, h0, fb, masks)
    fwd_plain = lambda: CL.lstm_seq_fwd_plain(xp, wh, c0, h0, fb, masks)
    out = fwd()
    hs, _, _, gates, cs = out
    h_prev = torch.cat([h0[None], hs[:-1]])
    bwd = lambda: CL.lstm_seq_bwd(wh, gates, cs, hs, h0, masks, dhs, dcT,
                                  dhT)
    bwd_plain = lambda: CL.lstm_seq_bwd_plain(wh, gates, cs, h_prev, masks,
                                              dhs, dcT, dhT)
    grads = bwd()
    flops = 2 * t * b * h * 4 * h
    for name, run, plain, got, names, iters, fl, moved in (
            ("lstm_seq_fwd", fwd, fwd_plain, out,
             ("hs", "cT", "hT", "gates", "cs"), 10, flops,
             nbytes(xp, wh, c0, h0, masks, *out)),
            ("lstm_seq_bwd", bwd, bwd_plain, grads,
             ("dxp", "dwh", "dc0", "dh0"), 5, 2 * flops,
             nbytes(wh, gates, cs, hs, h0, masks, dhs, dcT, dhT, *grads))):
        again = run()
        torch.cuda.synchronize()
        ab, rel, per = rel_errs(names, got, plain())
        det = all(torch.equal(x, y) for x, y in zip(got, again))
        if not (rel <= FUSED_TOL[dt] and det):
            raise AssertionError(f"{name}: rel err {rel} (tol "
                                 f"{FUSED_TOL[dt]}), per output {per}, "
                                 f"deterministic {det}")
        bms, by = bound_ms(fl, moved, dt)
        rows[name] = {dt: {"err": ab, "rel_err": rel, "errs": per,
                           "deterministic": det,
                           "ms": cuda_ms(run, iters),
                           "plain_ms": cuda_ms(plain, 2), "bound_ms": bms,
                           "bound_by": by, "library_ms": None}}
        log("kernel", name=name, dtype=dt, T=t, B=b, H=h, tol=FUSED_TOL[dt],
            flops=fl, bytes=moved, **rows[name][dt])

    lstm = cudnn_lstm(dp["wx"], wh, dp["b"], fb, torch.float32)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (x_full, h0, c0)]
    lib_fwd, lib_bwd, lib_out = library_times(lstm, *leaves, dhs, leaves)
    lib_err = float((lib_out - CL.lstm_seq_fwd(xp, wh, c0, h0, fb)[0])
                    .abs().max())
    if not lib_err <= FUSED_TOL[dt]:
        raise AssertionError(f"cuDNN LSTM vs lstm_seq: {lib_err}")
    rows["lstm_seq_fwd"][dt]["library_ms"] = lib_fwd
    rows["lstm_seq_bwd"][dt]["library_ms"] = lib_bwd
    log("kernel_library", name="lstm_seq", dtype=dt,
        library="torch.nn.LSTM (cuDNN, float32) over [x; z], D=133, TF32 "
                "off; it also computes the input projection that lstm_seq "
                "takes precomputed", fwd_ms=lib_fwd, bwd_ms=lib_bwd,
        err_vs_kernel_no_dropout=lib_err)
    inp = (xp, wh, c0, h0, fb, masks, dhs, dcT, dhT)
    lstm_seq_ab(inp, rows, f"B={b}, T={t}")
    t_w, b_w = LSTM_SEQ_AB_WINDOWS
    wide = [tiled_rows(x[:t_w], b_w, 1) for x in (xp, masks, dhs)]
    wide_carries = [tiled_rows(x, b_w, 0) for x in (c0, h0, dcT, dhT)]
    lstm_seq_ab((wide[0], wh, *wide_carries[:2], fb, wide[1], wide[2],
                 *wide_carries[2:]),
                {n: {dt: {}} for n in ("lstm_seq_fwd", "lstm_seq_bwd")},
                f"B={b_w}, T={t_w}")
    del wide, wide_carries
    torch.cuda.empty_cache()


# lstm_seq_ab's second shape (T, B): the backward's loop runs over windows
# of rows there (H=512 at float32 holds ~904 rows a launch)
LSTM_SEQ_AB_WINDOWS = (100, 4096)
LSTM_SEQ_BWD_STAGES = ("loop", "weight_pass")


def lstm_seq_ab(inp, rows, label):
    """``srt_lstm_seq_fwd`` / ``srt_lstm_seq_bwd`` (the loops of
    ``csrc/lstm_loops.cuh``) against the row-block design they replaced,
    ``srt_lstm_seq_fwd_rowblock`` / ``srt_lstm_seq_bwd_rowblock``, on the
    inputs ``(xp, wh, c0, h0, forget_bias, masks, dhs, dcT, dhT)``: the
    forward bit for bit, then both timed in turns with CUDA events (new,
    old, old, new; AB_REPS turns, medians); the backward over the new
    forward's reserve through ``bwd_ab`` (within FUSED_TOL, identical run
    to run, the split into loop and weight pass). Uncounted launches. The
    records go to ``rows`` under ``ab``."""
    import statistics

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_lstm as CL

    xp, wh, c0, h0, fb, masks, dhs, dcT, dhT = inp
    run, outs = CL.lstm_seq_fwd_entries(xp, wh, c0, h0, fb, masks)
    names = ("hs", "cT", "hT", "gates", "cs")
    snap = lambda: [o.clone() for o in outs]
    run("srt_lstm_seq_fwd")
    new = snap()
    run("srt_lstm_seq_fwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(new, old)):
        ab, rel, per = rel_errs(names, new, old)
        raise AssertionError(f"lstm_seq_fwd [{label}]: srt_lstm_seq_fwd is "
                             f"not bitwise the row-block design: rel err "
                             f"{rel}, per output {per}")
    del old
    times, _ = ab_turns({"new": lambda: run("srt_lstm_seq_fwd"),
                         "old": lambda: run("srt_lstm_seq_fwd_rowblock")})
    res = {"shape": label, "ms": statistics.median(times["new"]),
           "rowblock_ms": statistics.median(times["old"]),
           "new_ms_all": times["new"], "rowblock_ms_all": times["old"],
           "bitwise_rowblock": True, "ab_phase": "lstm_seq_ab"}
    res["speedup"] = res["rowblock_ms"] / res["ms"]
    rows["lstm_seq_fwd"]["float32"]["ab"] = res
    log("lstm_seq_ab", name="lstm_seq_fwd", dtype="float32", reps=AB_REPS,
        **res)
    hs, _, _, gates, cs = new
    del run, outs
    brun, bouts = CL.lstm_seq_bwd_entries(wh, gates, cs, hs, h0, masks, dhs,
                                          dcT, dhT)
    bwd_ab("lstm_seq_ab", "lstm_seq_bwd", "float32", "srt_lstm_seq_bwd",
           LSTM_SEQ_BWD_STAGES, brun, bouts, ("dxp", "dwh", "dc0", "dh0"),
           rows, label=label)


def hoisted_main_path(card):
    """lstm_seq's main path: the ``vae`` decoder's teacher-forced loss and
    its gradients in the cuDNN layout at full width. The inputs of all
    steps are projected at once (``LSTMCell.precompute_inputs`` over
    ``[x; z]``), ``ops/cuda_lstm.lstm_seq`` (the public autograd
    Function) runs the recurrence from the decoder's initial carry with
    masks from ``make_dropout_masks``, then the output projection and the
    MDN reconstruction loss; the gradients of the decoder, output and
    initial-state weights. lstm_seq's launch counters are zeroed just
    before and read just after (one forward, one backward). The same loss
    through the plain hoisted path, ``run_rnn(hoist=True)`` with the same
    masks, must agree within FUSED_TOL."""
    import math

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_lstm as CL
    from sketch_rnn_tpu_torch.ops import mdn
    from sketch_rnn_tpu_torch.ops.rnn import run_rnn

    hps, model, params, x_in, x_tgt, z, masks = vae_decoder_inputs()
    cell = model.dec
    t, b, _ = x_in.shape

    def loss_and_grads(kernel):
        dec = {k: v.detach().requires_grad_(True)
               for k, v in params["dec"].items()}
        top = {k: params[k].detach().requires_grad_(True)
               for k in ("out_w", "out_b", "dec_init_w", "dec_init_b")}
        p = {**params, **top, "dec": dec}
        c0, h0 = model.decoder_initial_carry(p, z, b)
        if kernel:
            x_full = torch.cat([x_in, z[None].expand(t, b, -1)], -1)
            hs, _ = CL.lstm_seq(cell.precompute_inputs(dec, x_full),
                                dec["wh"], c0.contiguous(), h0.contiguous(),
                                cell.forget_bias, masks)
        else:
            _, hs = run_rnn(cell, dec, x_in, (c0, h0), rdrop_masks=masks,
                            hoist=True, x_extra=z)
        mp = mdn.get_mixture_params(hs @ p["out_w"] + p["out_b"],
                                    hps.num_mixture)
        total = sum(mdn.reconstruction_loss(mp, x_tgt, hps.max_seq_len))
        leaves = [*dec.values(), *top.values()]
        return total.detach(), torch.autograd.grad(total, leaves)

    def timed(kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loss_and_grads(kernel)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed(True)                        # warm-up
    CL.reset_launch_counts()
    (loss_k, grads_k), wall_k = timed(True)
    launches = CL.launch_counts()
    want = {"lstm_seq_fwd": 1, "lstm_seq_bwd": 1}
    if launches != want:
        raise AssertionError(f"lstm_seq launches {launches}, expected {want}")
    (loss_p, grads_p), wall_p = timed(False)
    loss_rel = abs(float(loss_k - loss_p)) / abs(float(loss_p))
    grad_rel = max(float((a - c).abs().max()) / max(float(c.abs().max()),
                                                    1e-30)
                   for a, c in zip(grads_k, grads_p))
    if not (math.isfinite(float(loss_k)) and loss_rel <= FUSED_TOL["float32"]
            and grad_rel <= FUSED_TOL["float32"]):
        raise AssertionError(f"hoisted path: loss {loss_k} vs {loss_p}, "
                             f"grad rel err {grad_rel}")
    log("hoisted_lstm", card=card,
        preset=f"vae decoder (lstm, H={cell.hidden_size})",
        batch=b, max_seq_len=t, launches=launches, loss=float(loss_k),
        loss_rel_err=loss_rel, grad_rel_err=grad_rel, tol=FUSED_TOL[
            "float32"], kernel_wall_ms=wall_k * 1e3,
        plain_hoisted_wall_ms=wall_p * 1e3)
    return launches


def cudnn_bilstm(w, dtype):
    """A bidirectional ``torch.nn.LSTM`` (cuDNN) holding the dual probe's
    two directions, in ``dtype``: a yardstick only."""
    import torch

    fwd = cudnn_lstm(w["wx_f"].float(), w["wh_f"].float(), w["b_f"], 1.0,
                     dtype)
    bwd = cudnn_lstm(w["wx_b"].float(), w["wh_b"].float(), w["b_b"], 1.0,
                     dtype)
    d, g4 = w["wx_f"].shape
    bi = torch.nn.LSTM(d, g4 // 4, bidirectional=True).to(DEV).to(dtype)
    with torch.no_grad():
        for suffix, src in (("", fwd), ("_reverse", bwd)):
            for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(bi, f"{n}_l0{suffix}").copy_(getattr(src, f"{n}_l0"))
    bi.flatten_parameters()
    return bi


def check_probes(card, rows):
    """The two probe kernels (``csrc/probe_seq.cu``) at the probes' shape,
    B=4096, T=250, H=256, D=5, with bfloat16 weights (the encoder's
    initialisation) and residuals. Each against its plain version within
    FUSED_TOL["bfloat16"] relative to each output's largest magnitude and
    identical run to run; the dual forward bit for bit two launches of
    the float32-gates arm of ``seq_fwd`` (the same loop over one
    direction), and both within FUSED_TOL of the production
    ``fused_lstm_seq`` forward. The plain versions are timed on the same
    inputs, cuDNN's bidirectional (dual) and unidirectional (bf16 gates)
    LSTM forward, bfloat16, as the yardsticks. Then ``probe_seq_ab`` (each
    loop against the row-block design), and each probe's A/B (``run_probe``,
    its main path) with K=4 calls per timing and 3 reps, the probes' launch
    counters zeroed just before and read just after, its record on one
    line, and the dual probe's production arm on its own line."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.ops.cells import LSTMCell
    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as PB
    from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as PD

    dt, tol, bf = "bfloat16", FUSED_TOL["bfloat16"], torch.bfloat16
    t, b, h, d = PROBE["t"], PROBE["b"], PROBE["h"], PROBE["d"]
    dnames, snames = ("hs_f", "cs_f", "hs_b", "cs_b"), ("hs", "cs")

    def near(name, got, want, names):
        ab, rel, per = rel_errs(names, got, want)
        if not rel <= tol:
            raise AssertionError(f"{name}: rel err {rel} (tol {tol}), per "
                                 f"output {per}")
        return {"err": ab, "rel_err": rel, "errs": per}

    def hold(name, run, plain, names):
        got, again = run(), run()
        torch.cuda.synchronize()
        det = all(torch.equal(x, y) for x, y in zip(got, again))
        if not det:
            raise AssertionError(f"{name}: two runs differ")
        return got, dict(near(name, got, plain(), names), deterministic=det)

    # the checks take the encoder's own initialisation (orthogonal wh):
    # the probes' N(0, 0.1) weights make the recurrence chaotic at H=256,
    # so a float32 rounding gap grows to O(1) over 250 steps whatever the
    # kernel (measured on the CPU with the plain versions)
    zc = torch.zeros((b, h), device=DEV)
    xs, xs_rev, _ = PD.probe_inputs(t, b, h, d, 1, DEV)
    enc = [LSTMCell(h).init_params(torch.Generator().manual_seed(s), d)
           for s in (31, 32)]
    w = {f"{n}_{k}": (p[n].to(bf) if n != "b" else p[n]).to(DEV)
         for k, p in zip("fb", enc) for n in ("wx", "b", "wh")}
    dargs = (xs[0], xs_rev[0], w["wx_f"], w["b_f"], w["wh_f"], w["wx_b"],
             w["b_b"], w["wh_b"])
    sargs = (xs[0], w["wx_f"], w["b_f"], w["wh_f"])
    bargs = (xs_rev[0], w["wx_b"], w["b_b"], w["wh_b"])
    dual_plain = lambda: PD.dual_seq_fwd_plain(*dargs)
    seq_plain = lambda: PB.seq_fwd_plain(*sargs, True)
    prod = (*CF.lstm_seq_fwd(*sargs, zc, zc, residual_dtype=bf),
            *CF.lstm_seq_fwd(*bargs, zc, zc, residual_dtype=bf))
    out_d, r_dual = hold("dual_seq_fwd", lambda: PD.dual_seq_fwd(*dargs),
                         dual_plain, dnames)
    pair = (*PB.seq_fwd(*sargs, False), *PB.seq_fwd(*bargs, False))
    if not all(torch.equal(x, y) for x, y in zip(out_d, pair)):
        raise AssertionError("dual_seq_fwd is not bitwise two seq_fwd "
                             "(float32 gates) launches")
    r_dual["bitwise_seq_fwd_pair"] = True
    r_dual["production"] = near("dual_seq_fwd vs fused_lstm_seq", out_d,
                                prod, dnames)
    del pair
    out_f, r_f32 = hold("seq_fwd(bf16_gates=False)",
                        lambda: PB.seq_fwd(*sargs, False),
                        lambda: PB.seq_fwd_plain(*sargs, False), snames)
    r_f32["production"] = near("seq_fwd(bf16_gates=False) vs "
                               "fused_lstm_seq", out_f, prod[:2], snames)
    del out_f, prod
    out_s, r_seq = hold("seq_fwd(bf16_gates=True)",
                        lambda: PB.seq_fwd(*sargs, True), seq_plain, snames)
    r_seq["f32_gates_arm"] = r_f32

    one_dir = 2 * t * b * (d + h) * 4 * h
    x_bf = xs[0].to(bf)
    with torch.no_grad():
        bi = cudnn_bilstm(w, bf)
        uni = cudnn_lstm(w["wx_f"].float(), w["wh_f"].float(), w["b_f"], 1.0,
                         bf)
        lib = {"dual_seq_fwd": cuda_ms(lambda: bi(x_bf), 5),
               "seq_fwd_bf16_gates": cuda_ms(lambda: uni(x_bf), 5)}
    for name, r, plain, fl, moved in (
            ("dual_seq_fwd", r_dual, dual_plain, 2 * one_dir,
             nbytes(*dargs, *out_d)),
            ("seq_fwd_bf16_gates", r_seq, seq_plain, one_dir,
             nbytes(*sargs, *out_s))):
        bms, by = bound_ms(fl, moved, dt)
        r.update(plain_ms=cuda_ms(plain, 1), bound_ms=bms, bound_by=by,
                 library_ms=lib[name])
        rows[name] = {dt: r}
        log("kernel", name=name, dtype=dt, T=t, B=b, H=h, D=d, tol=tol,
            flops=fl, bytes=moved, **r,
            library=f"torch.nn.LSTM (cuDNN, bfloat16"
                    f"{', bidirectional' if name == 'dual_seq_fwd' else ''})"
                    f" forward")
    del out_d, out_s, bi, uni
    torch.cuda.empty_cache()
    probe_seq_ab(rows, dargs, sargs)

    # the A/B main paths at the probes' shape and weights
    launches = {}
    for name, mod, counter, ms in (
            ("dual_seq_fwd", PD, "dual_seq_fwd", "dual_ms"),
            ("seq_fwd_bf16_gates", PB, "seq_fwd", "bf16_gates_ms")):
        mod.reset_launch_counts()
        CF.reset_launch_counts()
        rec = mod.run_probe(device=DEV, **PROBE)
        launches[name] = mod.launch_counts()[counter]
        if launches[name] == 0:
            raise AssertionError(f"{name}: the probe launched no kernel")
        if rec.get("bitwise_parity") is False:
            raise AssertionError(f"{name}: the dual launch is not bitwise "
                                 f"two same-design launches")
        log(rec["kind"], card=card, launches=launches[name],
            fused_lstm_seq_fwd_launches=CF.launch_counts()[
                "fused_lstm_seq_fwd"], record=rec)
        rows[name][dt].update(ms=rec[ms], record=rec)
        if name == "dual_seq_fwd":   # the production arm: bench.py's encoder
            log("encoder_fwd", kernel="fused_lstm_seq_fwd", dtype=dt, T=t,
                B=b, H=h, D=d, ms=rec["single_2calls_ms"] / 2, card=card,
                source="probe_dual_encoder.run_probe single_2calls_ms / 2")
    return launches


# the probe loop against the row-block design it replaced, at the probes'
# shape: turns of (new, old, old, new)
PROBE_AB_REPS = 3


def probe_seq_ab(rows, dargs, sargs):
    """``srt_dual_seq_fwd`` and ``srt_seq_fwd`` (both gate forms), the
    persistent tensor-core loop, against the row-block entries on the
    same inputs (``check_probes``'): outputs within FUSED_TOL["bfloat16"]
    of each other, then both timed in PROBE_AB_REPS turns (medians), each
    line with the row's ``library_ms`` and ``bound_ms``. Uncounted
    launches."""
    import statistics

    import torch

    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as PB
    from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as PD

    dt, tol = "bfloat16", FUSED_TOL["bfloat16"]
    for row, gates, entries, names in (
            ("dual_seq_fwd", "float32",
             lambda: PD.dual_seq_fwd_entries(*dargs),
             ("hs_f", "cs_f", "hs_b", "cs_b")),
            ("seq_fwd_bf16_gates", "float32",
             lambda: PB.seq_fwd_entries(*sargs, False), ("hs", "cs")),
            ("seq_fwd_bf16_gates", "bfloat16",
             lambda: PB.seq_fwd_entries(*sargs, True), ("hs", "cs"))):
        run, outs = entries()
        run("loop")
        new = [o.clone() for o in outs]
        run("rowblock")
        torch.cuda.synchronize()
        ab, rel, per = rel_errs(names, new, outs)
        del new
        if not rel <= tol:
            raise AssertionError(f"{row} ({gates} gates): the loop and the "
                                 f"row-block design differ by {rel} (tol "
                                 f"{tol}), per output {per}")
        times, _ = ab_turns({"new": lambda: run("loop"),
                             "old": lambda: run("rowblock")},
                            reps=PROBE_AB_REPS)
        r = rows[row][dt]
        res = {"ms": statistics.median(times["new"]),
               "rowblock_ms": statistics.median(times["old"]),
               "new_ms_all": times["new"], "rowblock_ms_all": times["old"],
               "rowblock_err": ab, "rowblock_rel_err": rel,
               "library_ms": r["library_ms"], "bound_ms": r["bound_ms"]}
        res["speedup"] = res["rowblock_ms"] / res["ms"]
        res["vs_library"] = r["library_ms"] / res["ms"]
        log("probe_seq_ab", name=row, gates=gates, dtype=dt,
            reps=PROBE_AB_REPS, **res)
        if row == "seq_fwd_bf16_gates" and gates == "float32":
            r.setdefault("ab", {})["f32_gates"] = res
        else:
            r.setdefault("ab", {}).update(res)
        del run, outs
        torch.cuda.empty_cache()


# the LayerNorm ladder (csrc/probe_ln.cu, every arm on the persistent loops
# of csrc/ln_lstm.cuh): its arms against their plain versions, each arm
# against its row-block design in turns, then the two ladders and the
# LN-stats A/B, at the reference probes' shape, one call per timing, 2 reps
LADDER = dict(b=4096, t=250, k=1, reps=2)
# no_gates / no_gradmm: dh_{t-1} = tile4(dh) @ wh^T grows ~2.26x a step
# (the reference's arithmetic) and overflows before T=250; 2.26**32 ~ 2e11
LADDER_SHORT_T = 32
LADDER_SRC = "sketch_rnn_tpu_torch/csrc/probe_ln.cu"
LADDER_FWD_OUTS = ("hs", "cs", "cT", "hT")
# the kernels line's rows of the ladder: each shows at its top level the
# arm its TPU kernel function builds first beside production, and every
# arm's numbers under "arms"
LADDER_ROWS = ("ln_probe_fwd", "ln_probe_bwd", "ln_probe_bwd_fake_stats")
# turns of (new, old, old, new) of each arm's A/B against the row-block
# design (ln_probe_ab lines): 2 for the backward, to keep the phase short
LADDER_AB_TURNS = {"fwd": 3, "bwd": 2}


def ladder_bytes(inp, names, outs):
    return nbytes(*(inp[n] for n in names), *outs)


def ladder_ab(way, arm, kw, r):
    """Arm ``arm`` of the ``way`` ladder ("fwd" or "bwd"): the persistent
    loop (``srt_ln_probe_<way>``) against the row-block design it replaced
    (``srt_ln_probe_<way>_rowblock``) on one set of buffers, in
    LADDER_AB_TURNS[way] turns of (new, old, old, new), medians, into
    ``r["ab"]`` and one ``ln_probe_ab`` line; the two designs' largest
    relative gap logged; the row-block ``prod`` arm held bit for bit to
    the row-block production entry (``srt_ln_lstm_<way>_rowblock``; the
    backward's weight gradients rounded as ``fused_ln_lstm`` rounds them).
    Uncounted launches."""
    import statistics

    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as PS

    entry = f"srt_ln_probe_{way}"
    run, outs = (PS.fwd_entries if way == "fwd" else PS.bwd_entries)(arm,
                                                                     **kw)
    run(entry)
    new = [o.clone() if o is not None else None for o in outs]
    run(entry + "_rowblock")
    torch.cuda.synchronize()
    pairs = [(n, x) for n, x in zip(new, outs) if n is not None]
    gap = max(float((x.float() - n.float()).abs().max())
              / max(float(x.float().abs().max()), 1e-30) for n, x in pairs)
    gap = gap if math.isfinite(gap) else None    # no_gates' overflow
    del new, pairs
    res = {}
    if arm == "prod":
        rowblock, want = (
            CF.ln_lstm_fwd_entries(residual_dtype=torch.bfloat16, **kw)
            if way == "fwd" else CF.ln_lstm_bwd_entries(**kw))
        rowblock(f"srt_ln_lstm_{way}_rowblock")
        rnd = ((lambda o: o) if way == "fwd" else lambda o: (
            *o[:2], o[2].to(torch.bfloat16), o[3].to(torch.bfloat16),
            *o[4:]))
        same = all(p is None and q is None or torch.equal(p, q)
                   for p, q in zip(rnd(outs), rnd(want)))
        if not same:
            raise AssertionError(f"{entry}_rowblock(prod) is not bitwise "
                                 f"srt_ln_lstm_{way}_rowblock")
        res[f"bitwise_srt_ln_lstm_{way}_rowblock"] = same
        del rowblock, want
    times, _ = ab_turns({"new": lambda: run(entry),
                         "old": lambda: run(entry + "_rowblock")},
                        reps=LADDER_AB_TURNS[way])
    res.update(ms=statistics.median(times["new"]),
               rowblock_ms=statistics.median(times["old"]),
               new_ms_all=times["new"], rowblock_ms_all=times["old"],
               rowblock_rel_gap=gap)
    res["speedup"] = res["rowblock_ms"] / res["ms"]
    r["ab"] = res
    log("ln_probe_ab", way=way, arm=arm, dtype="bfloat16",
        turns=LADDER_AB_TURNS[way], **res)
    del run, outs
    torch.cuda.empty_cache()


def check_probe_ladder(card, rows):
    """The LayerNorm ladder (``csrc/probe_ln.cu`` on the persistent loops
    of ``csrc/ln_lstm.cuh``, scripts ``probe_dec_bwd_split.py`` and
    ``probe_ln_stats.py``) at the reference probes' shape, B=4096, T=250,
    H=512, D=5, on their seeded inputs (bfloat16 weights and residuals,
    x_bias, dropout seed 5 at keep 0.9).

    Forward arms: identical run to run; each against its plain version
    run free within FUSED_TOL["bfloat16"] (relative to each output's
    largest magnitude), except ``prod``, whose free-running gap is logged:
    at these inputs its recurrence grows a float32 gap of 1e-7 in the
    carry to 1.1e-2 of the largest ``hs`` by T=32 (measured on the CPU
    with the plain version, B=4096), whatever the kernel. So every arm is
    also held at float32 residuals step by step (the plain step taken from
    the kernel's stored carry) within FUSED_TOL["float32"], and ``prod``
    bit for bit the production kernel it is, ``srt_ln_lstm_fwd``.
    Backward arms (over the residuals of one production forward):
    identical run to run, within FUSED_TOL["bfloat16"] of their plain
    versions, except ``no_gates`` and ``no_gradmm``, whose gradient grows
    ~2.26x a step: they are held at T=32 at float32 weights and residuals
    within FUSED_TOL["float32"], their bfloat16 gap at T=32 and the
    outputs that are non-finite at T=250, in the kernel and in the plain
    version, are logged; ``prod`` bit for bit ``srt_ln_lstm_bwd`` (the
    weight gradients as float32). Both ``prod`` arms are timed beside
    the production entry, and every arm against its row-block design
    (``ladder_ab``). Then each ladder's run function (whose record names
    the entry ``prod`` is, carries its own time and the grid-scaling
    runs) and the LN-stats A/B, the ladder's launch counters zeroed just
    before each and read just after, each record on one line. Returns
    the launches by row."""
    import torch

    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.scripts import _probe
    from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as PS
    from sketch_rnn_tpu_torch.scripts import probe_ln_stats as PL

    t_phase = time.perf_counter()
    dt, tol, bf, f32 = "bfloat16", FUSED_TOL["bfloat16"], torch.bfloat16, \
        torch.float32
    b, t = LADDER["b"], LADDER["t"]
    h, d = PS.H, PS.D
    same = lambda x, y: all(p is None and q is None or torch.equal(p, q)
                            for p, q in zip(x, y))
    inp = PS.probe_inputs(b, t, DEV)
    z = torch.zeros((b, h), device=DEV)
    fkw = dict(inp, c0=z, h0=z)
    prod_flops = 2 * t * b * (d + h) * 4 * h
    params = ("wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma", "lnc_beta",
              "dropout_seed")
    arms = {}

    for arm in PS.FWD_ARMS:
        got, again = PS.fwd_arm(arm, **fkw), PS.fwd_arm(arm, **fkw)
        torch.cuda.synchronize()
        free = lambda: PS.fwd_plain(arm, **fkw)
        ab, rel, per = rel_errs(LADDER_FWD_OUTS, got, free())
        det = same(got, again)
        got32 = PS.fwd_arm(arm, residual_dtype=f32, **fkw)
        forced = PS.fwd_plain(arm, residual_dtype=f32, teacher=got32[:2],
                              **fkw)
        _, rel32, per32 = rel_errs(LADDER_FWD_OUTS, got32, forced)
        del got32, forced
        if not (det and rel32 <= FUSED_TOL["float32"]
                and (arm == "prod" or rel <= tol)):
            raise AssertionError(
                f"fwd_arm({arm}): rel err {rel} (tol {tol}, held "
                f"{arm != 'prod'}), per output {per}; step by step at float32"
                f" residuals {rel32} (tol {FUSED_TOL['float32']}), "
                f"{per32}; deterministic {det}")
        r = {"err": ab, "rel_err": rel, "errs": per, "deterministic": det,
             "free_running_held": arm != "prod",
             "stepwise_f32_rel_err": rel32}
        if arm == "prod":
            production, want = CF.ln_lstm_fwd_entries(
                c0=z, h0=z, residual_dtype=bf, **inp)
            production("srt_ln_lstm_fwd")
            r["bitwise_srt_ln_lstm_fwd"] = same(got, want)
            if not r["bitwise_srt_ln_lstm_fwd"]:
                raise AssertionError("fwd_arm(prod) is not bitwise the "
                                     "production LN forward")
            del want
            r["ms_beside_fused_ln_lstm_fwd"] = dict(zip(
                ("prod_arm", "fused_ln_lstm_fwd", "srt_ln_lstm_fwd"),
                _probe.interleaved(
                    [lambda: PS.fwd_arm("prod", **fkw),
                     lambda: CF.ln_lstm_fwd(c0=z, h0=z, residual_dtype=bf,
                                            **inp),
                     lambda: production("srt_ln_lstm_fwd")], 1, 2)))
            del production
        del got, again
        ladder_ab("fwd", arm, fkw, r)
        fl = 0 if arm == "floor" else prod_flops
        outs = PS.fwd_arm(arm, **fkw)
        moved = (nbytes(inp["xs"][:, :, :1], inp["x_bias"][:, :h], z, z,
                        *outs) if arm == "floor" else
                 ladder_bytes(inp, ("xs", "x_bias", *params), (z, z, *outs)))
        del outs
        bms, by = bound_ms(fl, moved, dt)
        r.update(plain_ms=_probe.events_ms(free, 1), bound_ms=bms,
                 bound_by=by, library_ms=None, flops=fl, bytes=moved)
        arms[f"fwd_{arm}"] = r
        log("kernel", name=f"ln_probe_fwd[{arm}]", dtype=dt, T=t, B=b, H=h,
            D=d, tol=tol, **r)

    bi = PS.bwd_inputs(inp)
    names = FUSED_OUTPUTS["fused_ln_lstm_bwd"]
    short = dict(bi, **{k: bi[k][:LADDER_SHORT_T]
                        for k in ("xs", "hs", "cs", "dhs")})
    # the same T=32 inputs at float32 weights and residuals (the bfloat16
    # weights widened exactly, the residuals of a float32 forward)
    short32 = dict(short, wx=inp["wx"].float(), wh=inp["wh"].float())
    short32["hs"], short32["cs"], _, _ = CF.ln_lstm_fwd(
        **{k: short32[k] for k in ("xs", "x_bias", *params)}, c0=z, h0=z,
        keep_prob=inp["keep_prob"], residual_dtype=f32)
    short32["dhs"] = torch.ones_like(short32["hs"])
    bwd_in = ("xs", "x_bias", *params, "h0", "hs", "cs", "dhs", "dcT",
              "dhT")
    fin = lambda outs: [n for n, o in zip(names, outs)
                        if o is not None and not bool(torch.isfinite(o).all())]
    for arm in (*PS.ARMS, "fake"):
        run = PL.bwd_fake if arm == "fake" else (
            lambda a=arm, **k: PS.bwd_arm(a, **k))
        plain = lambda kw, a=arm: PS.bwd_plain(a, **kw)
        # no_gates / no_gradmm: every step multiplies the gradient, and
        # the gap a bfloat16 rounding flip of d_pre opens, by ~2.26, so
        # the gap grows with T (2e-2 of the largest output at T=32 on the
        # H100); they are held at float32, where a flip is 2**-16 as large
        explode = arm in ("no_gates", "no_gradmm")
        held, tol_h = (short32, FUSED_TOL["float32"]) if explode else (bi, tol)
        got, again = run(**held), run(**held)
        torch.cuda.synchronize()
        ab, rel, per = rel_errs(names, got, plain(held))
        det = same(got, again)
        if not (rel <= tol_h and det):
            raise AssertionError(
                f"bwd arm {arm} (T={held['xs'].shape[0]}, wx {held['wx'].dtype}"
                f"): rel err {rel} (tol {tol_h}), per output {per}, "
                f"deterministic {det}")
        r = {"err": ab, "rel_err": rel, "errs": per, "deterministic": det,
             "held_T": held["xs"].shape[0], "held_dtype": str(
                 held["wx"].dtype).split(".")[1], "held_tol": tol_h}
        del got, again
        if explode:     # logged: bfloat16 at T=32, where T=250 overflows
            r["bf16_T32_rel_err"] = rel_errs(names, run(**short),
                                             plain(short))[1]
            r["non_finite_at_T250"] = {"kernel": fin(run(**bi)),
                                       "plain": fin(plain(bi))}
        if arm == "prod":
            production, want = CF.ln_lstm_bwd_entries(**bi)
            production("srt_ln_lstm_bwd")
            r["bitwise_srt_ln_lstm_bwd"] = same(run(**bi), want)
            if not r["bitwise_srt_ln_lstm_bwd"]:
                raise AssertionError("bwd_arm(prod) is not bitwise the "
                                     "production LN backward")
            del want
            r["ms_beside_fused_ln_lstm_bwd"] = dict(zip(
                ("prod_arm", "fused_ln_lstm_bwd", "srt_ln_lstm_bwd"),
                _probe.interleaved(
                    [lambda: run(**bi), lambda: CF.ln_lstm_bwd(**bi),
                     lambda: production("srt_ln_lstm_bwd")], 1, 2)))
            del production
            torch.cuda.empty_cache()
        ladder_ab("bwd", arm, bi, r)
        weight = arm in ("prod", "no_lnbwd", "no_ln", "fake", "no_gates")
        fl = (3 * prod_flops if weight else
              prod_flops + 2 * t * b * h * 4 * h if arm == "no_gradmm"
              else 0)
        outs = run(**bi)
        moved = ladder_bytes(bi, bwd_in if arm != "floor" else (
            "xs", "x_bias", "h0", "hs", "cs", "dhs", "dcT", "dhT"), outs)
        del outs
        bms, by = bound_ms(fl, moved, dt)
        r.update(plain_ms=_probe.events_ms(lambda: plain(bi), 1),
                 bound_ms=bms, bound_by=by, library_ms=None, flops=fl,
                 bytes=moved)
        arms[f"bwd_{arm}"] = r
        log("kernel", name=f"ln_probe_bwd[{arm}]", dtype=dt, T=t, B=b, H=h,
            D=d, tol=tol, **r)
    del bi, short, short32
    torch.cuda.empty_cache()

    # the main paths: the two ladders and the LN-stats A/B
    launches = {}
    for run, mod, way in ((PS.run_fwd_ladder, PS, "fwd_"),
                          (PS.run_bwd_ladder, PS, "bwd_"),
                          (PL.run_probe, PL, "bwd_")):
        PS.reset_launch_counts()
        PL.reset_launch_counts()
        rec = run(device=DEV, **LADDER)
        counts = {k: v for k, v in mod.launch_counts().items()
                  if k.startswith(way)}
        if not all(counts.values()):
            raise AssertionError(f"{rec['kind']}: an arm launched no "
                                 f"kernel: {counts}")
        launches.update(counts)
        log(rec["kind"], card=card, launches=counts, record=rec)
        if rec["kind"] == "probe_ln_stats":
            arms["bwd_fake"]["ms"] = rec["fake_stats_bwd_ms"]
        else:
            way = "fwd" if rec["kind"] == "probe_dec_fwd_split" else "bwd"
            for arm, ms in rec["arms_ms"].items():
                if arm != "glue":
                    arms[f"{way}_{arm}"]["ms"] = ms
    for key, r in arms.items():
        r["launches"] = launches[key]
    by_row = {}
    for row, way, shown, names in zip(
            LADDER_ROWS, ("fwd", "bwd", "bwd"), ("no_ln", "no_lnbwd", "fake"),
            (PS.FWD_ARMS, PS.ARMS, ("fake",))):
        mine = {a: arms[f"{way}_{a}"] for a in names}
        ab = {a: {k: v["ab"][k] for k in ("ms", "rowblock_ms", "speedup")}
              for a, v in mine.items()}
        rows[row] = {dt: dict(mine[shown], arm=shown, arms=mine,
                              err=max(r["err"] for r in mine.values()),
                              rowblock_ms=ab[shown]["rowblock_ms"],
                              speedup=ab[shown]["speedup"], ab=ab)}
        by_row[row] = sum(r["launches"] for r in mine.values())
    log("probe_ladder", seconds=time.perf_counter() - t_phase,
        launches=by_row)
    return by_row


def train_plain(card):
    """The plain training path: the ``vae`` preset exactly as it says
    (``fused_rnn=false``, float32, recurrent dropout at keep 0.9 drawn
    from ``(key, t)``, full width, B=100, T=250) through ``train()``: 1
    warm-up step, then 2 timed steps with every training kernel's counter
    zeroed just before and read just after (all must read 0). Then, from
    the final state, one step with recurrent dropout off on the plain path
    against the same step through the kernels (``fused_rnn=true``): the
    same function, held within PATH_TOL. Then one small ``layer_norm``
    step at ``fused_rnn=false`` on the card against the CPU, and two
    steps profiled as in train_profile."""
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.train.step import make_train_step
    from sketch_rnn_tpu_torch.utils import prng

    launches, (hps, model, loader, state) = train_main_path(
        card, vae_hps(fused_rnn=False), "train_plain",
        "vae (lstm decoder, fused_rnn=false as the preset says, float32)",
        {}, PLAIN_STEPS, 1)
    batch, key = loader.next_batch(), prng.fold_in(prng.key(13), state.step)
    steps = []
    for fused in (False, True):
        hp = vae_hps(fused_rnn=fused, use_recurrent_dropout=False)
        steps.append(make_train_step(SketchRNN(hp), hp, device=DEV)(
            state, batch, key))
    paths = compare_steps(state, *steps)
    rel_tol, upd_tol = PATH_TOL
    if not (paths["loss_rel_err"] <= rel_tol
            and paths["grad_norm_rel_err"] <= rel_tol
            and paths["update_err"] <= upd_tol):
        raise AssertionError(f"plain path vs kernels: {paths} (tol rel "
                             f"{rel_tol}, update {upd_tol})")
    from sketch_rnn_tpu_torch import HParams

    small = HParams(conditional=True, dec_model="layer_norm", batch_size=8,
                    max_seq_len=24, enc_rnn_size=16, dec_rnn_size=32,
                    z_size=8, num_mixture=3)
    vs_cpu = small_step_vs_cpu(small, "float32")
    log("train_plain_reference", step=state.step,
        plain_vs_kernels_no_dropout=paths, path_rel_tol=rel_tol,
        path_update_tol=upd_tol, small_layer_norm_card_vs_cpu=vs_cpu,
        rel_tol=STEP_TOL["float32"][0], update_tol=STEP_TOL["float32"][1])
    profile_train(hps, loader, state, preset="vae (fused_rnn=false)")
    return launches


# -- the command line -------------------------------------------------------

CLI_STEPS = 4           # train steps, with an eval sweep and a save every 2
CLI_SAMPLER_NS = (16, 64)
CLI_SAMPLER_CALLS = 3   # timed calls of each sampler arm, after one warm-up
SVG_NS = "{http://www.w3.org/2000/svg}"


def run_cli(args):
    """``cli.main(args)`` in this process, its output captured; returns
    the standard output. A non-zero exit fails with its output's tail."""
    import io

    from sketch_rnn_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(args[:2])} exited {rc}: "
                             f"{out.getvalue()[-2000:]}"
                             f"{err.getvalue()[-2000:]}")
    return out.getvalue(), time.perf_counter() - t0


def svg_cells(path, n, cols):
    """The SVG at ``path`` parses as XML and its canvas is the grid of
    ``n`` sketches in rows of ``min(cols, n)`` cells (``svg_grid``);
    returns the cells that hold a path (an empty sketch draws none)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    cols = max(1, min(cols, n))
    rows = -(-n // cols)
    if (root.get("width"), root.get("height")) != (f"{cols * 160}",
                                                   f"{rows * 160}"):
        raise AssertionError(f"{path}: canvas {root.get('width')} x "
                             f"{root.get('height')}, expected {cols} x "
                             f"{rows} cells for {n} sketches")
    cells = set()
    for p in root.iter(SVG_NS + "path"):
        x, y = (float(v) for v in p.get("d").split()[0][1:].split(","))
        cells.add((int(y // 160), int(x // 160)))
    if not cells <= {(r, c) for r in range(rows) for c in range(cols)}:
        raise AssertionError(f"{path}: a path outside the grid")
    return len(cells)


def sampler_times(model, hps, params, n, full_length):
    """The plain sampler's ms per call at ``n`` rows on the card (CUDA
    synchronised host clock, mean of CLI_SAMPLER_CALLS after a warm-up),
    the steps it ran, its reads of ``done`` and the synchronising CUDA
    calls that torch's sync debug mode saw in one call with its fetch;
    ``full_length``: ``out_b[2] = -1e9``, so no row ends before
    max_seq_len."""
    import warnings

    import numpy as np
    import torch

    from sketch_rnn_tpu_torch.sample import sampler as sm
    from sketch_rnn_tpu_torch.utils import prng
    from sketch_rnn_tpu_torch.utils.device import Staged

    if full_length:
        params = dict(params, out_b=params["out_b"].clone())
        params["out_b"][2] = -1e9
    fn = sm.make_sampler(model, hps, device=DEV)
    z = prng.normal(prng.key(21), (n, hps.z_size)).to(DEV)
    labels = torch.zeros((n,), dtype=torch.int64, device=DEV)

    def call(i):
        return Staged(fn(params, prng.key(i), n, z, labels, 0.5)).fetch()

    call(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CLI_SAMPLER_CALLS):
        call(i + 1)
    ms = (time.perf_counter() - t0) * 1e3 / CLI_SAMPLER_CALLS
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            s5, lengths = call(CLI_SAMPLER_CALLS + 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_warnings = sum("synchroniz" in str(w.message) for w in seen)
    steps, checks = fn.stats["steps"], fn.stats["host_syncs"]
    syncs = checks + 1                   # the reads of done, the fetch
    cap = math.ceil(steps / sm.DONE_CHECK_EVERY) + 1
    if not (syncs <= cap and sync_warnings <= syncs):
        raise AssertionError(f"sampler n={n}: {syncs} syncs counted, "
                             f"{sync_warnings} seen by the sync debug "
                             f"mode, over {steps} steps (at most {cap})")
    if not (np.isfinite(s5).all() and s5.shape == (n, hps.max_seq_len, 5)):
        raise AssertionError(f"sampler n={n}: bad strokes {s5.shape}")
    return {"n": n, "ms_per_call": ms, "steps": steps,
            "ms_per_step": ms / steps, "host_syncs_per_call": syncs,
            "sync_debug_warnings": sync_warnings,
            "max_host_syncs": cap, "mean_length": float(lengths.mean())}


def engine_times(model, hps, params, n):
    """The serving engine's ``generate`` at ``n`` requests of
    max_seq_len steps each (``out_b[2] = -1e9``) on the same weights:
    ms per burst, mean of CLI_SAMPLER_CALLS after a warm-up."""
    import numpy as np
    import torch

    from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
    from sketch_rnn_tpu_torch.utils import prng

    params = dict(params, out_b=params["out_b"].clone())
    params["out_b"][2] = -1e9
    engine = ServeEngine(model, hps, params, device=DEV)
    z = np.random.default_rng(21).normal(
        size=(n, hps.z_size)).astype(np.float32)

    def burst(i):
        reqs = [Request(key=prng.fold_in(prng.key(i), j), z=z[j],
                        temperature=0.5) for j in range(n)]
        return engine.run(reqs)["metrics"]

    burst(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CLI_SAMPLER_CALLS):
        m = burst(i + 1)
    torch.cuda.synchronize()
    return {"n": n, "ms_per_burst": (time.perf_counter() - t0) * 1e3
            / CLI_SAMPLER_CALLS, "chunks": m["chunks"],
            "host_syncs": m["host_syncs"], "decode_steps": m["decode_steps"]}


def sampler_card_vs_cpu(model, hps, params):
    """The plain sampler on the card against the same sampler on the CPU
    at float32 compute, 8 rows capped at 8 steps (serve_small_vs_cpu's
    burst): lengths and pens equal, offsets within SERVE_TOL."""
    import numpy as np

    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.sample import sampler as sm
    from sketch_rnn_tpu_torch.utils import prng
    from sketch_rnn_tpu_torch.utils.device import Staged, tree_to

    hps = hps.replace(compute_dtype="float32",
                      fused_residual_dtype="float32")
    model = SketchRNN(hps)
    z = prng.normal(prng.key(3), (8, hps.z_size))
    labels = np.arange(8)
    caps = np.full((8,), K, np.int32)
    got = {}
    for dev in (DEV, "cpu"):
        fn = sm._build_sampler(model, hps, max_len=K, device=dev)
        got[dev] = Staged(fn(tree_to(params, dev), prng.key(3), 8, z,
                             labels, 0.8, caps)).fetch()
    (s_card, l_card), (s_cpu, l_cpu) = got[DEV], got["cpu"]
    if not (np.array_equal(l_card, l_cpu)
            and np.array_equal(s_card[..., 2:], s_cpu[..., 2:])):
        raise AssertionError("plain sampler: card and CPU differ in "
                             "lengths or pen states")
    err = float(np.abs(s_card - s_cpu).max())
    if not err <= SERVE_TOL["float32"]:
        raise AssertionError(f"plain sampler: card vs CPU err {err}")
    return {"rows": 8, "steps": K, "max_abs_err": err,
            "tol": SERVE_TOL["float32"]}


def cli_flow(card):
    """The port's command line end to end, in this process
    (``cli.main``), on the flagship preset at full width with seeded
    weights and the synthetic corpus: ``train --preset quickdraw345_dp
    --synthetic`` to step 4 (B=100, T=250, an eval sweep and a save every
    2 steps), ``eval --split test``, ``sample -n 16``, ``sample
    --temperatures 0.2,0.5,1.0 -n 8``, ``sample --interpolate -n 8
    --strokes_out`` and ``sample --reconstruct -n 4 --strokes_out``.
    Every exit code 0; every SVG parses and holds its grid; the training
    kernels (rows 4f/4b/5f/5b) launched in ``train`` and the serving
    kernels (rows 1 and 2) in each endpoint demo, none of them in the
    plain ``sample``; the ``--strokes_out`` arrays bit for bit a direct
    ``serve_requests`` call on the restored checkpoint with the same
    request keys and serving geometry. Then the plain sampler's card run
    against its CPU run, its ms per call at n=16 and n=64 (its steps and
    host syncs) beside the engine's ``generate``, and the interpolate
    request's latency."""
    import argparse
    import os
    import shutil
    import tempfile

    import numpy as np

    from sketch_rnn_tpu_torch import cli
    from sketch_rnn_tpu_torch.ops import cuda_decode as cd
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
    from sketch_rnn_tpu_torch.serve.engine import Request
    from sketch_rnn_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        wd = os.path.join(tmp, "work")
        out = lambda name: os.path.join(tmp, name)
        common = ["--synthetic", f"--workdir={wd}"]
        seconds, launches, cells = {}, {}, {}

        CF.reset_launch_counts()
        cd.reset_launch_counts()
        _, seconds["train"] = run_cli(
            ["train", "--preset", "quickdraw345_dp", *common,
             f"--hparams=num_steps={CLI_STEPS},save_every=2,eval_every=2,"
             f"log_every=2"])
        launches["train"] = {k: v for k, v in CF.launch_counts().items()
                             if v}
        rows_4_5 = ("fused_lstm_seq_fwd", "fused_lstm_seq_bwd",
                    "fused_ln_lstm_fwd", "fused_ln_lstm_bwd")
        if not all(launches["train"].get(k, 0) > 0 for k in rows_4_5):
            raise AssertionError(f"cli train launched {launches['train']}")
        text, seconds["eval"] = run_cli(["eval", *common, "--split",
                                         "test"])
        ev = json.loads(text.strip().splitlines()[-1])
        if not (ev["step"] == CLI_STEPS and math.isfinite(ev["loss"])):
            raise AssertionError(f"cli eval: {ev}")

        demos = (("sample", ["-n", "16"], 16, 5),
                 ("temperatures", ["--temperatures", "0.2,0.5,1.0", "-n",
                                   "8"], 24, 8),
                 ("interpolate", ["--interpolate", "-n", "8"], 8, 5),
                 ("reconstruct", ["--reconstruct", "-n", "4"], 8, 4))
        for name, args, n_cells, cols in demos:
            endpoint = name in ("interpolate", "reconstruct")
            extra = [f"--strokes_out={out(name + '.npz')}"] if endpoint \
                else []
            cd.reset_launch_counts()
            _, seconds[name] = run_cli(["sample", *common, *args, *extra,
                                        f"--output={out(name + '.svg')}"])
            launches[name] = {"decode_chunk": cd.decode_chunk_launches,
                              "replay_chunk": cd.replay_chunk_launches}
            ran = [v > 0 for v in launches[name].values()]
            if ran != [endpoint, endpoint]:
                raise AssertionError(f"cli sample {name}: serving kernel "
                                     f"launches {launches[name]}")
            cells[name] = svg_cells(out(name + ".svg"), n_cells, cols)

        # the same requests served directly from the restored checkpoint
        hps = cli._workdir_hps(wd)
        model, state, scale, _ = cli._restore(hps, wd, DEV)
        data_args = argparse.Namespace(synthetic=True, synthetic_grid=255.0,
                                       skip_bad_records=False)
        valid = cli._load_data(hps, data_args, scale_factor=scale)[1]
        key = prng.key(0)
        direct = {
            "interpolate": [Request(
                key=key, endpoint="interpolate", frames=8,
                prefix=(valid.strokes[0], valid.strokes[1]),
                temperature=0.5)],
            "reconstruct": [Request(
                key=prng.fold_in(key, i), endpoint="reconstruct",
                prefix=valid.strokes[i], temperature=0.5,
                label=int(valid.labels[i])) for i in range(4)]}
        interp_latency_s = None
        for name, reqs in direct.items():
            res = {r.uid: r for r in serve_requests(
                model, hps, state.params, reqs, device=DEV)["results"]}
            want = (res[0].frames if name == "interpolate"
                    else [res[i].strokes5 for i in range(4)])
            if name == "interpolate":
                interp_latency_s = res[0].latency_s
            with np.load(out(name + ".npz")) as z:
                got = [z[k] for k in z.files]
            if not (len(got) == len(want) and all(
                    a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in zip(got, want))):
                raise AssertionError(f"cli sample --{name} --strokes_out "
                                     f"is not the endpoint's strokes")
        vs_cpu = sampler_card_vs_cpu(model, hps, state.params)
        sampler = {f"{'full_length' if full else 'as_trained'}_n{n}":
                   sampler_times(model, hps, state.params, n, full)
                   for full in (False, True) for n in CLI_SAMPLER_NS}
        engine = {f"n{n}": engine_times(model, hps, state.params, n)
                  for n in CLI_SAMPLER_NS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("cli_flow", card=card, preset="quickdraw345_dp", batch=hps.batch_size,
        max_seq_len=hps.max_seq_len, train_steps=CLI_STEPS,
        eval=ev, seconds=seconds, launches=launches,
        svg_cells_drawn=cells, strokes_out_equal_serve_requests=True,
        sampler_card_vs_cpu=vs_cpu, sampler=sampler,
        engine_generate=engine, interpolate_latency_s=interp_latency_s,
        phase_seconds=time.perf_counter() - t_phase)


# the kernels line: (name, source, TPU kernel, the dtype of its main path)
KERNEL_ROWS = (
    ("decode_chunk", "sketch_rnn_tpu_torch/csrc/decode.cu",
     "sketch_rnn_tpu/ops/pallas_decode.py:182", "bfloat16"),
    ("replay_chunk", "sketch_rnn_tpu_torch/csrc/decode.cu",
     "sketch_rnn_tpu/ops/pallas_decode.py:339", "bfloat16"),
    *((n, FUSED_SRC, r, "float32" if n.startswith("fused_lstm_")
       and not n.startswith("fused_lstm_seq") else "bfloat16")
      for n, r in FUSED_REPLACES.items()),
    *((n, HYPER_SRC, r, "float32") for n, r in HYPER_REPLACES.items()),
    ("lstm_seq_fwd", LSTM_SEQ_SRC, "sketch_rnn_tpu/ops/pallas_lstm.py:56",
     "float32"),
    ("lstm_seq_bwd", LSTM_SEQ_SRC, "sketch_rnn_tpu/ops/pallas_lstm.py:94",
     "float32"),
    ("dual_seq_fwd", PROBE_SRC, "scripts/probe_dual_encoder.py:53",
     "bfloat16"),
    ("seq_fwd_bf16_gates", PROBE_SRC, "scripts/probe_bf16_gates.py:44",
     "bfloat16"),
    ("ln_probe_fwd", LADDER_SRC, "scripts/probe_dec_bwd_split.py:281",
     "bfloat16"),
    ("ln_probe_bwd", LADDER_SRC, "scripts/probe_dec_bwd_split.py:141",
     "bfloat16"),
    ("ln_probe_bwd_fake_stats", LADDER_SRC, "scripts/probe_ln_stats.py:87",
     "bfloat16"))
# the kernels measured at one dtype only; every other row also carries the
# other dtype's numbers under at_<dtype>
ONE_DTYPE = ("lstm_seq_fwd", "lstm_seq_bwd", "dual_seq_fwd",
             "seq_fwd_bf16_gates", *LADDER_ROWS)


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

    rows = {"decode_chunk": {}, "replay_chunk": {}}
    check_serving_kernels(rows)
    decode_profile()
    for dt in DTYPES:
        inp = fused_inputs(train_hps, dt)
        check_lstm_seq(inp, rows)
        check_ln_lstm(inp, rows)
        del inp
        inp = fused_inputs(vae_hps, dt)
        check_lstm(inp, rows)
        del inp
        inp = fused_inputs(hyper_hps, dt)
        check_hyper(inp, rows)
        del inp
        check_hyper_narrow(dt)
    torch.cuda.empty_cache()
    check_batch_windows()
    check_hyper_windows()

    launches = serve_main_path(card, "bfloat16")
    serve_main_path(card, "float32")
    for dt in DTYPES:
        serve_small_vs_cpu(dt)
    profile_generate("bfloat16")

    seq2 = {"fused_lstm_seq_fwd": 2, "fused_lstm_seq_bwd": 2}
    flagship = train_hps(**dtype_over("bfloat16"))
    train_launches, (hps, model, loader, state) = train_main_path(
        card, flagship, "train",
        "quickdraw345_dp (bfloat16 compute and residuals)",
        {**seq2, "fused_ln_lstm_fwd": 1, "fused_ln_lstm_bwd": 1},
        TRAIN_STEPS, WARM_STEPS)
    train_reference(train_hps, "bfloat16", hps, model, loader, state)
    profile_train(hps, loader, state)
    del state
    torch.cuda.empty_cache()
    workdir_eval, npz_train = train_workdir(card)
    train_spc(card, workdir_eval)
    del workdir_eval
    torch.cuda.empty_cache()
    train_feed(card, npz_train)
    del npz_train
    torch.cuda.empty_cache()
    cli_flow(card)
    torch.cuda.empty_cache()
    lstm_launches, (hps, model, loader, state) = train_main_path(
        card, vae_hps(), "train_lstm",
        "vae (lstm decoder, fused_rnn=true, float32)",
        {**seq2, "fused_lstm_fwd": 1, "fused_lstm_bwd": 1}, LSTM_STEPS, 1)
    train_reference(vae_hps, "float32", hps, model, loader, state)
    del state
    hyper_launches, (hps, model, loader, state) = train_main_path(
        card, hyper_hps(), "train_hyper",
        "hyper (HyperLSTM decoder, fused_rnn=true, float32)",
        {**seq2, "fused_hyper_lstm_fwd": 1, "fused_hyper_lstm_bwd": 1},
        HYPER_STEPS, 1, falling=True)
    train_reference(hyper_hps, "float32", hps, model, loader, state)
    profile_train(hps, loader, state, preset="hyper")
    del state
    torch.cuda.empty_cache()

    serve_main_path(card, "float32", cell="hyper")
    serve_small_vs_cpu("float32", cell="hyper")
    profile_generate("float32", cell="hyper")

    check_hoisted_lstm(rows)
    weight_grad_ab(rows)
    hoisted_launches = hoisted_main_path(card)
    torch.cuda.empty_cache()
    train_plain(card)
    probe_launches = check_probes(card, rows)
    ladder_launches = check_probe_ladder(card, rows)

    picked = lambda src, *names: {n: src[n] for n in names}
    main_launches = {
        **launches,
        **picked(train_launches, "fused_lstm_seq_fwd", "fused_lstm_seq_bwd",
                 "fused_ln_lstm_fwd", "fused_ln_lstm_bwd"),
        **picked(lstm_launches, "fused_lstm_fwd", "fused_lstm_bwd"),
        **picked(hyper_launches, *HYPER_REPLACES), **hoisted_launches,
        **probe_launches, **ladder_launches}

    def row(name, source, replaces, dt):
        want = {dt} if name in ONE_DTYPE else set(DTYPES)
        if set(rows[name]) != want:
            raise AssertionError(f"{name}: measured at {sorted(rows[name])}"
                                 f", expected {sorted(want)}")
        r = rows[name][dt]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": main_launches[name],
               "max_abs_err": r["err"], **{k: r[k] for k in keys},
               "dtype": dt}
        if "arms" in r:      # the ladder's rows: every arm's numbers
            out["arm"] = r["arm"]
            out["arms"] = {a: {"launches": v["launches"],
                               "max_abs_err": v["err"],
                               **{k: v[k] for k in keys}}
                           for a, v in r["arms"].items()}
        for extra in ("ab", "weight_pass", "lstm", "kernel_ms",
                      "rowblock_ms", "speedup"):
            if extra in r:      # the A/B records, the serving entries alone
                out[extra] = r[extra]
        for other in want - {dt}:
            o = rows[name][other]
            out["at_" + other] = {"max_abs_err": o["err"],
                                  **{k: o[k] for k in keys}}
            for extra in ("ab", "weight_pass", "lstm", "kernel_ms"):
                if extra in o:
                    out["at_" + other][extra] = o[extra]
        return out

    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [row(*k) for k in KERNEL_ROWS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
