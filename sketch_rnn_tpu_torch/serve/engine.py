"""Continuous-batching generation engine: slot-recycling chunked decode.

The port of ``sketch_rnn_tpu/serve/engine.py``'s serving core:

- **One K-step chunk per dispatch.** Every dispatch advances all ``B``
  slots by ``K`` decode steps: for the ``lstm`` and ``layer_norm``
  decoders through ONE launch of the hand-written CUDA kernel
  ``ops/cuda_decode.decode_chunk``, which holds the carry, the previous
  stroke and t/done on-chip across the K steps; for the ``hyper``
  decoder through the plain chunk program (below).
- **Slot scheduler.** A host-side queue admits pending requests into
  finished slots BETWEEN chunks, by pointing the slot at the request's
  row of the device-resident request pool and flagging it for
  on-device re-initialization (the admission prologue of
  :func:`make_chunk_step`).
- **Per-request determinism.** Step ``t`` of a request draws its four
  uniforms from ``fold_in(request_key, t)`` (``utils/prng.py``, bitwise
  ``jax.random``), so a request's strokes do not depend on batch
  composition, slot position, admission time or chunk size — and one
  request key gives the same strokes here as in the JAX package, up to
  float rounding.
- **Depth-1 pipelining.** Chunk i+1 is dispatched before chunk i's
  outputs are fetched: the launch is asynchronous, its (t, done,
  strokes) are copied without blocking into pinned host memory behind a
  CUDA event, and the host's scheduling work overlaps the card's.

The JAX package's two chunk flavors (``hps.decode_kernel`` ``scan``, a
``lax.scan`` of the step, and ``pallas``, the fused Pallas kernel)
compute the same math (``ops/pallas_decode.py``'s semantics contract).
``HParams`` accepts either name so sidecars load, and the port serves
the ``lstm`` and ``layer_norm`` decoders through its one CUDA kernel
whatever the name; its metrics then report ``decode_kernel: "cuda"``.

**The plain chunk program.** The JAX package has no decode kernel for
the HyperLSTM (its Pallas kernel refuses the cell; the engine serves it
with the scan). The port follows that design: ``dec_model == "hyper"``
alone selects a chunk written in plain PyTorch, the counterpart of the
scan body: ``K`` steps of ``model.decode_step`` -> mixture parameters ->
``sample_mixture_rows`` -> the live/done masking, with the chunk's
uniforms pre-drawn by ``make_uniforms`` (live steps are a prefix of the
chunk, so ``fold_in(key, t0 + k)`` is the scan's in-loop draw on every
live step). It makes no host synchronisation, so the depth-1 pipeline
holds. Metrics report ``decode_kernel: "plain"``. It is no fallback:
the other cells never take it, and they raise if their kernel cannot
launch.

The sampler is ``ops/cuda_decode.sample_mixture_rows``. Telemetry, fault
points, SLO tracking, the metrics writer, static batching, pool padding,
speculative decoding, value-paged params and hot swap come with later
slices.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.ops import mdn
from sketch_rnn_tpu_torch.ops.cuda_decode import (cast_weights,
                                                  check_cell_kind,
                                                  decode_chunk,
                                                  make_uniforms,
                                                  sample_mixture_rows,
                                                  weight_dtype)
from sketch_rnn_tpu_torch.sample.sampler import END_TOKEN, START_TOKEN
from sketch_rnn_tpu_torch.utils.device import (Staged, resolve_device,
                                               to_device, tree_to)
from sketch_rnn_tpu_torch.utils.prng import key_words
from sketch_rnn_tpu_torch.utils.telemetry import attribute_chunk_steps


@dataclasses.dataclass
class Request:
    """One generation request; everything its strokes may depend on.

    ``key`` is the request's own threefry key data: two uint32 words
    (``utils/prng.key`` / ``fold_in``, or ``jax.random.key_data`` of a
    JAX key — the same words give the same draws). ``max_len`` caps
    emitted strokes (default: the engine's max_len).

    ``endpoint`` selects the workload: ``generate``, ``complete``
    (continue a stroke-3 ``prefix``), ``reconstruct`` (encode ``prefix``
    to z and decode) or ``interpolate`` (``prefix`` is a PAIR of
    sketches; the slerp grid of ``frames`` latents decodes as a batch of
    child rows). Encoder endpoints are planned by ``serve/endpoints.py``
    before the engine sees them: the planner stamps ``z`` and, for
    ``complete``, the replayed ``init_carry`` (flat) and ``init_prev``
    (the last prefix row). ``parent_uid`` marks an interpolation FRAME
    row, a child of the named parent request.
    """

    key: Any
    z: Optional[np.ndarray] = None
    label: int = 0
    temperature: float = 1.0
    max_len: Optional[int] = None
    uid: Optional[int] = None
    endpoint: str = "generate"
    prefix: Optional[Any] = None
    frames: int = 0
    parent_uid: Optional[int] = None
    init_carry: Optional[np.ndarray] = None   # [C] flat replayed carry
    init_prev: Optional[np.ndarray] = None    # [5] last prefix row


@dataclasses.dataclass
class Result:
    """A completed request: its strokes plus serving telemetry."""

    uid: int
    strokes5: np.ndarray          # [n_rows, 5]; last row is p3 if drawn
    length: int                   # rows before the end-of-sketch state
    steps: int                    # decode steps executed (= n_rows)
    queue_wait_s: float           # enqueue -> slot admission
    decode_s: float               # admission -> completion
    latency_s: float              # enqueue -> completion
    # each chunk's K device steps split in integers over the slots live
    # in it, summed over the request's chunks (attribute_chunk_steps)
    attributed_steps: int = 0
    endpoint: str = "generate"
    # an interpolate result's per-frame strokes (strokes5 is their
    # concatenation)
    frames: Optional[List[np.ndarray]] = None


def make_chunk_step(model, hps: HParams, chunk: int, params,
                    greedy: bool = False):
    """Build the fixed-shape K-step decode program.

    ``fn(carry, prev, t, done, reset, slot_idx, pool) -> (carry, prev, t,
    done, strokes [K, B, 5])``; ``carry`` is the decoder carry's tensors
    in leaf order (``cell.carry_leaves``: two, or four for the hyper
    cell).

    ``pool`` is the device-resident REQUEST POOL (``[N, ...]`` tensors
    of every request's key words, z, label, temperature, step cap and
    planned state; see :meth:`ServeEngine._prepare_pool`). ``slot_idx
    [B]`` maps each slot to its pool row and ``reset [B]`` marks slots
    admitted since the last chunk: the program gathers their fields and
    re-initializes their carry (``tanh(z @ W + b)``, or the replayed
    carry of a planned ``complete`` request), previous stroke, step
    count and done flag — the JAX prologue, op for op — then runs the
    chunk as one ``decode_chunk`` launch, or for the hyper cell as the
    plain chunk program (module docstring). Done slots are frozen: they
    emit END_TOKEN rows and keep their carry.
    """
    plain = hps.dec_model == "hyper"
    cell = model.dec
    cd = cell.compute_dtype
    if not plain:
        check_cell_kind(hps.dec_model)
        # the kernel's weight matrices in its weight dtype, cast once
        dec_params = cast_weights(params["dec"], cd)
        out_w = params["out_w"].to(weight_dtype(cd))
    num_mixture = hps.num_mixture
    # START/END rows per device, copied once: a host->device copy inside
    # the chunk would wait for the card and break the pipelining
    tokens: Dict[torch.device, Any] = {}

    def chunk_fn(carry, prev, t, done, reset, slot_idx, pool):
        b = t.shape[0]
        dev = t.device
        if dev not in tokens:
            tokens[dev] = (START_TOKEN.to(dev), END_TOKEN.to(dev))
        start_row, end_row = tokens[dev]
        (pool_keys, pool_z, pool_labels, pool_temps, pool_caps,
         pool_init_carry, pool_init_prev, pool_init_mask) = pool
        key_data = pool_keys[slot_idx]
        z = None if pool_z is None else pool_z[slot_idx]
        labels = None if pool_labels is None else pool_labels[slot_idx]
        temps = pool_temps[slot_idx]
        max_steps = pool_caps[slot_idx]
        # on-device admission: freshly admitted slots start from the
        # request's initial state (computed for all slots; the reset
        # mask keeps live slots' carries)
        carry0 = cell.carry_leaves(
            model.decoder_initial_carry(params, z, b, device=dev))
        start = start_row.expand(b, 5)
        if pool_init_carry is not None:
            use = pool_init_mask[slot_idx][:, None]
            planned = cell.carry_leaves(
                cell.unflatten_carry(pool_init_carry[slot_idx]))
            carry0 = tuple(torch.where(use, p, d)
                           for p, d in zip(planned, carry0))
            start = torch.where(use, pool_init_prev[slot_idx], start)
        carry = tuple(torch.where(reset[:, None], new, old)
                      for new, old in zip(carry0, carry))
        prev = torch.where(reset[:, None], start, prev)
        t = torch.where(reset, torch.zeros_like(t), t)
        done = done & ~reset
        u = make_uniforms(key_data, t, chunk)
        if plain:
            strokes = []
            for k in range(chunk):
                new_carry, raw = model.decode_step(
                    params, cell.carry_from_leaves(carry), prev, z, labels)
                mp = mdn.get_mixture_params(raw, num_mixture)
                stroke, _ = sample_mixture_rows(mp, u[k], temps, greedy)
                live = ~done
                stroke = torch.where(live[:, None], stroke, end_row[None])
                carry = tuple(torch.where(live[:, None], new, old)
                              for new, old in zip(
                                  cell.carry_leaves(new_carry), carry))
                t = t + live.to(t.dtype)
                done = done | (stroke[:, 4] > 0.5) | (live
                                                      & (t >= max_steps))
                prev = stroke
                strokes.append(stroke)
            return carry, prev, t, done, torch.stack(strokes)
        c0, h0 = carry
        extra = model._decoder_extra(params, z, labels)
        strokes, c, h, t, done = decode_chunk(
            dec_params, out_w, params["out_b"], c0, h0, prev, extra, u,
            temps, t, done, max_steps, end_row, cell_kind=hps.dec_model,
            num_mixture=num_mixture, forget_bias=model.dec.forget_bias,
            compute_dtype=cd, greedy=greedy)
        return (c, h), strokes[-1], t, done, strokes

    return chunk_fn


class ServeEngine:
    """Continuous-batching generation over ``slots`` decoder slots.

    ``run(requests)`` drives the request list to completion and returns
    per-request :class:`Result` objects in completion order plus
    aggregate metrics. Finished slots are recycled to queued requests
    between chunks. ``device``: the card unless ``device="cpu"``; with no
    CUDA device and no explicit ``device="cpu"`` construction raises.
    """

    # the decode-path weight leaves a chunk consumes
    _DECODE_KEEP = ("dec", "out_w", "out_b", "dec_init_w", "dec_init_b",
                    "class_embed")

    def __init__(self, model, hps: HParams, params, slots: int = 0,
                 chunk: int = 0, max_len: Optional[int] = None,
                 greedy: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.hps = hps
        self.slots = int(slots or hps.serve_slots)
        self.chunk = int(chunk or hps.serve_chunk)
        self.max_len = int(max_len or hps.max_seq_len)
        self.greedy = bool(greedy)
        if self.slots < 1 or self.chunk < 1:
            raise ValueError(
                f"slots and chunk must be >= 1, got {self.slots}/"
                f"{self.chunk}")
        self.params = tree_to(
            {k: params[k] for k in self._DECODE_KEEP if k in params},
            self.device)
        # the full tree, for the lazily-built endpoint encoder
        self._full_params = params
        self._encoder = None
        self._chunk_fn = make_chunk_step(model, hps, self.chunk,
                                         self.params, self.greedy)

    @property
    def encoder(self):
        """This engine's fixed-geometry endpoint encode program, built on
        first encoder-endpoint use; needs ``hps.conditional``."""
        if self._encoder is None:
            if not self.hps.conditional:
                raise ValueError(
                    "encoder endpoints (complete/reconstruct) need a "
                    "conditional model, but hps.conditional is false")
            from sketch_rnn_tpu_torch.serve.endpoints import EncodeProgram
            self._encoder = EncodeProgram(
                self.model, self.hps, self._full_params, rows=self.slots,
                device=self.device)
        return self._encoder

    # -- the request pool --------------------------------------------------

    def _prepare_pool(self, requests: List[Request]):
        """Build + upload the request pool ``[N, ...]`` once per burst.

        Host side the key words are uint32 ``[N, 2]`` (the JAX engine's
        raw key data); on the device they are int64 holding those uint32
        values, since torch has no full uint32 arithmetic.
        """
        hps = self.hps
        n = len(requests)
        for i, req in enumerate(requests):
            if req.endpoint == "interpolate" and req.parent_uid is None:
                raise ValueError(
                    f"request {i}: interpolate requests must be "
                    f"expanded into frame rows by serve/endpoints."
                    f"plan_batch before engine.run")
            if (req.endpoint == "complete" and req.init_carry is None) \
                    or (req.endpoint == "reconstruct" and req.z is None):
                raise ValueError(
                    f"request {i}: endpoint {req.endpoint!r} carries "
                    f"no planned decode state — run it through "
                    f"serve/endpoints.plan_batch (the encode phase) "
                    f"before engine.run")
        key_data = np.stack([key_words(req.key) for req in requests])
        z = None
        if hps.conditional:
            missing = [i for i, r in enumerate(requests) if r.z is None]
            if missing:
                raise ValueError(
                    f"conditional model: requests {missing[:5]} need z")
            z = np.stack([np.asarray(r.z, np.float32) for r in requests])
        labels = (np.asarray([r.label for r in requests], np.int64)
                  if hps.num_classes > 0 else None)
        temps = np.asarray([r.temperature for r in requests], np.float32)
        caps = np.asarray([r.max_len or self.max_len for r in requests],
                          np.int32)
        over = [i for i, c in enumerate(caps) if c > self.max_len]
        if over:
            raise ValueError(
                f"requests {over[:5]} exceed engine max_len "
                f"{self.max_len}")
        # planned decode state: present only when some request carries a
        # replayed carry (pure-generate pools keep None leaves)
        init_carry = init_prev = init_mask = None
        if any(r.init_carry is not None for r in requests):
            cw = self.model.dec.carry_size
            init_carry = np.zeros((n, cw), np.float32)
            init_prev = np.zeros((n, 5), np.float32)
            init_mask = np.zeros((n,), bool)
            for i, r in enumerate(requests):
                if r.init_carry is None:
                    continue
                ic = np.asarray(r.init_carry, np.float32)
                if ic.shape != (cw,):
                    raise ValueError(
                        f"request {i}: init_carry shape {ic.shape} != "
                        f"({cw},) (the decoder cell's flat carry)")
                init_carry[i] = ic
                init_prev[i] = np.asarray(r.init_prev, np.float32)
                init_mask[i] = True
        key_data = key_data.astype(np.int64)
        return tuple(None if a is None
                     else torch.from_numpy(a).to(self.device)
                     for a in (key_data, z, labels, temps, caps,
                               init_carry, init_prev, init_mask))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array to the device without blocking the host (a
        copy: the scheduler goes on writing ``a``)."""
        return to_device(torch.from_numpy(a.copy()), self.device)

    # -- the serving loop --------------------------------------------------

    def run(self, requests: List[Request]) -> Dict[str, Any]:
        """Drive ``requests`` to completion with continuous batching.

        Returns ``{"results": [Result...], "metrics": {...}}``; the
        metrics carry the JAX engine's keys except its telemetry-derived
        ``tail``/``spans``/``slo``. Latency clocks start at ``run()``
        entry.
        """
        t_start = time.perf_counter()
        for i, req in enumerate(requests):
            if req.uid is None:
                req.uid = i
        queue = deque(enumerate(requests))
        pool = self._prepare_pool(requests) if requests else None
        admit_t: Dict[int, float] = {}
        slot_req: List[Optional[Request]] = [None] * self.slots
        results: List[Result] = []
        n_chunks = 0
        live_slot_steps = 0
        host_syncs = 0
        nslots = self.slots
        dev = self.device

        # device-resident loop state (an opaque round-trip); the host owns
        # only the two [B] scheduling vectors
        carry = self.model.dec.carry_leaves(
            self.model.dec.initial_carry(nslots, device=dev))
        prev = START_TOKEN.to(dev).expand(nslots, 5).contiguous()
        t_dev = torch.zeros((nslots,), dtype=torch.int32, device=dev)
        done_dev = torch.ones((nslots,), dtype=torch.bool, device=dev)
        slot_idx = np.zeros((nslots,), np.int64)
        reset = np.zeros((nslots,), bool)
        # the dispatch index each slot's occupant FIRST runs in: under
        # pipelining one in-flight chunk still reports the PREVIOUS
        # occupant's (done) state for freshly admitted slots
        first_chunk = np.zeros((nslots,), np.int64)
        n_disp = 0
        t_host = np.zeros((nslots,), np.int32)

        def admit_free_slots():
            now = time.perf_counter()
            for b in range(nslots):
                if not queue:
                    break
                if slot_req[b] is None:
                    idx, req = queue.popleft()
                    slot_idx[b] = idx
                    reset[b] = True
                    first_chunk[b] = n_disp  # the next dispatch
                    slot_req[b] = req
                    admit_t[req.uid] = now

        def dispatch():
            """Launch one chunk; returns its staged outputs and its
            dispatch index."""
            nonlocal carry, prev, t_dev, done_dev, n_disp
            carry, prev, t_dev, done_dev, strokes_dev = self._chunk_fn(
                carry, prev, t_dev, done_dev, self._to_device(reset),
                self._to_device(slot_idx), pool)
            out = Staged((t_dev, done_dev, strokes_dev))
            reset[:] = False
            cidx = n_disp
            n_disp += 1
            return out, cidx

        # Depth-1 pipelining: chunk i+1 is dispatched BEFORE chunk i's
        # outputs are fetched, so the host's fetch/collect/admit work
        # overlaps device compute. A freed slot therefore idles one extra
        # chunk before its next request starts — scheduling delay only.
        # Stroke collection is deferred to completion: fetched chunk
        # outputs wait in a ring of ceil(max_len / K) + 2 entries.
        ring: Dict[int, Any] = {}   # cidx -> (t, strokes)
        horizon = -(-self.max_len // self.chunk) + 2
        engaged_steps = 0
        occupied = np.zeros((nslots,), bool)
        attr_steps: Dict[int, int] = {}
        idle_steps = 0

        def gather(b: int, cidx: int) -> np.ndarray:
            """Reassemble slot ``b``'s strokes from the ring at its
            completion in chunk ``cidx``."""
            parts = []
            for c in range(int(first_chunk[b]), cidx + 1):
                t_c, s_c = ring[c]
                base = (0 if c == first_chunk[b]
                        else int(ring[c - 1][0][b]))
                rows = int(t_c[b]) - base
                if rows:
                    parts.append(s_c[:rows, b])
            return np.concatenate(parts)

        admit_free_slots()
        occupied[:] = [r is not None for r in slot_req]
        n_live = int(occupied.sum())
        inflight = dispatch() if requests else None
        while n_live:
            # admissions decided from chunk i-1 ride dispatch i+1
            (fut, cidx), inflight = inflight, dispatch()
            t_prev = t_host    # chunk cidx-1's t: the row-delta base
            t_host, done, strokes = fut.fetch()
            host_syncs += 1
            n_chunks += 1
            t = t_host
            now = time.perf_counter()
            ring[cidx] = (t, strokes)
            ring.pop(cidx - horizon, None)
            eligible = occupied & (first_chunk <= cidx)
            base = np.where(first_chunk == cidx, 0, t_prev)
            live_slot_steps += int((t - base)[eligible].sum())
            engaged_steps += int(eligible.sum()) * self.chunk
            live_idx = np.nonzero(eligible)[0]
            if len(live_idx):
                shares = attribute_chunk_steps(self.chunk, len(live_idx))
                for share, b in zip(shares, live_idx):
                    uid = slot_req[b].uid
                    attr_steps[uid] = attr_steps.get(uid, 0) + share
            else:
                idle_steps += self.chunk
            for b in np.nonzero(eligible & done)[0]:
                req = slot_req[b]
                s5 = gather(int(b), cidx)
                steps = int(t[b])
                length = steps - int(s5[-1, 4] > 0.5)
                results.append(Result(
                    uid=req.uid, strokes5=s5, length=length, steps=steps,
                    queue_wait_s=admit_t[req.uid] - t_start,
                    decode_s=now - admit_t[req.uid],
                    latency_s=now - t_start,
                    attributed_steps=attr_steps.get(req.uid, 0),
                    endpoint=req.endpoint or "generate"))
                slot_req[b] = None
                occupied[b] = False
                n_live -= 1
            if queue:
                admit_free_slots()
                occupied[:] = [r is not None for r in slot_req]
                n_live = int(occupied.sum())
        if inflight is not None:
            # drain the last in-flight (all-frozen) chunk: its steps served
            # no request, so they land in the idle bucket
            inflight[0].fetch()
            host_syncs += 1
            n_chunks += 1
            idle_steps += self.chunk

        wall = time.perf_counter() - t_start
        lat = np.array([r.latency_s for r in results]) if results else \
            np.zeros((1,))
        decode_steps = int(sum(r.steps for r in results))
        return {"results": results, "metrics": {
            "completed": len(results),
            "wall_s": round(wall, 6),
            "sketches_per_sec": round(len(results) / wall, 3) if wall
            else 0.0,
            "decode_steps": decode_steps,
            "device_steps": n_chunks * self.chunk,
            "chunks": n_chunks,
            "dispatches": n_disp,
            "dispatches_saved": n_disp * self.chunk - n_disp,
            "host_syncs": host_syncs,
            "steps_attributed": int(sum(attr_steps.values())),
            "steps_idle": int(idle_steps),
            "accepted_steps_per_device_step": round(
                decode_steps / max(engaged_steps, 1), 4),
            "slot_utilization": round(
                live_slot_steps / max(n_chunks * self.chunk * self.slots,
                                      1), 4),
            "queue_wait_mean_s": round(
                float(np.mean([r.queue_wait_s for r in results]))
                if results else 0.0, 6),
            "latency_p50_s": round(float(np.percentile(lat, 50)), 6),
            "latency_p95_s": round(float(np.percentile(lat, 95)), 6),
            "latency_p99_s": round(float(np.percentile(lat, 99)), 6),
            "decode_kernel": "plain" if self.hps.dec_model == "hyper"
            else "cuda",
        }}
