"""Multi-task serving endpoints: completion, reconstruction, interpolation.

The port of ``sketch_rnn_tpu/serve/endpoints.py`` for the single-engine
path (the fleet's shared-prefix encode reuse comes with the fleet):

- ``generate``    — the engine's native path, untouched.
- ``complete``    — encode a stroke-3 ``prefix`` with the bidirectional
  encoder (posterior mean), seed the decoder carry by REPLAYING the
  prefix teacher-forced through the CUDA kernel
  ``ops/cuda_decode.replay_chunk`` (for the ``hyper`` decoder, which has
  no decode kernel in either package, through a plain loop of cell steps:
  the counterpart of the JAX package's replay scan), then decode the
  continuation through the normal chunked pool.
- ``reconstruct`` — encode a full sketch -> z = mu -> a plain decode
  conditioned on it.
- ``interpolate`` — encode TWO sketches, slerp a ``frames``-latent grid
  between their means (``sample/interpolate.py``, the function the
  offline path uses) and decode the grid as ``frames`` child rows; the
  parent books ONE result carrying the frames (:func:`assemble_results`).

**The fixed-geometry encode program.** :class:`EncodeProgram` pads every
prefix to a small ladder of bucket edges (``hps.serve_prefix_edges``,
default :func:`default_prefix_edges`) and a FIXED row count (the
engine's slot width), exactly like the JAX package, so a prefix encodes
the same way in both packages: the encoder's final states are selected
at ``seq_len`` and the replay masks carry updates at ``t < seq_len``,
so padding does not reach the outputs.

**Planning contract.** Everything here is a pure function of (prefix,
params): the planner stamps derived decode state onto requests (``z`` /
``init_carry`` / ``init_prev``) and expands interpolations into child
rows keyed ``fold_in(parent_key, frame)``, then the engine's
per-request RNG takes over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.ops.cuda_decode import (cast_weights,
                                                  check_cell_kind,
                                                  replay_chunk)
from sketch_rnn_tpu_torch.sample.interpolate import interpolate_latents
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.device import resolve_device, tree_to

ENDPOINTS = ("generate", "complete", "reconstruct", "interpolate")

# default latent-grid size of an interpolate request; Request.frames
# overrides it per request
DEFAULT_FRAMES = 10

# interpolation FRAME rows get engine uids far above any real request
# uid: child_uid = CHILD_UID_BASE + parent_uid * CHILD_UID_STRIDE +
# frame, collision-free for parent uids < 2**28 at frames < 4096
CHILD_UID_BASE = 1 << 40
CHILD_UID_STRIDE = 4096


def default_prefix_edges(max_seq_len: int) -> Tuple[int, ...]:
    """The prefix-pad ladder used when ``hps.serve_prefix_edges`` is
    unset: powers of two below ``max_seq_len`` plus the terminal edge."""
    return tuple(e for e in (32, 64, 128) if e < max_seq_len) \
        + (int(max_seq_len),)


def prefix_edges(hps: HParams) -> Tuple[int, ...]:
    """The effective prefix bucket ladder (configured or default)."""
    edges = tuple(hps.serve_prefix_edges) or \
        default_prefix_edges(hps.max_seq_len)
    if edges[-1] < hps.max_seq_len:
        edges = edges + (hps.max_seq_len,)
    return edges


def prefix_edge_of(length: int, edges: Sequence[int]) -> int:
    """Smallest edge that fits a ``length``-row prefix."""
    for e in edges:
        if length <= e:
            return int(e)
    raise ValueError(f"prefix length {length} exceeds the terminal "
                     f"edge {edges[-1]}")


def _check_prefix(prefix, edges: Sequence[int], what: str) -> np.ndarray:
    try:
        p = np.asarray(prefix, np.float32)
    except (ValueError, TypeError) as e:
        raise ValueError(f"{what}: prefix is not a stroke-3 array "
                         f"({e})") from None
    if p.ndim != 2 or p.shape[1] != 3 or len(p) < 1:
        raise ValueError(f"{what}: prefix must be a stroke-3 "
                         f"[n >= 1, 3] array, got shape {p.shape}")
    if len(p) > edges[-1]:
        raise ValueError(f"{what}: prefix has {len(p)} rows but the "
                         f"terminal prefix edge is {edges[-1]} "
                         f"(= max_seq_len)")
    if not np.isfinite(p).all():
        raise ValueError(f"{what}: prefix contains non-finite values")
    return p


def validate_request(req, hps: HParams) -> None:
    """Fail-fast endpoint/shape validation with one actionable line;
    unconditional checkpoints reject every encoder endpoint naming
    ``hps.conditional``."""
    ep = req.endpoint or "generate"
    if ep not in ENDPOINTS:
        raise ValueError(f"unknown endpoint {ep!r}; this server "
                         f"speaks {ENDPOINTS}")
    if ep == "generate":
        if req.prefix is not None:
            raise ValueError(
                "generate requests carry no prefix (use endpoint="
                "'complete' to continue a stroke prefix)")
        return
    if not hps.conditional:
        raise ValueError(
            f"endpoint {ep!r} needs the bidirectional encoder but "
            f"this checkpoint is unconditional (hps.conditional="
            f"false)")
    edges = prefix_edges(hps)
    if ep == "interpolate":
        pair = req.prefix
        if pair is None or isinstance(pair, np.ndarray) or \
                len(pair) != 2:
            raise ValueError(
                "interpolate requests carry prefix=(sketch_a, "
                "sketch_b) — exactly two stroke-3 arrays")
        frames = int(req.frames) or DEFAULT_FRAMES
        if frames < 2:
            raise ValueError(f"interpolate needs frames >= 2, got "
                             f"{frames}")
        for side, p in zip("ab", pair):
            _check_prefix(p, edges, f"interpolate prefix {side}")
    else:
        _check_prefix(req.prefix, edges, ep)


def pool_rows_of(req) -> int:
    """Decode-pool rows one request occupies: an interpolation decodes
    ``frames`` child rows, everything else exactly one."""
    if (req.endpoint or "generate") == "interpolate":
        return int(req.frames) or DEFAULT_FRAMES
    return 1


# -- the fixed-geometry encode + prefix-replay program ------------------------


def pad_prefixes(prefixes: Sequence[np.ndarray], edge: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stroke-3 prefixes -> the loader's batch layout at pad ``edge``:
    ``strokes [B, edge + 1, 5]`` with the start token at t=0 and
    end-of-sketch rows past each prefix, plus ``seq_len [B]`` (a copy of
    the JAX package's ``data/native_batcher.pad_batch_numpy``)."""
    out = np.zeros((len(prefixes), edge + 1, 5), dtype=np.float32)
    lens = np.empty((len(prefixes),), dtype=np.int32)
    for i, s in enumerate(prefixes):
        s = np.asarray(s, np.float32)
        n = len(s)
        if n > edge:
            raise ValueError(
                f"sequence of length {n} exceeds max_len {edge}")
        out[i, 1:n + 1, 0:2] = s[:, 0:2]
        out[i, 1:n + 1, 3] = s[:, 2]          # p2 = pen lifted
        out[i, 1:n + 1, 2] = 1.0 - s[:, 2]    # p1 = pen down
        out[i, n + 1:, 4] = 1.0               # p3 for the padding
        out[i, 0, :] = [0, 0, 1, 0, 0]
        lens[i] = n
    return out, lens


def make_encode_step(model, hps: HParams, params):
    """Build the encode + prefix-replay step.

    ``fn(strokes [B, E+1, 5], seq_len [B] int32, labels [B]?) -> (mu
    [B, Nz], carry_flat [B, C], prev [B, 5])``:

    - ``mu``: the posterior mean of each prefix (the encoder reads
      ``strokes[:, 1:]``);
    - ``carry_flat``: ``decoder_initial_carry(mu)`` advanced through
      inputs ``START, S_1 .. S_{p-1}`` by ``replay_chunk`` with per-row
      masking at ``t < seq_len``;
    - ``prev``: each row's LAST prefix stroke ``S_p``, the decode loop's
      first input.

    ``carry_flat`` concatenates the carry's tensors in leaf order (``c,
    h``, then the hyper cell's ``hc, hh``). The hyper decoder replays
    through a plain loop of cell steps with the same masking.
    """
    plain = hps.dec_model == "hyper"
    cell = model.dec
    cd = cell.compute_dtype
    if not plain:
        check_cell_kind(hps.dec_model)
        # the kernel's weight matrices in its weight dtype, cast once
        dec_params = cast_weights(params["dec"], cd)

    def fn(strokes, seq_len, labels):
        b = strokes.shape[0]
        x_tm = strokes.transpose(0, 1)                 # [E+1, B, 5]
        mu, _ = model.encode(params, x_tm[1:], seq_len)
        carry = cell.carry_leaves(
            model.decoder_initial_carry(params, mu, b))
        extra = model._decoder_extra(params, mu, labels)
        if plain:
            for s in range(x_tm.shape[0] - 1):
                new_carry, _ = cell(
                    params["dec"], cell.carry_from_leaves(carry),
                    torch.cat([x_tm[s], extra], dim=-1))
                live = (s < seq_len)[:, None]
                carry = tuple(torch.where(live, new, old) for new, old in
                              zip(cell.carry_leaves(new_carry), carry))
        else:
            c0, h0 = carry
            carry = replay_chunk(
                dec_params, c0.contiguous(), h0.contiguous(),
                x_tm[:-1].contiguous(), extra, seq_len,
                cell_kind=hps.dec_model, forget_bias=cell.forget_bias,
                compute_dtype=cd)
        prev = strokes[torch.arange(b, device=strokes.device),
                       seq_len.long()]
        return mu, torch.cat(carry, dim=-1), prev

    return fn


class EncodeProgram:
    """Per-device fixed-geometry endpoint encoder (the pre-decode burst
    phase): every call encodes ``rows`` prefixes padded to one edge."""

    # encode-phase parameter subset
    _KEEP = ("enc_fwd", "enc_bwd", "mu_w", "mu_b", "presig_w",
             "presig_b", "dec", "dec_init_w", "dec_init_b",
             "class_embed")

    def __init__(self, model, hps: HParams, params, rows: int,
                 edges: Optional[Sequence[int]] = None, device=None):
        if not hps.conditional:
            raise ValueError(
                "EncodeProgram needs a conditional model "
                "(hps.conditional=false has no encoder)")
        self.model = model
        self.hps = hps
        self.rows = int(rows)
        if self.rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        self.edges = tuple(edges) if edges else prefix_edges(hps)
        self.device = resolve_device(device)
        self._step = make_encode_step(
            model, hps,
            tree_to({k: params[k] for k in self._KEEP if k in params},
                    self.device))

    def encode(self, prefixes: Sequence[np.ndarray],
               labels: Optional[Sequence[int]] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode ``prefixes`` (stroke-3 arrays); returns ``(mu [n, Nz],
        carry_flat [n, C], prev [n, 5])`` aligned to the input order.

        Prefixes are grouped by their bucket edge (edges ascending, each
        edge's items in input order), each group is chopped into runs of
        at most ``rows`` and padded to ``rows`` with inert one-row
        prefixes — the JAX package's grouping, so both packages encode
        the same rows together.
        """
        n = len(prefixes)
        mu = np.zeros((n, self.hps.z_size), np.float32)
        carry = np.zeros((n, self.model.dec.carry_size), np.float32)
        prev = np.zeros((n, 5), np.float32)
        by_edge: Dict[int, List[int]] = {}
        for i in range(n):
            by_edge.setdefault(
                prefix_edge_of(len(prefixes[i]), self.edges), []).append(i)
        for edge in sorted(by_edge):
            idxs = by_edge[edge]
            for lo in range(0, len(idxs), self.rows):
                chunk = idxs[lo:lo + self.rows]
                group = [prefixes[i] for i in chunk]
                group += [np.zeros((1, 3), np.float32)] * (
                    self.rows - len(group))
                strokes, lens = pad_prefixes(group, edge)
                labs = None
                if self.hps.num_classes > 0:
                    labs = np.zeros((self.rows,), np.int64)
                    if labels is not None:
                        for j, i in enumerate(chunk):
                            labs[j] = int(labels[i])
                    labs = torch.from_numpy(labs).to(self.device)
                out = self._step(
                    torch.from_numpy(strokes).to(self.device),
                    torch.from_numpy(lens).to(self.device), labs)
                g_mu, g_carry, g_prev = (o.cpu().numpy() for o in out)
                for j, i in enumerate(chunk):
                    mu[i] = g_mu[j]
                    carry[i] = g_carry[j]
                    prev[i] = g_prev[j]
        return mu, carry, prev


# -- planning & assembly ------------------------------------------------------


@dataclasses.dataclass
class BatchPlan:
    """One burst's endpoint plan: the decode-pool request list
    (originals stamped with derived state, interpolations replaced by
    their frame children) plus the parent assembly map."""

    engine_requests: List[Any]
    # parent uid -> its frames' uids, in frame order
    parents: Dict[int, List[int]]


def child_uid(parent_uid: int, frame: int) -> int:
    return CHILD_UID_BASE + int(parent_uid) * CHILD_UID_STRIDE \
        + int(frame)


def _child_key(key, frame: int) -> np.ndarray:
    """``fold_in(key, frame)`` as two uint32 words."""
    words = torch.from_numpy(prng.key_words(key).astype(np.int64))
    return prng.fold_in(words, frame).numpy().astype(np.uint32)


def plan_batch(engine, requests: Sequence[Any]) -> BatchPlan:
    """Run the encode phase for one burst and build its decode plan.

    Pure-generate bursts pass through as an identity plan.
    Encoder-endpoint requests are stamped IN PLACE with their derived
    decode state, deterministic in (prefix, params); both sides of every
    interpolation are encoded in the same one encode call. Each
    interpolation expands into ``frames`` child rows keyed
    ``fold_in(parent_key, frame)`` whose z are the slerp grid between the
    two means; the parent books one result at :func:`assemble_results`.
    """
    needs = [r for r in requests
             if (r.endpoint or "generate") != "generate"
             and r.parent_uid is None]
    if not needs:
        return BatchPlan(list(requests), {})
    for r in needs:
        validate_request(r, engine.hps)
        if r.uid is None:
            raise ValueError(
                "endpoint requests need explicit uids before planning "
                "(serve_requests assigns them)")
    jobs: List[Tuple[Any, int, np.ndarray]] = []  # (req, side, prefix)
    for r in needs:
        if r.endpoint == "interpolate":
            jobs.append((r, 0, np.asarray(r.prefix[0], np.float32)))
            jobs.append((r, 1, np.asarray(r.prefix[1], np.float32)))
        else:
            jobs.append((r, 0, np.asarray(r.prefix, np.float32)))
    labels = ([j[0].label for j in jobs] if engine.hps.num_classes > 0
              else None)
    mu, carry, prev = engine.encoder.encode([j[2] for j in jobs], labels)
    enc_of = {(id(j[0]), j[1]): k for k, j in enumerate(jobs)}

    engine_requests: List[Any] = []
    parents: Dict[int, List[int]] = {}
    for r in requests:
        ep = r.endpoint or "generate"
        if ep == "generate" or r.parent_uid is not None:
            engine_requests.append(r)
            continue
        k = enc_of[(id(r), 0)]
        if ep == "reconstruct":
            r.z = mu[k]
            engine_requests.append(r)
        elif ep == "complete":
            r.z = mu[k]
            r.init_carry = carry[k]
            r.init_prev = prev[k]
            engine_requests.append(r)
        else:  # interpolate
            frames = int(r.frames) or DEFAULT_FRAMES
            grid = interpolate_latents(
                torch.from_numpy(mu[k]),
                torch.from_numpy(mu[enc_of[(id(r), 1)]]), n=frames).numpy()
            kids = [dataclasses.replace(
                r, uid=child_uid(r.uid, f), key=_child_key(r.key, f),
                z=grid[f], prefix=None, frames=0, parent_uid=r.uid)
                for f in range(frames)]
            engine_requests += kids
            parents[r.uid] = [c.uid for c in kids]
    return BatchPlan(engine_requests, parents)


def assemble_results(plan: BatchPlan, engine_results: Sequence[Any]
                     ) -> List[Any]:
    """Fold one burst's engine results back to request-level results.

    Non-interpolate results pass through; each interpolate parent books
    ONE result whose ``frames`` hold the per-frame strokes (``strokes5``
    is their concatenation), whose latency spans arrival to the last
    frame, and whose ``attributed_steps`` is the exact integer sum of its
    frames'."""
    from sketch_rnn_tpu_torch.serve.engine import Result

    if not plan.parents:
        return list(engine_results)
    child_parent = {c: puid for puid, kids in plan.parents.items()
                    for c in kids}
    by_uid = {r.uid: r for r in engine_results}
    out: List[Any] = []
    done_parents = set()
    for r in engine_results:
        puid = child_parent.get(r.uid)
        if puid is None:
            out.append(r)
            continue
        if puid in done_parents:
            continue
        kids = [by_uid.get(c) for c in plan.parents[puid]]
        if any(k is None for k in kids):
            continue  # a later result completes the grid
        done_parents.add(puid)
        frames = [k.strokes5 for k in kids]
        queue_wait = min(k.queue_wait_s for k in kids)
        latency = max(k.latency_s for k in kids)
        out.append(Result(
            uid=puid, strokes5=np.concatenate(frames),
            length=sum(k.length for k in kids),
            steps=sum(k.steps for k in kids), queue_wait_s=queue_wait,
            decode_s=latency - queue_wait, latency_s=latency,
            attributed_steps=sum(k.attributed_steps for k in kids),
            endpoint="interpolate", frames=frames))
    return out


def serve_requests(model, hps: HParams, params, requests: List[Any],
                   slots: int = 0, chunk: int = 0,
                   max_len: Optional[int] = None, greedy: bool = False,
                   engine=None, device=None) -> Dict[str, Any]:
    """One-call multi-task API: plan the endpoint batch, serve it through
    a (given or fresh) engine, assemble request-level results. Runs on
    the card unless ``device="cpu"``. ``cli sample --interpolate`` and
    ``--reconstruct`` ride this path, so their strokes are the
    endpoints' on the same checkpoint, key and serving geometry."""
    from sketch_rnn_tpu_torch.serve.engine import ServeEngine

    eng = engine or ServeEngine(model, hps, params, slots=slots,
                                chunk=chunk, max_len=max_len,
                                greedy=greedy, device=device)
    for i, req in enumerate(requests):
        if req.uid is None:
            req.uid = i
        validate_request(req, hps)
    plan = plan_batch(eng, requests)
    out = eng.run(plan.engine_requests)
    return {"results": assemble_results(plan, out["results"]),
            "metrics": out["metrics"], "engine": eng}
