"""Replicated serving fleet: per-device engines behind one scheduler.

The port of the core of ``sketch_rnn_tpu/serve/fleet.py``:

- **One replica per device.** Each replica is a full
  :class:`~sketch_rnn_tpu_torch.serve.engine.ServeEngine` whose params,
  request pool and loop state live on its device, so R replicas run R
  independent engines with no communication between cards. ``devices``
  defaults to every CUDA device (one replica on a one-card machine);
  with no card it raises, never falls back to the CPU. Tests pass
  ``devices=[torch.device("cpu")] * R``.
- **One host-side scheduler.** ``submit()`` stamps the arrival time and
  admission class, asks the :class:`~sketch_rnn_tpu_torch.serve.
  admission.AdmissionController` for a placement (least-loaded replica
  queue, or shed), and wakes that replica's worker thread. It makes no
  CUDA call. Workers drain their queues in class-priority order into
  **micro-bursts** (:func:`form_burst`, the JAX package's
  ``GeometryRunScheduler.form_burst`` as a plain function): up to
  ``pool_cap`` decode-pool rows served through one ``engine.run(...,
  pool_pad=pool_cap)`` call under ``torch.cuda.device(replica)``.
- **Placement is invisible to outputs.** A request's strokes are a pure
  function of the request (the engine's per-request
  ``fold_in(key, t)``), so the fleet only chooses where and when: its
  strokes are bitwise the single engine's.
- **Failover.** A burst that raises marks its replica dead: the burst and
  the replica's queue are requeued to the survivors under a per-request
  ``retry_budget`` with ``utils/faults.backoff_s``, and admission
  shrinks to the surviving capacity. A request whose budget is spent is
  recorded in ``failed``; the death of the last replica fails the fleet
  (``drain()`` raises "fleet worker failed").

- **Result cache** (``cache=``, ``serve/cache.ResultCache``): ``submit``
  fingerprints a request's content and serves a stored hit at the door
  (``cached=True``, zero attributed steps, the origin's strokes and
  ckpt_id); a repeat whose content is still in flight waits on it and is
  served its strokes at completion (coalescing), or fails with it, so
  the misses that compute are the distinct contents.
- **Tenants** (``tenants=``, ``serve/tenants.TenantStore``): ``params`` is
  the base tree, every engine is value-paged and all replicas share one
  ``PrefixReuseIndex``. Bursts are single-tenant (``form_burst``'s group
  stop); before a burst the worker pages its replica to the burst's
  tenant with ``swap_params`` (a value copy). Fingerprints are taken
  under the tenant's ckpt_id, ``tenant_cap`` caps a tenant's outstanding
  rows at admission, and ``tenant_slos`` judge each tenant on its own.

Every started fleet registers process-wide (:func:`stop_all`). The JAX
fleet's elastic replicas come with ROADMAP queue 1 item 5b-ii, its
telemetry and fault sites with item 7, its draft arguments with item 6:
their arguments raise, naming the item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.serve import endpoints as endpoints_mod
from sketch_rnn_tpu_torch.serve.admission import (DEFAULT_CLASS,
                                                  AdmissionClass,
                                                  AdmissionController,
                                                  parse_admission_classes)
from sketch_rnn_tpu_torch.serve.engine import (_ITEM_6, _LATER, Request,
                                               Result, ServeEngine)
from sketch_rnn_tpu_torch.serve.slo import SLOTracker
from sketch_rnn_tpu_torch.serve.tenants import PrefixReuseIndex
from sketch_rnn_tpu_torch.utils.faults import backoff_s

_ITEM_5B_II = ("ROADMAP queue 1 item 5b-ii (elastic replicas, rollout, "
               "metrics_http.py)")

# worker threads' name prefix
THREAD_PREFIX = "torch-fleet-replica-"

# every live fleet, for the no-stray-threads check
_LIVE: set = set()
_LIVE_LOCK = threading.Lock()
_UNSET = object()


def default_pool_cap(slots: int) -> int:
    """The micro-burst ceiling when none is configured: 4x the slot
    width. The CLI's checks before the restore use it too."""
    return 4 * int(slots)


def form_burst(queues: Iterable, cap: int, cost_of: Callable[[Any], int],
               group_of: Optional[Callable[[Any], Any]] = None
               ) -> List[Any]:
    """Pop a priority-ordered micro-burst: walk ``queues`` (deques,
    highest priority first), popping heads while the summed ``cost_of``
    fits ``cap``; stop at the first head that does not fit and, when
    ``group_of`` is given, at the first head whose group differs from
    the first popped item's. Never skips past a blocked head, so
    priority order is never violated."""
    batch: List[Any] = []
    used = 0
    group: Any = _UNSET
    for q in queues:
        while q and used < cap:
            if group is not _UNSET and group_of is not None \
                    and group_of(q[0]) != group:
                return batch
            cost = cost_of(q[0])
            if used + cost > cap:
                return batch
            item = q.popleft()
            if group is _UNSET and group_of is not None:
                group = group_of(item)
            batch.append(item)
            used += cost
        if used >= cap:
            break
    return batch


def default_devices() -> List[torch.device]:
    """Every CUDA device; with none, an error (never the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ServeFleet places one replica on each CUDA device and "
            "torch.cuda.is_available() is False; pass devices="
            "[torch.device('cpu')] * R to serve through the plain PyTorch "
            "versions of the kernels on the CPU")
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Replica:
    """One device's engine and its per-class queues (scheduler-owned)."""

    def __init__(self, idx: int, device, engine: ServeEngine,
                 class_order: Sequence[str]):
        self.idx = idx
        self.device = device
        self.engine = engine
        # drained in priority order (class_order is priority-sorted)
        self.queues: Dict[str, deque] = {c: deque() for c in class_order}
        self.cond: Optional[threading.Condition] = None  # set by fleet
        self.thread: Optional[threading.Thread] = None
        # a dead replica's worker has exited and admission no longer
        # places on it
        self.dead = False
        self.death: Optional[str] = None
        # engine metrics summed over micro-bursts
        self.completed = 0
        self.bursts = 0
        self.chunks = 0
        self.device_steps = 0
        self.live_slot_steps = 0.0
        self.attributed_steps = 0
        self.idle_steps = 0
        self.tenant_swaps = 0

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def pop_batch(self, cap: int) -> List[Request]:
        """Queued requests in class-priority order, chopped by decode-pool
        rows (an interpolation costs its ``frames``) to fit ``cap``, and
        stopped at the first head of another tenant than the first: a
        burst runs on one tenant's params."""
        return form_burst(self.queues.values(), cap,
                          cost_of=endpoints_mod.pool_rows_of,
                          group_of=lambda r: r.tenant or "")


class ServeFleet:
    """R device-pinned engines, one SLA-aware scheduler, thread workers.

    Lifecycle: construct -> (optionally) ``warm`` -> ``submit`` any
    number of requests (before or after ``start``) -> ``start`` ->
    ``drain`` -> ``close`` (or use it as a context manager). Submissions
    before ``start`` are placed deterministically (backlog changes only
    through submits), which the closed-burst tests rely on.
    """

    def __init__(self, model, hps: HParams, params, replicas: int = 0,
                 slots: int = 0, chunk: int = 0,
                 max_len: Optional[int] = None, greedy: bool = False,
                 classes: Optional[Dict[str, AdmissionClass]] = None,
                 devices: Optional[Sequence[Any]] = None,
                 pool_cap: int = 0, queue_cap: int = 0,
                 shed_margin: float = 1.0, slo=None,
                 retry_budget: int = 2,
                 retry_backoff_s: float = 0.05,
                 max_replicas: int = 0, cache=None,
                 endpoint_classes: Optional[Dict[str, str]] = None,
                 ckpt_id: str = "", draft_params=None,
                 draft_depth: int = 0,
                 draft_tol: Optional[float] = None,
                 tenants=None, tenant_cap: int = 0,
                 tenant_slos: Optional[Dict[str, List]] = None):
        if max_replicas:
            raise NotImplementedError(
                f"ServeFleet(max_replicas) {_LATER}: {_ITEM_5B_II}")
        if (draft_params is not None or draft_depth
                or draft_tol is not None):
            raise NotImplementedError(
                f"speculative decoding (draft_params, draft_depth, "
                f"draft_tol) {_LATER}: {_ITEM_6}")
        devices = [torch.device(d) for d in (
            devices if devices is not None else default_devices())]
        n = int(replicas) if replicas else len(devices)
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        if n > len(devices):
            raise ValueError(
                f"{n} replicas need {n} devices but only "
                f"{len(devices)} are available")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got "
                             f"{retry_budget}")
        self.hps = hps
        self.slots = int(slots or hps.serve_slots)
        self.chunk = int(chunk or hps.serve_chunk)
        # the micro-burst ceiling and the pool size every burst pads to
        self.pool_cap = int(pool_cap or default_pool_cap(self.slots))
        if self.pool_cap < 1:
            raise ValueError(f"pool_cap must be >= 1, got {self.pool_cap}")
        # endpoint -> admission class, for requests submitted without one
        self.endpoint_classes = dict(endpoint_classes) \
            if endpoint_classes else {}
        self.classes = dict(classes) if classes else \
            parse_admission_classes([])
        class_order = [c.name for c in sorted(self.classes.values(),
                                              key=lambda c: c.priority)]
        self._default_class = class_order[0] if len(class_order) == 1 \
            else None
        bad_routes = sorted(c for c in self.endpoint_classes.values()
                            if c not in self.classes)
        if bad_routes:
            raise ValueError(
                f"endpoint_classes route to undeclared admission "
                f"class(es) {bad_routes}; declared: "
                f"{sorted(self.classes)}")
        # multi-tenant paging: params is the shared base tree
        self.tenants = tenants
        self.tenant_cap = int(tenant_cap)
        self._tenant_slos_cfg = {t: list(v)
                                 for t, v in (tenant_slos or {}).items()}
        self._tenant_slo = {t: SLOTracker(v)
                            for t, v in self._tenant_slos_cfg.items()}
        self.encode_reuse = (PrefixReuseIndex()
                             if tenants is not None else None)
        if tenants is not None and not ckpt_id:
            ckpt_id = tenants.base_ckpt_id
        self._admission = AdmissionController(
            self.classes, n_replicas=n, slots=self.slots,
            queue_cap=queue_cap, shed_margin=shed_margin,
            tenant_cap=self.tenant_cap)
        self._slo = slo
        self._lock = threading.Lock()
        self._done_cv = threading.Condition(self._lock)
        self._replicas: List[_Replica] = []
        for r in range(n):
            with on_device(devices[r]):
                eng = ServeEngine(model, hps, params, slots=self.slots,
                                  chunk=self.chunk, max_len=max_len,
                                  greedy=greedy, device=devices[r],
                                  replica_id=r, ckpt_id=ckpt_id,
                                  param_args=tenants is not None)
            eng.encode_reuse = self.encode_reuse
            rep = _Replica(r, devices[r], eng, class_order)
            rep.cond = threading.Condition(self._lock)
            self._replicas.append(rep)
        self.serving_ckpt_id = str(ckpt_id or "")
        # consulted in submit() before admission; assignable between runs
        self.cache = cache
        self.retry_budget = int(retry_budget)
        self.retry_backoff_s = float(retry_backoff_s)
        self._reset_books()
        self._stop = False
        self._started = False
        self._error: Optional[BaseException] = None

    def _reset_books(self) -> None:
        self._fp_of: Dict[int, bytes] = {}     # uid -> fingerprint
        self._pending: Dict[bytes, List] = {}  # fp -> coalesced waiters
        self._next_uid = 0
        self._seen_uids: set = set()
        self._submitted = 0
        self._shed: List[Dict] = []
        self._results: Dict[int, Dict] = {}     # uid -> record
        self._failed: Dict[int, Dict] = {}      # uid -> failure record
        self._retries: Dict[int, int] = {}      # uid -> requeue count
        self._requeues = 0
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    @property
    def n_live(self) -> int:
        """Replicas in the placement set (not dead)."""
        return sum(1 for r in self._replicas if not r.dead)

    # -- lifecycle ---------------------------------------------------------

    def warm(self, template: Request, endpoints: bool = False) -> None:
        """Run every replica once before a measured window: a 1-step burst
        at the fleet's ``pool_cap`` (the pool size of every later burst),
        so the kernels are loaded and the buffers allocated. ``template``
        supplies valid request fields (z for conditional models); its
        endpoint fields are stripped and a missing z is zero-filled.
        ``endpoints=True`` also runs each replica's encode program at
        every prefix edge and a planned 1-step completion."""
        for rep in self._replicas:
            z = template.z
            if self.hps.conditional and z is None:
                z = np.zeros((self.hps.z_size,), np.float32)
            clone = dataclasses.replace(
                template, uid=None, z=z, max_len=1, cls=None,
                queue_pos=None, enqueue_ts=None, attempt=0,
                endpoint="generate", prefix=None, frames=0,
                parent_uid=None, init_carry=None, init_prev=None)
            with on_device(rep.device):
                rep.engine.run([clone], pool_pad=self.pool_cap)
                if endpoints:
                    rep.engine.encoder.warm()
                    cw = rep.engine.model.dec.carry_size
                    planned = dataclasses.replace(
                        clone, uid=None, endpoint="complete",
                        init_carry=np.zeros((cw,), np.float32),
                        init_prev=np.zeros((5,), np.float32))
                    rep.engine.run([planned], pool_pad=self.pool_cap)

    def start(self) -> "ServeFleet":
        if self._started:
            return self
        self._started = True
        with _LIVE_LOCK:
            _LIVE.add(self)
        for rep in self._replicas:
            if rep.dead:
                continue
            rep.thread = threading.Thread(
                target=self._worker, args=(rep,),
                name=f"{THREAD_PREFIX}{rep.idx}", daemon=True)
            rep.thread.start()
        return self

    def reset(self) -> None:
        """Clear results, sheds and admission state between measurement
        arms (the engines are kept). Only while idle. A cleanly closed
        fleet goes back to its state before ``start``; a fleet with a
        dead replica, or whose close left a live worker, refuses."""
        with self._lock:
            if any(rep.pending() for rep in self._replicas):
                raise RuntimeError("reset with queued work")
            if self._done_locked() < self._submitted:
                raise RuntimeError("reset with requests in flight")
            if self._stop:
                lingering = [rep.thread.name for rep in self._replicas
                             if rep.thread is not None
                             and rep.thread.is_alive()]
                if lingering:
                    raise RuntimeError(
                        f"reset on a closed fleet with live worker "
                        f"thread(s) {lingering} — close() timed out; "
                        f"build a fresh fleet instead")
            if any(rep.dead for rep in self._replicas):
                raise RuntimeError(
                    f"reset on a degraded fleet (dead replicas: "
                    f"{[r.idx for r in self._replicas if r.dead]}); "
                    f"build a fresh fleet instead")
            if self._stop:
                self._stop = False
                self._started = False
            self._admission = AdmissionController(
                self.classes, n_replicas=self.n_replicas,
                slots=self.slots, queue_cap=self._admission.queue_cap,
                shed_margin=self._admission.shed_margin,
                tenant_cap=self.tenant_cap)
            # fresh per-tenant verdicts and a cold reuse index: both are
            # measured-window quantities
            self._tenant_slo = {t: SLOTracker(v)
                                for t, v in self._tenant_slos_cfg.items()}
            if self.encode_reuse is not None:
                self.encode_reuse = PrefixReuseIndex()
                for rep in self._replicas:
                    rep.engine.encode_reuse = self.encode_reuse
            self._reset_books()
            for rep in self._replicas:
                rep.completed = rep.bursts = rep.chunks = 0
                rep.device_steps = 0
                rep.live_slot_steps = 0.0
                rep.attributed_steps = rep.idle_steps = 0
                rep.tenant_swaps = 0

    def close(self, timeout: float = 30.0) -> List[str]:
        """Stop the workers (queued work is abandoned) and unregister.
        Joins each worker under one shared ``timeout`` and returns the
        names of those still alive (empty = clean), also said on
        stderr."""
        with self._lock:
            self._stop = True
            for rep in self._replicas:
                rep.cond.notify_all()
            self._done_cv.notify_all()
        deadline = time.perf_counter() + timeout
        stragglers: List[str] = []
        for rep in self._replicas:
            t = rep.thread
            if t is None:
                continue
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
            if t.is_alive():
                stragglers.append(t.name)
        if stragglers:
            print(f"[fleet] WARNING: close() timed out after {timeout}s "
                  f"waiting for worker thread(s) {stragglers}; they are "
                  f"daemonic and die with the process", file=sys.stderr,
                  flush=True)
        with _LIVE_LOCK:
            _LIVE.discard(self)
        return stragglers

    def __enter__(self) -> "ServeFleet":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "running" if self._started and not self._stop else "idle"
        return (f"ServeFleet({self.n_replicas} replicas x "
                f"B{self.slots}/K{self.chunk}, pool {self.pool_cap}, "
                f"{state})")

    # -- the scheduler -----------------------------------------------------

    def submit(self, req: Request, cls: Optional[str] = None,
               force: bool = False) -> bool:
        """Admit one request: serve it from the cache, attach it to the
        in-flight computation of its content, route it to the
        least-loaded replica queue, or shed it. Returns True iff not
        shed. Thread-safe; makes no CUDA call. ``force`` skips the shed
        checks (same placement)."""
        if (req.endpoint or "generate") != "generate" \
                or req.prefix is not None:
            endpoints_mod.validate_request(req, self.hps,
                                           pool_cap=self.pool_cap)
        cls_name = (cls or req.cls
                    or self.endpoint_classes.get(req.endpoint
                                                 or "generate")
                    or self._default_class)
        if cls_name is None:
            raise ValueError(
                f"request needs an admission class (configured: "
                f"{sorted(self.classes)})")
        # the tenant door: an unknown tenant would fail every burst
        tenant = str(req.tenant or "")
        if self.tenants is not None:
            if tenant not in self.tenants:
                raise ValueError(
                    f"unknown tenant {tenant!r}: registered "
                    f"{sorted(self.tenants.tenants)} (empty string "
                    f"serves the base tree)")
        elif tenant:
            raise ValueError(
                f"request names tenant {tenant!r} but the fleet has "
                f"no TenantStore attached")
        # the content fingerprint outside the lock, under the tenant's
        # serving identity (or the fleet's version)
        fp_ckpt = (self.tenants.ckpt_id_of(tenant)
                   if self.tenants is not None
                   else (self.serving_ckpt_id or None))
        fp = (self.cache.fingerprint(req, ckpt_id=fp_ckpt)
              if self.cache is not None else None)
        with self._lock:
            if self._stop:
                raise RuntimeError("fleet is closed")
            if self._error is not None:
                raise RuntimeError("fleet worker failed") from self._error
            if req.uid is None:
                req.uid = self._next_uid
            if req.uid in self._seen_uids:
                # a twin would overwrite its result and wedge drain()
                raise ValueError(f"duplicate request uid {req.uid}")
            self._seen_uids.add(req.uid)
            self._next_uid = max(self._next_uid, req.uid + 1)
            req.cls = cls_name
            if req.enqueue_ts is None:
                req.enqueue_ts = time.perf_counter()
            if self._t_first_submit is None:
                self._t_first_submit = req.enqueue_ts
            self._submitted += 1
            # a stored hit is served at the door, and a repeat of content
            # in flight waits on it: neither costs a queue row or a step
            if fp is not None:
                entry = self.cache.get(fp)
                if entry is not None:
                    self._book_cache_hit(req, cls_name, entry.strokes5,
                                         entry.length, entry.steps,
                                         entry.origin_uid,
                                         endpoint=entry.endpoint,
                                         frames=entry.frames,
                                         ckpt_id=entry.ckpt_id,
                                         tenant=tenant)
                    return True
                if fp in self._pending:
                    self._pending[fp].append(req)
                    self.cache.note_coalesced()
                    return True
            decision = self._admission.place(
                cls_name, force=force,
                cost=endpoints_mod.pool_rows_of(req), tenant=tenant)
            if decision.shed:
                self._shed.append({"uid": req.uid, "class": cls_name,
                                   "endpoint": req.endpoint
                                   or "generate",
                                   "tenant": tenant,
                                   "reason": decision.shed_reason,
                                   "est_wait_s": decision.est_wait_s})
                self._done_cv.notify_all()
                return False
            req.queue_pos = decision.queue_pos
            rep = self._replicas[decision.replica]
            rep.queues[cls_name].append(req)
            if fp is not None:
                # the primary computation of its content (only once
                # admitted: a shed request anchors no waiters)
                self._pending[fp] = []
                self._fp_of[req.uid] = fp
            rep.cond.notify()
            return True

    def _observe(self, cls_name, tenant: str, res) -> None:
        """Feed one completion to the fleet's SLO (keyed by admission
        class) and to its tenant's (caller holds the lock)."""
        lat = {"queue_wait_s": res.queue_wait_s, "decode_s": res.decode_s,
               "latency_s": res.latency_s}
        if self._slo is not None:
            self._slo.observe(cls_name or DEFAULT_CLASS, lat)
        tslo = self._tenant_slo.get(tenant)
        if tslo is not None:
            tslo.observe(cls_name or DEFAULT_CLASS, lat)

    def _book_cache_hit(self, req: Request, cls_name: Optional[str],
                        strokes5, length: int, steps: int,
                        origin_uid: int, endpoint: str = "generate",
                        frames=None, ckpt_id: str = "",
                        tenant: str = "") -> None:
        """Serve one request from cached strokes (caller holds the lock):
        a ``cached=True`` Result with zero attributed steps and the
        origin's ckpt_id, its small real latency fed to the SLOs."""
        now = time.perf_counter()
        qw = now - req.enqueue_ts
        res = Result(uid=req.uid, strokes5=strokes5, length=length,
                     steps=steps, queue_wait_s=qw, decode_s=0.0,
                     latency_s=qw, attributed_steps=0, cached=True,
                     endpoint=endpoint or "generate", frames=frames,
                     ckpt_id=ckpt_id)
        self._results[req.uid] = {
            "result": res, "replica": None, "class": cls_name,
            "queue_pos": None, "cached": True,
            "endpoint": res.endpoint, "tenant": tenant,
            "origin_uid": origin_uid}
        self._observe(cls_name, tenant, res)
        self._t_last_done = now
        self._done_cv.notify_all()

    def _worker(self, rep: _Replica) -> None:
        """One replica's loop: wait for queued work, pop a micro-burst,
        plan its endpoints and serve it on this replica's device, book the
        completions. A burst that raises fails the replica over
        (:meth:`_on_replica_death`) and ends this thread."""
        while True:
            with self._lock:
                while not rep.pending() and not self._stop:
                    rep.cond.wait()
                if self._stop:
                    return
                batch = rep.pop_batch(self.pool_cap)
            try:
                with on_device(rep.device):
                    # page the replica to the burst's tenant: a value
                    # copy into the engine's resident weights
                    if self.tenants is not None and batch:
                        t = batch[0].tenant or ""
                        if t != rep.engine.serving_tenant:
                            rep.engine.swap_params(
                                self.tenants.materialize(t),
                                ckpt_id=self.tenants.ckpt_id_of(t))
                            rep.engine.serving_tenant = t
                            rep.tenant_swaps += 1
                    # the encode phase, then the decode pool; planning is
                    # deterministic, so a survivor's re-plan of a failed
                    # burst stamps the same state
                    plan = endpoints_mod.plan_batch(rep.engine, batch)
                    out = rep.engine.run(plan.engine_requests,
                                         pool_pad=self.pool_cap)
                    booked = endpoints_mod.assemble_results(
                        plan, out["results"])
            except BaseException as e:  # noqa: BLE001 — failover
                self._on_replica_death(rep, batch, e)
                return
            now = time.perf_counter()
            m = out["metrics"]
            by_uid = {r.uid: r for r in batch}
            with self._lock:
                for res in booked:
                    req = by_uid.get(res.uid)
                    rec = {"result": res, "replica": rep.idx,
                           "endpoint": res.endpoint}
                    if req is not None:
                        rec["class"] = req.cls
                        rec["queue_pos"] = req.queue_pos
                    tn = (req.tenant or "") if req is not None else ""
                    rec["tenant"] = tn
                    self._results[res.uid] = rec
                    self._admission.note_done(
                        rep.idx, res.decode_s,
                        cost=(len(res.frames) if res.frames else 1),
                        tenant=tn)
                    self._observe(rec.get("class"), tn, res)
                    # store the primary's strokes, then serve them to
                    # every repeat that waited on it
                    fp = self._fp_of.pop(res.uid, None)
                    if fp is not None and self.cache is not None:
                        # filed under the version that computed them
                        fp_put = fp
                        if (res.ckpt_id and req is not None
                                and res.ckpt_id != (self.serving_ckpt_id
                                                    or self.cache.ckpt_id)):
                            fp_put = self.cache.fingerprint(
                                req, ckpt_id=res.ckpt_id)
                        self.cache.put(fp_put, res)
                        for w in self._pending.pop(fp, []):
                            self._book_cache_hit(
                                w, w.cls, res.strokes5, res.length,
                                res.steps, res.uid, endpoint=res.endpoint,
                                frames=res.frames, ckpt_id=res.ckpt_id,
                                tenant=w.tenant or "")
                # requests, not engine rows: an interpolation's frames
                # are one request
                rep.completed += len(booked)
                rep.bursts += 1
                rep.chunks += m["chunks"]
                rep.device_steps += m["device_steps"]
                rep.attributed_steps += m["steps_attributed"]
                rep.idle_steps += m["steps_idle"]
                rep.live_slot_steps += (m["slot_utilization"]
                                        * m["chunks"] * self.chunk
                                        * self.slots)
                self._t_last_done = now
                self._done_cv.notify_all()

    def _on_replica_death(self, rep: _Replica, batch: List[Request],
                          exc: BaseException) -> None:
        """Fail one replica over to the survivors: mark it dead, then
        re-place its stranded requests (the burst, which booked nothing,
        and its queue) under the per-request retry budget with
        deterministic exponential backoff. A request past its budget is
        recorded in ``failed`` (it counts as done, so ``drain()``
        completes); the death of the last replica fails the fleet."""
        t_death = time.perf_counter()
        with self._lock:
            rep.dead = True
            rep.death = repr(exc)
            stranded = list(batch)
            for q in rep.queues.values():
                stranded.extend(q)
                q.clear()
            self._admission.mark_dead(rep.idx)
            live = [r for r in self._replicas if not r.dead]
            # stderr: serve-bench's stdout is a JSON report
            print(f"[fleet] WARNING: replica {rep.idx} died mid-burst "
                  f"({exc!r}); failing {len(stranded)} request(s) over "
                  f"to {len(live)} surviving replica(s)",
                  file=sys.stderr, flush=True)
            if not live:
                self._error = exc
                self._stop = True
                for other in self._replicas:
                    other.cond.notify_all()
                self._done_cv.notify_all()
                return
            requeue: List[Request] = []
            max_attempt = 0
            for r in stranded:
                n = self._retries.get(r.uid, 0) + 1
                self._retries[r.uid] = n
                if n <= self.retry_budget:
                    requeue.append(r)
                    max_attempt = max(max_attempt, n)
                else:
                    self._failed[r.uid] = {
                        "uid": r.uid, "class": r.cls,
                        "replica": rep.idx, "retries": n - 1,
                        "reason": f"retry budget ({self.retry_budget}) "
                                  f"exhausted",
                        "error": repr(exc)}
                    # no completion releases the tenant's rows now
                    self._admission.drop_tenant(
                        r.tenant or "",
                        cost=endpoints_mod.pool_rows_of(r))
                    # repeats waiting on this computation fail with it
                    fpx = self._fp_of.pop(r.uid, None)
                    if fpx is not None:
                        for w in self._pending.pop(fpx, []):
                            self._failed[w.uid] = {
                                "uid": w.uid, "class": w.cls,
                                "replica": rep.idx, "retries": 0,
                                "reason": (f"coalesced onto failed "
                                           f"request {r.uid}"),
                                "error": repr(exc)}
        # the backoff outside the lock: submits and completions go on
        if requeue and self.retry_backoff_s > 0:
            time.sleep(backoff_s(self.retry_backoff_s, max_attempt - 1))
        with self._lock:
            for r in requeue:
                # already admitted: never shed or counted again, and the
                # latency clock keeps the original arrival
                decision = self._admission.place(
                    r.cls, requeue=True,
                    cost=endpoints_mod.pool_rows_of(r))
                r.queue_pos = decision.queue_pos
                r.attempt = self._retries[r.uid]
                target = self._replicas[decision.replica]
                target.queues[r.cls].append(r)
                self._requeues += 1
                target.cond.notify()
            self._done_cv.notify_all()

    # -- completion & reporting --------------------------------------------

    def _done_locked(self) -> int:
        """Requests accounted for (caller holds the lock): completed,
        shed at the door, or failed after their retry budget."""
        return len(self._results) + len(self._shed) + len(self._failed)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request completed, was shed, or
        spent its retry budget; False on timeout. Raises when the last
        replica died ("fleet worker failed") or when the fleet was closed
        with work left."""
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        with self._lock:
            while True:
                if self._error is not None:
                    raise RuntimeError(
                        "fleet worker failed") from self._error
                done = self._done_locked()
                if done >= self._submitted:
                    return True
                if self._stop:
                    raise RuntimeError(
                        f"fleet closed while draining "
                        f"({self._submitted - done} requests abandoned)")
                if deadline is not None:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        return False
                    self._done_cv.wait(left)
                else:
                    self._done_cv.wait()

    @property
    def results(self) -> Dict[int, Dict]:
        """uid -> {result, replica, endpoint, class, queue_pos} for every
        completed request."""
        with self._lock:
            return dict(self._results)

    @property
    def shed(self) -> List[Dict]:
        with self._lock:
            return list(self._shed)

    @property
    def failed(self) -> Dict[int, Dict]:
        """uid -> failure record of requests whose retry budget ran out."""
        with self._lock:
            return dict(self._failed)

    def health(self) -> Dict[str, Any]:
        """The fleet's health verdict: ``healthy`` is False while a
        replica is dead, the fleet has failed, or requests have failed."""
        with self._lock:
            dead = [{"replica": r.idx, "error": r.death}
                    for r in self._replicas if r.dead]
            out = {
                "healthy": not dead and self._error is None
                and not self._failed,
                "serving_ckpt_id": self.serving_ckpt_id,
                "replicas": self.n_replicas,
                "replicas_live": self.n_live,
                "replicas_dead": dead,
                "requests_failed": len(self._failed),
                "requests_requeued": self._requeues,
                "fatal": repr(self._error) if self._error else None,
            }
            if self.tenants is not None:
                # which fine-tunes are resident, and each replica's tenant
                out["tenants"] = {
                    "adapters_resident": len(self.tenants.tenants),
                    "registered": sorted(self.tenants.tenants),
                    "serving": [r.engine.serving_tenant
                                for r in self._replicas],
                    "tenant_swaps": sum(r.tenant_swaps
                                        for r in self._replicas),
                }
            return out

    def summary(self) -> Dict[str, Any]:
        """Throughput, latency percentiles overall and by class and
        endpoint, shed and failover accounting, per-replica occupancy, the
        device-step cost identity (attributed + idle == dispatched), the
        cache's counters and, with tenants, the per-tenant block."""
        with self._lock:
            recs = list(self._results.values())
            shed = list(self._shed)
            failed = list(self._failed.values())
            requeues = self._requeues
            submitted = self._submitted
            reps = [(r.idx, r.completed, r.bursts, r.chunks,
                     r.device_steps, r.live_slot_steps, r.dead,
                     r.attributed_steps, r.idle_steps, r.tenant_swaps)
                    for r in self._replicas]
            tenant_slo = {t: trk.summary()
                          for t, trk in self._tenant_slo.items()}
            t0, t1 = self._t_first_submit, self._t_last_done
            admission = self._admission.summary()
        wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        by_class: Dict[str, List[float]] = {}
        by_endpoint: Dict[str, List[float]] = {}
        for rec in recs:
            by_class.setdefault(rec.get("class") or DEFAULT_CLASS,
                                []).append(rec["result"].latency_s)
            by_endpoint.setdefault(rec.get("endpoint") or "generate",
                                   []).append(rec["result"].latency_s)
        lat_all = [rec["result"].latency_s for rec in recs]

        def pct(xs: List[float]) -> Dict[str, Optional[float]]:
            if not xs:
                # no completions reads as no data, not a 0 ms p99
                return {"p50_s": None, "p95_s": None, "p99_s": None,
                        "mean_s": None}
            a = np.asarray(xs)
            return {"p50_s": round(float(np.percentile(a, 50)), 6),
                    "p95_s": round(float(np.percentile(a, 95)), 6),
                    "p99_s": round(float(np.percentile(a, 99)), 6),
                    "mean_s": round(float(a.mean()), 6)}

        shed_by_class: Dict[str, int] = {}
        for s in shed:
            shed_by_class[s["class"]] = shed_by_class.get(s["class"],
                                                          0) + 1
        per_replica = [{
            "replica": idx, "completed": comp, "bursts": bursts,
            "chunks": chunks, "device_steps": steps,
            "slot_utilization": round(
                live / max(chunks * self.chunk * self.slots, 1), 4),
            "dead": dead, "steps_attributed": attr, "steps_idle": idle,
            "tenant_swaps": tswaps,
        } for idx, comp, bursts, chunks, steps, live, dead, attr, idle,
            tswaps in reps]
        n_cached = sum(1 for rec in recs if rec.get("cached"))
        steps_by_class: Dict[str, int] = {}
        for rec in recs:
            c = rec.get("class") or DEFAULT_CLASS
            steps_by_class[c] = (steps_by_class.get(c, 0)
                                 + rec["result"].attributed_steps)
        tenants_block = None
        if self.tenants is not None:
            by_tenant: Dict[str, List[float]] = {}
            for rec in recs:
                by_tenant.setdefault(rec.get("tenant") or "",
                                     []).append(rec["result"].latency_s)
            shed_by_tenant: Dict[str, int] = {}
            for s in shed:
                tn = s.get("tenant") or ""
                shed_by_tenant[tn] = shed_by_tenant.get(tn, 0) + 1
            tenants_block = {
                "registered": sorted(self.tenants.tenants),
                "tenant_cap": self.tenant_cap,
                "tenant_swaps": sum(r["tenant_swaps"]
                                    for r in per_replica),
                "latency_by_tenant": {
                    t: {**pct(v), "completed": len(v)}
                    for t, v in sorted(by_tenant.items())},
                "shed_by_tenant": shed_by_tenant,
                "slo_by_tenant": tenant_slo,
                "memory": self.tenants.memory_table(),
                "encode_reuse": (self.encode_reuse.stats()
                                 if self.encode_reuse is not None
                                 else None),
            }
        total_attr = sum(r["steps_attributed"] for r in per_replica)
        total_idle = sum(r["steps_idle"] for r in per_replica)
        total_steps = sum(r["device_steps"] for r in per_replica)
        cost = {
            "steps_by_class": dict(sorted(steps_by_class.items())),
            "steps_attributed": total_attr,
            "steps_idle": total_idle,
            "steps_dispatched": total_steps,
            "exact": total_attr + total_idle == total_steps
            and sum(steps_by_class.values()) == total_attr,
        }
        return {
            "replicas": self.n_replicas,
            "replicas_dead": sum(1 for r in per_replica if r["dead"]),
            "replicas_live": self.n_live,
            "slots": self.slots,
            "chunk": self.chunk,
            "pool_cap": self.pool_cap,
            "submitted": submitted,
            "completed": len(recs),
            "completed_cached": n_cached,
            "cache": (None if self.cache is None
                      else self.cache.stats()),
            "shed": len(shed),
            "shed_frac": round(len(shed) / submitted, 4) if submitted
            else 0.0,
            "shed_by_class": shed_by_class,
            "failed": len(failed),
            "failed_requests": failed,
            "requeues": requeues,
            "retry_budget": self.retry_budget,
            "wall_s": round(wall, 6),
            "sketches_per_sec": round(len(recs) / wall, 3) if wall
            else 0.0,
            "latency": pct(lat_all),
            "latency_by_class": {c: {**pct(v), "completed": len(v)}
                                 for c, v in sorted(by_class.items())},
            "latency_by_endpoint": {e: {**pct(v), "completed": len(v)}
                                    for e, v in
                                    sorted(by_endpoint.items())},
            "cost": cost,
            "tenants": tenants_block,
            "per_replica": per_replica,
            # the critical path in device steps: deterministic for a
            # closed burst
            "critical_path_device_steps": max(
                (r["device_steps"] for r in per_replica), default=0),
            "total_device_steps": total_steps,
            "admission": admission,
        }


def live_fleets() -> tuple:
    with _LIVE_LOCK:
        return tuple(_LIVE)


def stop_all() -> tuple:
    """Close every live fleet; returns their reprs (empty when none
    leaked)."""
    leaked = live_fleets()
    names = tuple(repr(f) for f in leaked)
    for f in leaked:
        f.close()
    return names
