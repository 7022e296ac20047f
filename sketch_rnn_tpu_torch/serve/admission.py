"""SLA-aware admission: deadline/priority classes, least-loaded placement,
shed-on-overload.

The port of ``sketch_rnn_tpu/serve/admission.py`` (pure Python). The
fleet (``serve/fleet.py``) fronts R replica engines with per-replica
queues; this module answers one question per arrival: *which replica
queue, or shed now?*

- **Classes reuse the ``parse_slo`` grammar**: ``interactive:p95<=250ms``
  declares class ``interactive`` with a 250 ms deadline. Priority is spec
  order (first = drained first).
- **Least-loaded placement**: the controller tracks each replica's
  backlog (queued + running decode-pool rows) and routes to the minimum,
  ties to the lowest index. Backlog is the only placement signal, so
  placement picks WHERE, never WHAT (a request's strokes are a pure
  function of the request).
- **Shed-on-overload**: a request is refused at the door when its
  class's deadline is already unmeetable (estimated wait = backlog x the
  observed service time / slots) or when the chosen replica's queue is
  at the hard cap.

The controller reads no clock and starts no thread: the fleet calls it
under its own lock and feeds it completions, so every decision is a
deterministic function of the arrival and completion history.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from sketch_rnn_tpu_torch.serve.slo import SLO, parse_slo

# the class every request lands in when no classes are configured: no
# deadline, so never shed on latency
DEFAULT_CLASS = "default"


@dataclasses.dataclass(frozen=True)
class AdmissionClass:
    """One admission class: a named deadline + drain priority (0 = most
    important = drained first)."""

    name: str
    slo: SLO
    priority: int = 0

    @property
    def deadline_s(self) -> float:
        return self.slo.objective_s


def parse_admission_classes(specs: Sequence[str]
                            ) -> Dict[str, AdmissionClass]:
    """Parse ``--classes`` specs into an ordered class table.

    Each spec uses the ``parse_slo`` grammar with the endpoint field
    naming the class (``interactive:p95<=250ms``,
    ``batch:latency_s:p99<=2``); priority is spec order. An empty list
    yields the single no-deadline :data:`DEFAULT_CLASS`.
    """
    out: Dict[str, AdmissionClass] = {}
    for i, spec in enumerate(specs):
        slo = parse_slo(spec)
        if slo.endpoint in out:
            raise ValueError(f"duplicate admission class "
                             f"{slo.endpoint!r} (from {spec!r})")
        out[slo.endpoint] = AdmissionClass(name=slo.endpoint, slo=slo,
                                           priority=i)
    if not out:
        out[DEFAULT_CLASS] = AdmissionClass(
            name=DEFAULT_CLASS,
            slo=SLO(objective_s=math.inf, target=0.95,
                    endpoint=DEFAULT_CLASS),
            priority=0)
    return out


def parse_tenant_slos(specs: Sequence[str]) -> Dict[str, List[SLO]]:
    """Parse ``--tenant_slo`` specs into per-tenant SLO lists.

    Grammar: ``tenant:class:pNN<=VALUE``: the leading segment names the
    tenant, the rest is the :func:`parse_slo` grammar with the class in
    the endpoint slot (``acme:interactive:p95<=250ms``). A two-segment
    spec (``acme:p95<=250ms``) applies to :data:`DEFAULT_CLASS`.
    """
    out: Dict[str, List[SLO]] = {}
    seen = set()
    for spec in specs:
        left, sep, _ = spec.partition("<=")
        segs = [s.strip() for s in left.strip().split(":")]
        if not sep or len(segs) < 2 or not segs[0]:
            raise ValueError(
                f"bad tenant SLO spec {spec!r}: want "
                f"tenant:class:pNN<=SECONDS (e.g. "
                f"'acme:interactive:p95<=250ms')")
        tenant = segs[0]
        slo = parse_slo(spec.partition(":")[2])
        if len(segs) == 2:
            slo = dataclasses.replace(slo, endpoint=DEFAULT_CLASS)
        if (tenant, slo.key) in seen:
            raise ValueError(
                f"duplicate tenant SLO {tenant}:{slo.key} "
                f"(from {spec!r})")
        seen.add((tenant, slo.key))
        out.setdefault(tenant, []).append(slo)
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """One admission decision. ``replica`` is None iff shed."""

    replica: Optional[int]
    queue_pos: int = 0            # rows ahead on the chosen replica
    est_wait_s: Optional[float] = None
    shed_reason: Optional[str] = None

    @property
    def shed(self) -> bool:
        return self.replica is None


class AdmissionController:
    """Least-loaded + shed-on-overload placement over R replicas.

    Not locked: the fleet serializes ``place``/``note_done`` under its
    scheduler lock. ``queue_cap`` bounds a replica's backlog (0 =
    unbounded); ``shed_margin`` scales the deadline before the
    estimated-wait comparison (1.0 = shed when the estimate exceeds the
    deadline). The service-time estimate is an EWMA of completed
    requests' ``decode_s``; until the first completion only the hard
    queue cap sheds (a cold fleet must not refuse its first burst).
    ``tenant_cap`` caps one tenant's outstanding rows (0 = off).
    """

    def __init__(self, classes: Dict[str, AdmissionClass],
                 n_replicas: int, slots: int, queue_cap: int = 0,
                 shed_margin: float = 1.0, ewma: float = 0.2,
                 tenant_cap: int = 0):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.classes = dict(classes)
        self.n_replicas = n_replicas
        self.slots = slots
        self.queue_cap = int(queue_cap)
        self.shed_margin = float(shed_margin)
        self._ewma = float(ewma)
        self._backlog: List[int] = [0] * n_replicas
        self._dead: set = set()
        # retired replicas leave placement gracefully: their backlog is
        # kept and drains, and rejoin() brings them back
        self._retired: set = set()
        self.service_s: Optional[float] = None   # EWMA decode_s
        self.admitted = 0
        self.shed: Dict[str, int] = {c: 0 for c in self.classes}
        self.tenant_cap = int(tenant_cap)
        self._tenant_out: Dict[str, int] = {}
        self.shed_by_tenant: Dict[str, int] = {}

    @property
    def backlog(self) -> List[int]:
        return list(self._backlog)

    @property
    def dead(self) -> List[int]:
        return sorted(self._dead)

    @property
    def retired(self) -> List[int]:
        return sorted(self._retired)

    @property
    def live_replicas(self) -> List[int]:
        return [r for r in range(self.n_replicas)
                if r not in self._dead and r not in self._retired]

    def retire(self, replica: int) -> None:
        """Take ``replica`` out of the placement set gracefully: its
        backlog is kept (it drains what it owns), no new arrival is placed
        on it. Idempotent."""
        if not 0 <= replica < self.n_replicas:
            raise ValueError(f"replica {replica} out of range "
                             f"0..{self.n_replicas - 1}")
        self._retired.add(replica)

    def rejoin(self, replica: int) -> None:
        """Return a retired replica to the placement set."""
        if replica in self._dead:
            raise ValueError(f"replica {replica} is dead, not retired "
                             f"— the crash path cannot rejoin")
        self._retired.discard(replica)

    def mark_dead(self, replica: int) -> int:
        """Shrink capacity: ``replica`` leaves the placement set (the
        fleet's failover). Its tracked backlog is dropped and returned,
        so the fleet re-places exactly those requests. Idempotent."""
        if not 0 <= replica < self.n_replicas:
            raise ValueError(f"replica {replica} out of range "
                             f"0..{self.n_replicas - 1}")
        if replica in self._dead:
            return 0
        self._dead.add(replica)
        self._retired.discard(replica)  # dead outranks retired
        dropped, self._backlog[replica] = self._backlog[replica], 0
        return dropped

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())

    def est_wait_s(self, replica: int) -> Optional[float]:
        """Expected queueing delay on ``replica``: its backlog of
        decode-pool rows worked off at ``slots`` concurrent units of the
        observed service time (None until a completion calibrates it)."""
        if self.service_s is None:
            return None
        return self._backlog[replica] * self.service_s / self.slots

    def place(self, cls_name: str, force: bool = False,
              requeue: bool = False, cost: int = 1,
              tenant: str = "") -> Placement:
        """Decide one arrival: least-loaded replica, or shed.

        ``force`` admits unconditionally (same placement, shed checks
        skipped); ``requeue`` (failover) also skips the ``admitted``
        count, since the request was admitted once already. ``cost`` is
        the request's decode-pool rows (``frames`` for an interpolation,
        1 otherwise). ``tenant`` charges the rows to that tenant's fair
        share, whose cap sheds before the queue and deadline checks.
        """
        cls = self.classes.get(cls_name)
        if cls is None:
            raise KeyError(
                f"unknown admission class {cls_name!r}; configured: "
                f"{sorted(self.classes)}")
        if cost < 1:
            raise ValueError(f"cost must be >= 1, got {cost}")
        live = self.live_replicas
        if not live:
            raise RuntimeError(
                "no live replicas to place on — every replica was "
                "marked dead (the fleet stops accepting before this)")
        replica = min(live, key=lambda r: (self._backlog[r], r))
        depth = self._backlog[replica]
        wait = self.est_wait_s(replica)
        tenant = str(tenant or "")
        if not force and not requeue:
            if (self.tenant_cap
                    and self._tenant_out.get(tenant, 0) + cost
                    > self.tenant_cap):
                self.shed[cls_name] += 1
                self.shed_by_tenant[tenant] = \
                    self.shed_by_tenant.get(tenant, 0) + 1
                return Placement(replica=None,
                                 shed_reason="tenant_cap")
            if self.queue_cap and depth >= self.queue_cap:
                self.shed[cls_name] += 1
                if tenant:
                    self.shed_by_tenant[tenant] = \
                        self.shed_by_tenant.get(tenant, 0) + 1
                return Placement(replica=None, shed_reason="queue_full")
            if (wait is not None and math.isfinite(cls.deadline_s)
                    and wait > cls.deadline_s * self.shed_margin):
                self.shed[cls_name] += 1
                if tenant:
                    self.shed_by_tenant[tenant] = \
                        self.shed_by_tenant.get(tenant, 0) + 1
                return Placement(replica=None, est_wait_s=wait,
                                 shed_reason="deadline")
        if not requeue:
            self.admitted += 1
            # a requeued request's rows are still outstanding from its
            # first placement
            self._tenant_out[tenant] = \
                self._tenant_out.get(tenant, 0) + int(cost)
        self._backlog[replica] += int(cost)
        return Placement(replica=replica, queue_pos=depth,
                         est_wait_s=wait)

    def drop_tenant(self, tenant: str, cost: int = 1) -> None:
        """Release a tenant's outstanding rows without a completion (a
        request that failed for good)."""
        tenant = str(tenant or "")
        self._tenant_out[tenant] = max(
            0, self._tenant_out.get(tenant, 0) - int(cost))

    def note_done(self, replica: int, decode_s: float,
                  cost: int = 1, tenant: str = "") -> None:
        """Feed one completion: free its ``cost`` backlog rows and update
        the service-time EWMA with ``decode_s`` (whole, even for a grid
        request: its rows decode concurrently in pool slots)."""
        if self._backlog[replica] < cost:
            raise RuntimeError(
                f"replica {replica} completed a cost-{cost} request "
                f"with only {self._backlog[replica]} tracked backlog "
                f"rows — placement/completion accounting desynced")
        self._backlog[replica] -= int(cost)
        tenant = str(tenant or "")
        self._tenant_out[tenant] = max(
            0, self._tenant_out.get(tenant, 0) - int(cost))
        d = float(decode_s)
        self.service_s = (d if self.service_s is None
                          else (1 - self._ewma) * self.service_s
                          + self._ewma * d)

    def summary(self) -> Dict:
        """Aggregate admission state for reports."""
        return {
            "admitted": self.admitted,
            "shed_total": self.shed_total,
            "shed_by_class": dict(self.shed),
            "backlog": self.backlog,
            "dead_replicas": self.dead,
            "retired_replicas": self.retired,
            "live_replicas": len(self.live_replicas),
            "service_est_s": (None if self.service_s is None
                              else round(self.service_s, 6)),
            "queue_cap": self.queue_cap,
            "tenant_cap": self.tenant_cap,
            "shed_by_tenant": dict(self.shed_by_tenant),
            "tenant_outstanding": {t: v for t, v
                                   in self._tenant_out.items() if v},
            "classes": {c.name: {"deadline_s": c.deadline_s,
                                 "target": c.slo.target,
                                 "priority": c.priority}
                        for c in self.classes.values()},
        }
