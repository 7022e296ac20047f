"""Per-endpoint latency SLOs with rolling error-budget burn rates.

The port of ``sketch_rnn_tpu/serve/slo.py``, line for line (it is pure
Python). The vocabulary is the standard SRE one:

- An :class:`SLO` is a quantile-style latency objective: ``target``
  fraction of requests must complete within ``objective_s`` (p95 <=
  250 ms is ``target=0.95, objective_s=0.25``). A request over the
  objective is a *breach*.
- The *error budget* is the allowed breach fraction, ``1 - target``.
- The *burn rate* is the observed breach fraction over the allowed one:
  1.0 breaches exactly at budget, > 1.0 spends the budget faster than the
  objective allows, 0.0 means no breaches.

:class:`SLOTracker` is fed one observation per completed request
(``ServeEngine.run(..., slo=...)`` and the fleet's workers) and keeps,
per SLO, exact totals plus a bounded rolling window counted in requests,
so its summary is a pure function of the request stream (no wall clock
in the math).
"""

from __future__ import annotations

import dataclasses
import re
import threading
from collections import deque
from typing import Dict, List, Sequence

DEFAULT_ENDPOINT = "generate"
DEFAULT_METRIC = "latency_s"
# the latency fields a completed Result carries: a typo'd metric would
# track nothing and report vacuous compliance, so parse_slo refuses it
RESULT_METRICS = ("latency_s", "queue_wait_s", "decode_s")
# endpoint names become metric label values: identifier-ish only
_NAME_OK = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One latency objective: ``target`` fraction of ``endpoint``'s
    requests must have ``metric`` <= ``objective_s`` seconds."""

    objective_s: float
    target: float = 0.95
    endpoint: str = DEFAULT_ENDPOINT
    metric: str = DEFAULT_METRIC

    def __post_init__(self):
        if self.objective_s <= 0:
            raise ValueError(
                f"objective_s must be > 0, got {self.objective_s}")
        if not 0.0 < self.target <= 1.0:
            raise ValueError(f"target must be in (0, 1], got {self.target}")

    @property
    def key(self) -> str:
        """Stable identity, e.g. ``generate:latency_s:p95``."""
        return (f"{self.endpoint}:{self.metric}:"
                f"p{self.target * 100:g}")

    @property
    def budget(self) -> float:
        """Allowed breach fraction (0 for a p100 objective)."""
        return 1.0 - self.target


def parse_slo(spec: str) -> SLO:
    """Parse an ``--slo`` spec string into an :class:`SLO`.

    Grammar: ``[endpoint:[metric:]]pNN<=VALUE`` where VALUE is seconds
    (or ``<number>ms``). Examples::

        p95<=0.25                      # generate latency_s p95 <= 250ms
        p99<=400ms
        generate:p95<=0.25
        generate:decode_s:p99<=0.1
    """
    if "<=" not in spec:
        raise ValueError(
            f"bad SLO spec {spec!r}: want [endpoint:[metric:]]pNN<=SECONDS"
            f" (e.g. 'p95<=0.25' or 'generate:decode_s:p99<=100ms')")
    left, _, right = spec.partition("<=")
    right = right.strip()
    try:
        if right.endswith("ms"):
            objective = float(right[:-2]) / 1e3
        else:
            objective = float(right)
    except ValueError:
        raise ValueError(f"bad SLO objective {right!r} in {spec!r}: want "
                         f"seconds (float) or '<number>ms'") from None
    parts = [p.strip() for p in left.strip().split(":")]
    quant = parts[-1]
    if not quant.startswith("p"):
        raise ValueError(f"bad SLO quantile {quant!r} in {spec!r}: want "
                         f"pNN (e.g. p95)")
    try:
        target = float(quant[1:]) / 100.0
    except ValueError:
        raise ValueError(
            f"bad SLO quantile {quant!r} in {spec!r}") from None
    endpoint = parts[0] if len(parts) >= 2 else DEFAULT_ENDPOINT
    metric = parts[1] if len(parts) == 3 else DEFAULT_METRIC
    if len(parts) > 3:
        raise ValueError(f"bad SLO spec {spec!r}: too many ':' segments")
    if not _NAME_OK.match(endpoint):
        raise ValueError(
            f"bad SLO endpoint {endpoint!r} in {spec!r}: want an "
            f"identifier ([A-Za-z_][A-Za-z0-9_.-]*) — it becomes a "
            f"Prometheus label value")
    if metric not in RESULT_METRICS:
        raise ValueError(
            f"bad SLO metric {metric!r} in {spec!r}: must be one of "
            f"{RESULT_METRICS} (the latency fields a completed request "
            f"reports) — anything else would track nothing and report "
            f"vacuous compliance")
    return SLO(objective_s=objective, target=target, endpoint=endpoint,
               metric=metric)


class SLOTracker:
    """Feed per-request latencies, read compliance and burn rates.

    Thread-safe: the fleet's workers observe from their own threads.
    ``window`` bounds the rolling burn-rate window in REQUESTS; totals are
    exact and unbounded. ``min_requests`` gates :meth:`healthy`, so a
    handful of warm-up requests cannot flip the verdict.
    """

    def __init__(self, slos: Sequence[SLO], window: int = 256,
                 min_requests: int = 8):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = threading.Lock()
        self._slos: List[SLO] = list(slos)
        seen = set()
        for s in self._slos:
            if s.key in seen:
                raise ValueError(f"duplicate SLO {s.key}")
            seen.add(s.key)
        self.min_requests = min_requests
        self._state: Dict[str, dict] = {
            s.key: {"slo": s, "total": 0, "breaches": 0,
                    "window": deque(maxlen=window)}
            for s in self._slos
        }

    @property
    def slos(self) -> List[SLO]:
        return list(self._slos)

    def observe(self, endpoint: str, values: Dict[str, float]) -> None:
        """Record one completed request on ``endpoint``; ``values`` maps
        metric name -> seconds (a Result's latency fields). SLOs whose
        metric is absent from ``values`` are skipped."""
        with self._lock:
            for st in self._state.values():
                slo = st["slo"]
                if slo.endpoint != endpoint:
                    continue
                v = values.get(slo.metric)
                if v is None:
                    continue
                breach = float(v) > slo.objective_s
                st["total"] += 1
                st["breaches"] += int(breach)
                st["window"].append(breach)

    @staticmethod
    def _burn(breaches: int, total: int, budget: float) -> float:
        """Breach fraction over the allowed fraction; a zero-budget
        (p100) objective burns infinitely on any breach, 0.0 otherwise."""
        if total == 0:
            return 0.0
        frac = breaches / total
        if budget <= 0.0:
            return float("inf") if frac > 0 else 0.0
        return frac / budget

    def summary(self) -> Dict[str, Dict]:
        """Per-SLO state: exact totals, compliance, window and total burn
        rates, and the ``met`` verdict (compliance >= target so far)."""
        out: Dict[str, Dict] = {}
        with self._lock:
            for key, st in self._state.items():
                slo, total = st["slo"], st["total"]
                breaches = st["breaches"]
                win = st["window"]
                wb = sum(win)
                compliance = 1.0 - breaches / total if total else 1.0
                out[key] = {
                    "endpoint": slo.endpoint,
                    "metric": slo.metric,
                    "objective_s": slo.objective_s,
                    "target": slo.target,
                    "total": total,
                    "breaches": breaches,
                    "compliance": round(compliance, 6),
                    "met": compliance >= slo.target,
                    "burn_rate": round(
                        self._burn(wb, len(win), slo.budget), 4),
                    "burn_rate_total": round(
                        self._burn(breaches, total, slo.budget), 4),
                    "window_n": len(win),
                }
        return out

    def healthy(self) -> bool:
        """False once any SLO with >= ``min_requests`` observations is
        out of compliance."""
        return not any(
            not rec["met"] and rec["total"] >= self.min_requests
            for rec in self.summary().values())
