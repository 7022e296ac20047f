"""Deterministic open-loop load generation: Poisson and trace replay.

The port of ``sketch_rnn_tpu/serve/loadgen.py``: the same numpy
generators, so one seed gives bitwise the same schedules, traces and mix
ids in both packages.

A benchmark that sends the next request only when the previous one
completes (closed loop) lets a slow server slow its own load. This
generator is **open-loop**: the arrival schedule is drawn once from a
seeded process and replayed against the fleet's ``submit`` whatever the
completions do, so offered load is a property of the benchmark.
``rate_hz <= 0`` is the closed burst (every request at t=0).

**Traces.** :func:`make_trace` realizes a :class:`TraceSpec`: the
arrival shape (``poisson``, ``diurnal`` by thinning, a ``flash`` crowd,
bounded-``pareto`` gaps), a Zipf repetition model over a ``unique``-sized
request space, and seeded endpoint and tenant mixes, each a pure
function of the spec.

:class:`OpenLoopLoadGen` replays a schedule on its own thread; every
started generator registers process-wide so a test can prove it leaked
no thread (:func:`stop_all`). The JAX generator's telemetry stamps come
with the port's telemetry (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

# every live generator, for the no-stray-threads check
_LIVE: set = set()
_LIVE_LOCK = threading.Lock()


def poisson_arrivals(n: int, rate_hz: float, seed: int) -> np.ndarray:
    """Cumulative arrival offsets (seconds) for ``n`` requests.

    Exponential inter-arrivals at ``rate_hz`` (a Poisson process),
    deterministic in ``(n, rate_hz, seed)``. ``rate_hz <= 0`` means a
    closed burst: every request arrives at t=0.
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if rate_hz <= 0:
        return np.zeros((n,), np.float64)
    gaps = np.random.default_rng(seed).exponential(1.0 / rate_hz, size=n)
    return np.cumsum(gaps)


# -- traffic traces -----------------------------------------------------------

TRACE_KINDS = ("poisson", "diurnal", "flash", "pareto")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One seeded traffic shape + repetition model (pure config).

    ``rate_hz`` is the BASE rate; the shape fields modulate it.
    ``unique`` sizes the distinct-request space the Zipf repetition
    model draws from (``unique >= n`` degenerates to all-distinct;
    ``zipf_s`` is the exponent — larger = hotter head). Everything
    downstream (:func:`make_trace`, the autoscale plan, the cache's
    expected miss count) is a pure function of this dataclass.
    """

    kind: str = "poisson"
    n: int = 256
    rate_hz: float = 100.0
    seed: int = 0
    # diurnal
    diurnal_period_s: float = 4.0
    diurnal_amp: float = 0.8
    # flash crowd
    flash_at_s: float = 1.0
    flash_dur_s: float = 0.5
    flash_mult: float = 6.0
    # heavy tail
    pareto_alpha: float = 1.5
    pareto_cap_s: float = 1.0
    # repetition
    unique: int = 0          # 0 = all requests distinct
    zipf_s: float = 1.1
    # multi-task endpoint mix: ((endpoint, weight), ...) —
    # each arrival draws its endpoint from this weighted table with a
    # seeded stream decorrelated from arrivals and repetition ids, so
    # the mix is a pure function of the spec like everything else.
    # Empty = single-endpoint legacy traces (no endpoint column).
    endpoint_mix: Tuple[Tuple[str, float], ...] = ()
    # multi-tenant mix: ((tenant, weight), ...) — each
    # arrival draws the tenant whose fine-tune serves it, from its own
    # seeded stream (seed + 3, decorrelated from arrivals / repetition
    # ids / endpoint mix). The Zipf knob above already models skewed
    # POPULARITY of contents; this table models skewed tenant traffic
    # shares. Empty = single-tenant legacy traces (no tenant column).
    tenant_mix: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.kind not in TRACE_KINDS:
            raise ValueError(f"unknown trace kind {self.kind!r}; want "
                             f"one of {TRACE_KINDS}")
        if self.n < 0 or self.rate_hz <= 0:
            raise ValueError(f"need n >= 0 and rate_hz > 0, got "
                             f"n={self.n} rate_hz={self.rate_hz}")
        if self.kind == "diurnal" and not 0 <= self.diurnal_amp < 1:
            raise ValueError(f"diurnal_amp must be in [0, 1), got "
                             f"{self.diurnal_amp}")
        if self.kind == "flash" and self.flash_mult < 1:
            raise ValueError(f"flash_mult must be >= 1, got "
                             f"{self.flash_mult}")
        if self.kind == "pareto" and self.pareto_alpha <= 0:
            raise ValueError(f"pareto_alpha must be > 0, got "
                             f"{self.pareto_alpha}")
        for field, mix in (("endpoint_mix", self.endpoint_mix),
                           ("tenant_mix", self.tenant_mix)):
            seen = set()
            for item in mix:
                if len(item) != 2:
                    raise ValueError(f"{field} entries are (name, "
                                     f"weight) pairs, got {item!r}")
                name, w = item
                if not name or not isinstance(name, str):
                    raise ValueError(f"bad name {name!r} in {field}")
                if name in seen:
                    raise ValueError(f"duplicate name {name!r} in "
                                     f"{field}")
                seen.add(name)
                if not w > 0:
                    raise ValueError(f"{field} weight for {name!r} "
                                     f"must be > 0, got {w}")


@dataclasses.dataclass(frozen=True)
class Trace:
    """A realized trace: arrival offsets + the repetition mapping.
    ``request_ids[i]`` names the CONTENT arrival ``i`` carries;
    ``endpoint_ids[i]`` (when the spec declares an ``endpoint_mix``)
    indexes the mix table for arrival ``i``'s endpoint."""

    spec: TraceSpec
    arrivals: np.ndarray      # [n] cumulative seconds, non-decreasing
    request_ids: np.ndarray   # [n] int64 into the unique request space
    endpoint_ids: Optional[np.ndarray] = None   # [n] into endpoint_mix
    tenant_ids: Optional[np.ndarray] = None     # [n] into tenant_mix

    @property
    def n(self) -> int:
        return len(self.arrivals)

    @property
    def duration_s(self) -> float:
        return float(self.arrivals[-1]) if len(self.arrivals) else 0.0

    def distinct(self) -> int:
        """Distinct contents actually drawn — the deterministic miss
        count a cold cache must see on this trace."""
        return int(len(np.unique(self.request_ids)))

    def endpoint_of(self, i: int) -> str:
        """Arrival ``i``'s endpoint name (``generate`` on mix-less
        legacy traces)."""
        if self.endpoint_ids is None:
            return "generate"
        return self.spec.endpoint_mix[int(self.endpoint_ids[i])][0]

    def endpoint_counts(self) -> dict:
        """Realized per-endpoint arrival counts — what the bench
        reports as the actual mix."""
        if self.endpoint_ids is None:
            return {"generate": self.n}
        names = [m[0] for m in self.spec.endpoint_mix]
        ids, counts = np.unique(self.endpoint_ids, return_counts=True)
        return {names[int(i)]: int(c) for i, c in zip(ids, counts)}

    def tenant_of(self, i: int) -> str:
        """Arrival ``i``'s tenant name ("" — the base checkpoint — on
        mix-less legacy traces)."""
        if self.tenant_ids is None:
            return ""
        return self.spec.tenant_mix[int(self.tenant_ids[i])][0]

    def tenant_counts(self) -> dict:
        """Realized per-tenant arrival counts — what the bench reports
        as the actual tenant mix."""
        if self.tenant_ids is None:
            return {"": self.n}
        names = [m[0] for m in self.spec.tenant_mix]
        ids, counts = np.unique(self.tenant_ids, return_counts=True)
        return {names[int(i)]: int(c) for i, c in zip(ids, counts)}


def diurnal_arrivals(n: int, rate_hz: float, period_s: float,
                     amp: float, seed: int) -> np.ndarray:
    """Sinusoidally-modulated Poisson arrivals via thinning.

    Instantaneous rate ``rate_hz * (1 + amp * sin(2 pi t / period))``;
    candidates are drawn at the peak rate and accepted with probability
    ``rate(t) / peak`` from the SAME seeded stream, so the result is a
    pure function of ``(n, rate_hz, period_s, amp, seed)``.
    """
    if n == 0:
        return np.zeros((0,), np.float64)
    rng = np.random.default_rng(seed)
    peak = rate_hz * (1.0 + amp)
    out = np.empty((n,), np.float64)
    t, k = 0.0, 0
    while k < n:
        t += rng.exponential(1.0 / peak)
        rate = rate_hz * (1.0 + amp * np.sin(2.0 * np.pi * t / period_s))
        if rng.random() * peak <= rate:
            out[k] = t
            k += 1
    return out


def flash_crowd_arrivals(n: int, rate_hz: float, at_s: float,
                         dur_s: float, mult: float,
                         seed: int) -> np.ndarray:
    """Piecewise-constant-rate arrivals: base rate everywhere except a
    ``mult`` x step inside ``[at_s, at_s + dur_s)`` — the flash crowd.
    Sequential seeded draws (gap at the CURRENT instant's rate), so the
    schedule is deterministic in the spec."""
    if n == 0:
        return np.zeros((0,), np.float64)
    rng = np.random.default_rng(seed)
    out = np.empty((n,), np.float64)
    t = 0.0
    for k in range(n):
        rate = rate_hz * (mult if at_s <= t < at_s + dur_s else 1.0)
        t += rng.exponential(1.0 / rate)
        out[k] = t
    return out


def pareto_arrivals(n: int, rate_hz: float, alpha: float, cap_s: float,
                    seed: int) -> np.ndarray:
    """Bounded-Pareto inter-arrivals with mean ``~1/rate_hz``.

    Heavy-tailed gaps (inverse-CDF of a Pareto with shape ``alpha``)
    are first scaled so the sample mean rate is ``rate_hz`` — offered
    load stays comparable across shapes — THEN truncated at ``cap_s``
    in realized seconds, so one draw can never stall the trace by more
    than the documented bound. Truncation only shortens gaps, so the
    realized mean rate is >= ``rate_hz`` by the clipped tail mass.
    Pure in the spec (the scale factor uses the sample mean, itself
    seeded).
    """
    if n == 0:
        return np.zeros((0,), np.float64)
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    gaps = 1.0 / np.power(1.0 - u, 1.0 / alpha)  # Pareto, xm = 1
    gaps = gaps * ((1.0 / rate_hz) / gaps.mean())
    gaps = np.minimum(gaps, max(cap_s, 1e-9))
    return np.cumsum(gaps)


def zipf_request_ids(n: int, unique: int, s: float,
                     seed: int) -> np.ndarray:
    """Zipf-distributed content ids over ``[0, unique)``: repetition
    with a hot head, deterministic in the seed. ``unique <= 0`` means
    all-distinct (identity — no repetition, a cache sees 0 hits)."""
    if unique <= 0 or unique >= n:
        return np.arange(n, dtype=np.int64)
    ranks = np.arange(1, unique + 1, dtype=np.float64)
    p = ranks ** (-float(s))
    p /= p.sum()
    return np.random.default_rng(seed + 1).choice(
        unique, size=n, p=p).astype(np.int64)


def parse_endpoint_mix(spec: str) -> Tuple[Tuple[str, float], ...]:
    """Parse an ``--endpoint_mix`` string into the TraceSpec table:
    ``"generate:4,complete:3,reconstruct:2,interpolate:1"`` (bare names
    default to weight 1). Validation happens in TraceSpec."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, w = item.partition(":")
        try:
            out.append((name.strip(), float(w) if w.strip() else 1.0))
        except ValueError:
            raise ValueError(
                f"bad endpoint_mix weight {w!r} for {name!r} (want "
                f"'name:weight,...')") from None
    if not out:
        raise ValueError(f"empty endpoint mix spec {spec!r}")
    return tuple(out)


def endpoint_mix_ids(n: int, mix: Tuple[Tuple[str, float], ...],
                     seed: int) -> Optional[np.ndarray]:
    """Seeded per-arrival endpoint assignment over the weighted mix,
    deterministic in ``(n, mix, seed)``, stream-decorrelated
    from arrivals (seed) and repetition ids (seed + 1) via seed + 2.
    ``mix`` empty -> None (legacy single-endpoint traces)."""
    if not mix:
        return None
    w = np.asarray([m[1] for m in mix], np.float64)
    return np.random.default_rng(seed + 2).choice(
        len(mix), size=n, p=w / w.sum()).astype(np.int64)


def parse_tenant_mix(spec: str) -> Tuple[Tuple[str, float], ...]:
    """Parse a ``--tenant_mix`` string into the TraceSpec table:
    ``"acme:4,globex:2,initech:1"`` (bare names default to weight 1) —
    the :func:`parse_endpoint_mix` grammar with tenant names.
    Validation happens in TraceSpec."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, w = item.partition(":")
        try:
            out.append((name.strip(), float(w) if w.strip() else 1.0))
        except ValueError:
            raise ValueError(
                f"bad tenant_mix weight {w!r} for {name!r} (want "
                f"'name:weight,...')") from None
    if not out:
        raise ValueError(f"empty tenant mix spec {spec!r}")
    return tuple(out)


def tenant_mix_ids(n: int, mix: Tuple[Tuple[str, float], ...],
                   seed: int) -> Optional[np.ndarray]:
    """Seeded per-arrival tenant assignment over the weighted mix,
    deterministic in ``(n, mix, seed)``, decorrelated from
    every other trace stream via seed + 3. ``mix`` empty -> None
    (legacy single-tenant traces)."""
    if not mix:
        return None
    w = np.asarray([m[1] for m in mix], np.float64)
    return np.random.default_rng(seed + 3).choice(
        len(mix), size=n, p=w / w.sum()).astype(np.int64)


def trace_arrivals(spec: TraceSpec) -> np.ndarray:
    """The spec's arrival schedule (dispatch on ``kind``)."""
    if spec.kind == "poisson":
        return poisson_arrivals(spec.n, spec.rate_hz, spec.seed)
    if spec.kind == "diurnal":
        return diurnal_arrivals(spec.n, spec.rate_hz,
                                spec.diurnal_period_s,
                                spec.diurnal_amp, spec.seed)
    if spec.kind == "flash":
        return flash_crowd_arrivals(spec.n, spec.rate_hz, spec.flash_at_s,
                                    spec.flash_dur_s, spec.flash_mult,
                                    spec.seed)
    return pareto_arrivals(spec.n, spec.rate_hz, spec.pareto_alpha,
                           spec.pareto_cap_s, spec.seed)


def make_trace(spec: TraceSpec) -> Trace:
    """Realize a spec: arrivals + Zipf repetition ids (+ the seeded
    endpoint mix), pure in the spec (two calls with equal
    specs return bitwise-equal arrays)."""
    return Trace(spec=spec, arrivals=trace_arrivals(spec),
                 request_ids=zipf_request_ids(spec.n, spec.unique,
                                              spec.zipf_s, spec.seed),
                 endpoint_ids=endpoint_mix_ids(spec.n,
                                               spec.endpoint_mix,
                                               spec.seed),
                 tenant_ids=tenant_mix_ids(spec.n, spec.tenant_mix,
                                           spec.seed))


class OpenLoopLoadGen:
    """Replay an arrival schedule against ``submit(i)`` on its own thread.

    ``arrivals`` are cumulative offsets (:func:`poisson_arrivals`, or
    any non-decreasing schedule); ``submit`` is called with the request
    INDEX, so the generator never touches request objects. The thread
    sleeps to each scheduled instant and never waits on completions; if
    it falls behind, the request fires at once and the shortfall is kept
    in ``max_lag_s``.
    """

    def __init__(self, arrivals: Sequence[float],
                 submit: Callable[[int], object],
                 name: str = "loadgen"):
        self.arrivals = np.asarray(arrivals, np.float64)
        if len(self.arrivals) and np.any(np.diff(self.arrivals) < 0):
            raise ValueError("arrivals must be non-decreasing")
        self._submit = submit
        self.name = name
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.submitted = 0
        self.max_lag_s = 0.0
        self.started_ts: Optional[float] = None

    def _run(self) -> None:
        t0 = self.started_ts
        try:
            for i, at in enumerate(self.arrivals):
                while True:
                    lag = (time.perf_counter() - t0) - at
                    if lag >= 0:
                        break
                    if self._stop.wait(min(-lag, 0.05)):
                        return
                if self._stop.is_set():
                    return
                self.max_lag_s = max(self.max_lag_s, lag)
                self._submit(i)
                self.submitted += 1
        finally:
            with _LIVE_LOCK:
                _LIVE.discard(self)

    def start(self) -> "OpenLoopLoadGen":
        if self._thread is not None:
            raise RuntimeError("load generator already started")
        self.started_ts = time.perf_counter()
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        with _LIVE_LOCK:
            _LIVE.add(self)
        self._thread.start()
        return self

    @property
    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the schedule to finish replaying; True when done."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Abandon any un-submitted arrivals and join the thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with _LIVE_LOCK:
            _LIVE.discard(self)

    def __enter__(self) -> "OpenLoopLoadGen":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    def __repr__(self) -> str:
        state = ("idle" if self._thread is None
                 else "done" if self.done else "replaying")
        return (f"OpenLoopLoadGen({self.name}: {self.submitted}/"
                f"{len(self.arrivals)} {state})")


def live_generators() -> Tuple["OpenLoopLoadGen", ...]:
    with _LIVE_LOCK:
        return tuple(_LIVE)


def stop_all() -> Tuple[str, ...]:
    """Stop every live generator; returns their reprs (empty when none
    leaked)."""
    leaked = live_generators()
    names = tuple(repr(g) for g in leaked)
    for g in leaked:
        g.stop()
    return names
