"""The serving fleet's core in the port against the JAX package.

At the tiny sizes of ``tests/test_fleet.py`` (batch 8, max_seq_len 24,
encoder 12, decoder 16, z 6, M 3, 2 slots, K=2), weights carried across
by ``convert.py``, inputs made with numpy:

- ``serve/quantize.py`` at bfloat16 and int8: the dequantized arrays, the
  packed storage and the error report bitwise JAX's, the ``stamp_ckpt_id``
  strings equal.
- ``serve/slo.py``, ``serve/admission.py``: parsed specs, an
  ``SLOTracker`` summary, and one scripted sequence of ``place`` /
  ``note_done`` / ``mark_dead`` / ``retire`` / ``rejoin`` calls equal.
- ``serve/loadgen.py``: arrivals, traces and mix ids bitwise; the load
  generator submits in schedule order. ``fleet.form_burst``: the bursts of
  the JAX scheduler's ``form_burst``.
- The engine at ``recycle=False`` and with ``pool_pad``: strokes within
  1e-5 of the JAX engine's (steps, lengths and pens exact), its metrics,
  its metrics-writer rows and its SLO summary equal.
- ``generate_many`` and ``Result.ended`` against JAX's; the ``serve``
  package exports only names of the JAX package's ``__all__``.
- A closed-burst fleet at R=1 and R=2 (CPU devices) with two classes and
  an endpoint mix: strokes within 1e-5 of the JAX fleet's, bitwise the
  port's own single engine; the placements, sheds, summary and health
  counters equal JAX's.
- Failover: a replica whose engine raises on its first burst; its
  requests finish on the survivor bitwise the no-fault run. The last
  replica's death and a spent retry budget end as in JAX.

Every test ends with no port fleet or load generator alive (the autouse
fixture below).
"""

import dataclasses
import json
import threading
import time
from collections import deque

import jax
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.runtime.scheduler import GeometryRunScheduler
from sketch_rnn_tpu.serve import admission as jadm
from sketch_rnn_tpu.serve import loadgen as jlg
from sketch_rnn_tpu.serve import quantize as jq
from sketch_rnn_tpu.serve import slo as jslo
from sketch_rnn_tpu.serve.engine import Request as JRequest
from sketch_rnn_tpu.serve.engine import ServeEngine as JServeEngine
from sketch_rnn_tpu.serve.fleet import ServeFleet as JServeFleet
from sketch_rnn_tpu.train.metrics import MetricsWriter as JMetricsWriter
from sketch_rnn_tpu.utils import faults as jfaults
from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.serve import admission as adm
from sketch_rnn_tpu_torch.serve import fleet as fleet_mod
from sketch_rnn_tpu_torch.serve import loadgen as lg
from sketch_rnn_tpu_torch.serve import quantize as q
from sketch_rnn_tpu_torch.serve import slo
from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
from sketch_rnn_tpu_torch.serve.fleet import ServeFleet, form_burst
from sketch_rnn_tpu_torch.train.metrics import MetricsWriter

TINY = dict(batch_size=8, max_seq_len=24, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, serve_slots=2,
            serve_chunk=2, conditional=True)
TOL = 1e-5
CPU = torch.device("cpu")
CLASSES = ["interactive:p95<=250ms", "batch:p99<=2"]
ROUTES = {"generate": "interactive", "complete": "interactive",
          "reconstruct": "batch", "interpolate": "batch"}
# deterministic shed: the queue cap bites before any completion
QUEUE_CAP = {1: 0, 2: 6}


@pytest.fixture(autouse=True)
def _no_stray_fleet_threads():
    yield
    leaked = fleet_mod.stop_all() + lg.stop_all()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(fleet_mod.THREAD_PREFIX)]
    assert not leaked and not alive, (leaked, alive)


@pytest.fixture(scope="module")
def setup():
    jhps = JHParams(**TINY)
    jm = JSketchRNN(jhps)
    jp = jm.init_params(jax.random.key(0))
    m = SketchRNN(HParams(**TINY))
    p = params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, m, p


def _prefix(rng, n):
    a = np.zeros((n, 3), np.float32)
    a[:, :2] = rng.normal(size=(n, 2))
    a[:, 2] = rng.random(n) < 0.2
    return a


def _specs(n, seed, endpoints=True):
    """Per-request fields made with numpy: a mix of the four endpoints
    (or generate only), caps 4..8."""
    rng = np.random.default_rng(seed)
    eps = (["generate", "complete", "reconstruct", "interpolate"]
           if endpoints else ["generate"])
    out = []
    for i in range(n):
        ep = eps[i % len(eps)]
        s = dict(uid=i, endpoint=ep, temperature=0.8,
                 max_len=int(rng.integers(4, 9)))
        if ep == "generate":
            s["z"] = rng.standard_normal(TINY["z_size"]).astype(np.float32)
        elif ep == "interpolate":
            s["prefix"] = (_prefix(rng, int(rng.integers(2, 9))),
                           _prefix(rng, int(rng.integers(2, 9))))
            s["frames"] = 3
        else:
            s["prefix"] = _prefix(rng, int(rng.integers(2, 12)))
        out.append(s)
    return out


def _requests(specs, seed):
    """Fresh JAX and port request lists with the same keys (a fleet
    stamps its requests, so every run gets its own)."""
    keys = [jax.random.fold_in(jax.random.key(seed), i)
            for i in range(len(specs))]
    return ([JRequest(key=k, **s) for k, s in zip(keys, specs)],
            [Request(key=np.asarray(jax.random.key_data(k)), **s)
             for k, s in zip(keys, specs)])


def _same_strokes(a, b):
    """Steps, lengths and pens exact, offsets within TOL; returns the
    largest offset gap."""
    sa, sb = np.asarray(a.strokes5), np.asarray(b.strokes5)
    assert (a.steps, a.length, a.endpoint) == (b.steps, b.length,
                                               b.endpoint)
    assert sa.shape == sb.shape and np.array_equal(sa[:, 2:], sb[:, 2:])
    err = float(np.max(np.abs(sa - sb)))
    assert err <= TOL, err
    return err


def _bitwise(a, b):
    assert a.steps == b.steps and a.strokes5.dtype == b.strokes5.dtype
    assert np.array_equal(a.strokes5, b.strokes5)
    if a.frames is not None or b.frames is not None:
        assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))


# -- quantize -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_quantize_for_serving_matches_jax(setup, mode):
    _, jp, _, p = setup
    jparams = jax.device_get(jp)
    jout, jrep = jq.quantize_for_serving(jparams, mode)
    tout, trep = q.quantize_for_serving(p, mode)
    assert trep == jrep and len(trep) > 0
    flat = lambda t, pre="": (
        [x for k, v in t.items() for x in flat(v, f"{pre}/{k}")]
        if isinstance(t, dict) else [(pre, t)])
    for (ka, a), (kb, b) in zip(flat(jout), flat(tout)):
        assert ka == kb and isinstance(b, torch.Tensor)
        assert b.dtype == torch.float32 and b.device == CPU
        assert np.array_equal(np.asarray(a), b.numpy()), ka
    # the packed storage: int8 codes, or the bfloat16 bit patterns
    jpk, _ = jq.quantize_params(jparams, mode)
    tpk, _ = q.quantize_params(p, mode)
    for (ka, a), (kb, b) in zip(flat(jpk), flat(tpk)):
        if not isinstance(a, jq.QTensor):
            continue
        assert a.scale == b.scale
        if mode == "int8":
            assert b.q.dtype == np.int8 and np.array_equal(a.q, b.q)
        else:
            assert np.array_equal(np.asarray(a.q).view(np.uint16),
                                  b.q.view(torch.int16).numpy()
                                  .view(np.uint16))
        w = np.asarray(jax.device_get(jparams["out_w"]))
        assert q.max_error_bound(w, mode) == jq.max_error_bound(w, mode)
    for ckpt in ("", "ckpt_00000042"):
        for m in q.QUANT_MODES:
            assert q.stamp_ckpt_id(ckpt, m) == jq.stamp_ckpt_id(ckpt, m)
    rng = np.random.default_rng(3)
    base = rng.normal(size=(5, 7)).astype(np.float32)
    tgt = base + 0.01 * rng.normal(size=(5, 7)).astype(np.float32)
    jd, td = jq.quantize_delta(base, tgt), q.quantize_delta(base, tgt)
    assert jd.scale == td.scale and np.array_equal(jd.q, td.q)
    assert np.array_equal(jq.apply_delta(base, jd), q.apply_delta(base, td))
    with pytest.raises(ValueError, match="quantization mode"):
        q.check_mode("fp8")


# -- SLOs and admission -------------------------------------------------------

SLO_SPECS = ["p95<=0.25", "p99<=400ms", "generate:p95<=0.25",
             "generate:decode_s:p99<=0.1", "interactive:queue_wait_s:p50<=5"]
BAD_SLO_SPECS = ["p95", "p95<=x", "q95<=1", "a:b:c:p95<=1",
                 "9x:p95<=1", "generate:foo:p95<=1", "p95<=-1",
                 "p101<=1"]


def _err(fn, *a):
    try:
        fn(*a)
    except (ValueError, KeyError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def test_parse_slo_and_tracker_match_jax():
    for spec in SLO_SPECS:
        assert dataclasses.asdict(slo.parse_slo(spec)) == \
            dataclasses.asdict(jslo.parse_slo(spec))
        assert slo.parse_slo(spec).key == jslo.parse_slo(spec).key
    for spec in BAD_SLO_SPECS:
        got, want = _err(slo.parse_slo, spec), _err(jslo.parse_slo, spec)
        assert got == want and got is not None, spec
    specs = SLO_SPECS[:2] + SLO_SPECS[3:]
    trackers = [mod.SLOTracker([mod.parse_slo(s) for s in specs],
                               window=16) for mod in (slo, jslo)]
    rng = np.random.default_rng(0)
    for _ in range(50):
        ep = ["generate", "interactive", "other"][int(rng.integers(3))]
        vals = {k: float(v) for k, v in zip(
            slo.RESULT_METRICS, rng.exponential(0.2, 3))}
        for t in trackers:
            t.observe(ep, vals)
    assert trackers[0].summary() == trackers[1].summary()
    assert trackers[0].healthy() == trackers[1].healthy()


def test_admission_classes_and_controller_match_jax():
    for specs in ([], CLASSES, ["a:p50<=1", "b:latency_s:p99<=2s"],
                  ["a:p50<=1", "a:p99<=2"]):
        got = _err(adm.parse_admission_classes, specs)
        want = _err(jadm.parse_admission_classes, specs)
        assert got == want
        if got is None:
            a = adm.parse_admission_classes(specs)
            b = jadm.parse_admission_classes(specs)
            assert {k: dataclasses.asdict(v) for k, v in a.items()} == \
                {k: dataclasses.asdict(v) for k, v in b.items()}
    tspecs = ["acme:interactive:p95<=250ms", "acme:p99<=1", "globex:b:p50<=2"]
    assert {k: [dataclasses.asdict(s) for s in v] for k, v in
            adm.parse_tenant_slos(tspecs).items()} == \
        {k: [dataclasses.asdict(s) for s in v] for k, v in
         jadm.parse_tenant_slos(tspecs).items()}
    ctl = [mod.AdmissionController(mod.parse_admission_classes(CLASSES),
                                   n_replicas=3, slots=2, queue_cap=5)
           for mod in (adm, jadm)]
    rng = np.random.default_rng(1)
    script = []
    for i in range(80):
        if i in (30, 50, 60):
            script.append(({30: "mark_dead", 50: "retire",
                            60: "rejoin"}[i], 1 + (i > 30)))
        elif rng.random() < 0.55:
            script.append(("place", CLASSES[int(rng.integers(2))]
                           .split(":")[0], int(rng.integers(1, 4)),
                           bool(rng.random() < 0.1)))
        else:
            script.append(("note_done", float(rng.exponential(0.5))))
    outstanding = []        # (replica, cost) admitted and not yet done
    for step in script:
        kind = step[0]
        if kind == "place":
            a, b = (c.place(step[1], cost=step[2], force=step[3])
                    for c in ctl)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            if not a.shed:
                outstanding.append((a.replica, step[2]))
        elif kind == "note_done":
            if outstanding:
                r, cost = outstanding.pop(0)
                for c in ctl:
                    c.note_done(r, step[1], cost=cost)
        elif kind == "mark_dead":
            assert ctl[0].mark_dead(step[1]) == ctl[1].mark_dead(step[1])
            outstanding = [(r, k) for r, k in outstanding if r != step[1]]
        else:
            for c in ctl:
                getattr(c, kind)(step[1])
        assert ctl[0].summary() == ctl[1].summary(), step
    assert ctl[0].summary()["shed_total"] > 0
    assert _err(ctl[0].note_done, 0, 0.1, 99) == \
        _err(ctl[1].note_done, 0, 0.1, 99)
    assert _err(ctl[0].place, "nope") == _err(ctl[1].place, "nope")
    assert _err(ctl[0].rejoin, 1) == _err(ctl[1].rejoin, 1)


# -- load generation and bursts -----------------------------------------------


def test_arrivals_traces_and_mix_ids_bitwise():
    for n, rate, seed in ((0, 5.0, 0), (17, 0.0, 1), (300, 250.0, 2),
                          (64, 1e4, 3)):
        a, b = lg.poisson_arrivals(n, rate, seed), \
            jlg.poisson_arrivals(n, rate, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    emix = "generate:4,complete:3,reconstruct:2,interpolate"
    tmix = "acme:2,globex:1"
    assert lg.parse_endpoint_mix(emix) == jlg.parse_endpoint_mix(emix)
    assert lg.parse_tenant_mix(tmix) == jlg.parse_tenant_mix(tmix)
    for bad in ("", "a:x"):
        assert _err(lg.parse_endpoint_mix, bad) == \
            _err(jlg.parse_endpoint_mix, bad)
    for kind in lg.TRACE_KINDS:
        kw = dict(kind=kind, n=200, rate_hz=80.0, seed=5, unique=40,
                  endpoint_mix=lg.parse_endpoint_mix(emix),
                  tenant_mix=lg.parse_tenant_mix(tmix))
        a, b = lg.make_trace(lg.TraceSpec(**kw)), \
            jlg.make_trace(jlg.TraceSpec(**kw))
        for f in ("arrivals", "request_ids", "endpoint_ids", "tenant_ids"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (kind, f)
        assert a.distinct() == b.distinct()
        assert a.endpoint_counts() == b.endpoint_counts()
        assert a.tenant_counts() == b.tenant_counts()
    mix = lg.parse_endpoint_mix(emix)
    assert np.array_equal(lg.endpoint_mix_ids(50, mix, 9),
                          jlg.endpoint_mix_ids(50, mix, 9))
    assert np.array_equal(lg.tenant_mix_ids(50, mix, 9),
                          jlg.tenant_mix_ids(50, mix, 9))
    assert _err(lg.TraceSpec, "nope") == _err(jlg.TraceSpec, "nope")


def test_load_generator_submits_in_schedule_order():
    arrivals = lg.poisson_arrivals(40, 4000.0, 0)
    seen = []
    gen = lg.OpenLoopLoadGen(arrivals, seen.append).start()
    assert gen.join(timeout=30) and gen.done
    assert seen == list(range(40)) and gen.submitted == 40
    assert gen.max_lag_s >= 0.0
    # stop() abandons what is left
    gen = lg.OpenLoopLoadGen([0.0, 60.0], seen.append).start()
    deadline = time.perf_counter() + 5
    while gen.submitted < 1 and time.perf_counter() < deadline:
        time.sleep(0.005)
    gen.stop()
    assert gen.submitted == 1 and gen not in lg.live_generators()
    with pytest.raises(ValueError, match="non-decreasing"):
        lg.OpenLoopLoadGen([1.0, 0.5], seen.append)


@pytest.mark.parametrize("cap", [1, 4, 7])
def test_form_burst_matches_the_jax_scheduler(cap):
    rng = np.random.default_rng(cap)
    # (uid, cost, group) items in three priority queues
    items = [[(i * 10 + j, int(rng.integers(1, 4)), int(rng.integers(2)))
              for j in range(int(rng.integers(0, 6)))] for i in range(3)]
    jsched = GeometryRunScheduler("test")
    for group_of in (None, lambda it: it[2]):
        qa = [deque(q) for q in items]
        qb = [deque(q) for q in items]
        while any(qa):
            a = form_burst(qa, cap, cost_of=lambda it: it[1],
                           group_of=group_of)
            b = jsched.form_burst(qb, cap, cost_of=lambda it: it[1],
                                  group_of=group_of)
            assert a == b
            if not a:
                break        # a head that alone exceeds the cap
        assert [list(x) for x in qa] == [list(x) for x in qb]


# -- the engine's options -----------------------------------------------------


@pytest.mark.parametrize("recycle,pool_pad", [(False, 0), (True, 16),
                                              (False, 13)])
def test_engine_options_match_jax(setup, tmp_path, recycle, pool_pad):
    jm, jp, m, p = setup
    specs = _specs(9, seed=4, endpoints=False)
    jreqs, treqs = _requests(specs, seed=4)
    slos = [f"generate:{k}:p95<=100" for k in slo.RESULT_METRICS]
    jslo_t = jslo.SLOTracker([jslo.parse_slo(s) for s in slos])
    tslo_t = slo.SLOTracker([slo.parse_slo(s) for s in slos])
    jw = JMetricsWriter(str(tmp_path / "jax"), name="serve")
    tw = MetricsWriter(str(tmp_path / "port"), name="serve")
    jout = JServeEngine(jm, jm.hps, jp).run(
        jreqs, recycle=recycle, metrics_writer=jw, slo=jslo_t,
        pool_pad=pool_pad)
    eng = ServeEngine(m, m.hps, p, device="cpu", ckpt_id="ckpt_00000003",
                      replica_id=1)
    tout = eng.run(treqs, recycle=recycle, metrics_writer=tw, slo=tslo_t,
                   pool_pad=pool_pad)
    assert [r.uid for r in jout["results"]] == \
        [r.uid for r in tout["results"]]
    for a, b in zip(jout["results"], tout["results"]):
        _same_strokes(a, b)
        assert a.attributed_steps == b.attributed_steps
        assert b.ckpt_id == "ckpt_00000003"
    for k in ("completed", "decode_steps", "device_steps", "chunks",
              "dispatches", "dispatches_saved", "host_syncs",
              "steps_attributed", "steps_idle",
              "accepted_steps_per_device_step", "slot_utilization", "slo"):
        assert jout["metrics"][k] == tout["metrics"][k], k
    assert tout["metrics"]["slo"]["generate:latency_s:p95"]["total"] == 9
    rows = [[json.loads(line) for line in
             (tmp_path / d / "serve_metrics.jsonl").read_text().splitlines()]
            for d in ("jax", "port")]
    keep = ("step", "uid", "steps", "length", "attributed_steps")
    assert [{k: r[k] for k in keep} for r in rows[0]] == \
        [{k: r[k] for k in keep} for r in rows[1]]
    assert set(rows[0][0]) == set(rows[1][0])
    if not recycle:
        # static batching: a second wave starts only when all slots are
        # done, so it takes more chunks than continuous batching
        again = ServeEngine(m, m.hps, p, device="cpu").run(
            _requests(specs, seed=4)[1])
        assert again["metrics"]["chunks"] < tout["metrics"]["chunks"]
        for a, b in zip(sorted(again["results"], key=lambda r: r.uid),
                        sorted(tout["results"], key=lambda r: r.uid)):
            _bitwise(a, b)


def test_engine_refuses_later_options_by_name(setup):
    _, _, m, p = setup
    with pytest.raises(NotImplementedError, match="item 6"):
        ServeEngine(m, m.hps, p, device="cpu", draft_depth=2)
    eng = ServeEngine(m, m.hps, p, device="cpu", param_args=True)
    assert eng.param_args and eng.encode_reuse is None
    assert eng.serving_tenant == "" and eng.param_dtype == "float32"
    with pytest.raises(ValueError, match="pool pad"):
        eng.run([Request(key=np.zeros(2, np.uint32),
                         z=np.zeros(6, np.float32), uid=i)
                 for i in range(3)], pool_pad=2)


def test_generate_many_result_ended_and_exports_match_jax(setup):
    import sketch_rnn_tpu.serve as jserve
    import sketch_rnn_tpu_torch.serve as tserve
    from sketch_rnn_tpu.serve.engine import generate_many as jgen
    from sketch_rnn_tpu_torch.serve.engine import generate_many

    jm, jp, m, p = setup
    jreqs, treqs = _requests(_specs(6, seed=3, endpoints=False), seed=3)
    jout = jgen(jm, jp, jm.hps, jreqs)
    tout = generate_many(m, p, m.hps, treqs, device="cpu")
    jres = {r.uid: r for r in jout["results"]}
    for r in tout["results"]:
        _same_strokes(jres[r.uid], r)
        assert r.ended == jres[r.uid].ended
        assert r.ended == (r.steps > r.length) and not r.cached
    assert set(tserve.__all__) <= set(jserve.__all__)
    assert {"ResultCache", "request_fingerprint", "TenantStore",
            "PrefixReuseIndex", "generate_many"} <= set(tserve.__all__)
    assert all(hasattr(tserve, n) for n in tserve.__all__)


# -- the fleet ----------------------------------------------------------------

SUMMARY_KEYS = ("replicas", "replicas_dead", "replicas_live", "slots",
                "chunk", "pool_cap", "submitted", "completed", "shed",
                "shed_frac", "shed_by_class", "failed", "requeues",
                "retry_budget", "cost", "critical_path_device_steps",
                "total_device_steps")
REPLICA_KEYS = ("replica", "completed", "bursts", "chunks", "device_steps",
                "slot_utilization", "dead", "steps_attributed",
                "steps_idle")
ADMISSION_KEYS = ("admitted", "shed_total", "shed_by_class", "backlog",
                  "dead_replicas", "retired_replicas", "live_replicas",
                  "queue_cap", "classes")
HEALTH_KEYS = ("healthy", "serving_ckpt_id", "replicas", "replicas_live",
               "replicas_dead", "requests_failed", "requests_requeued",
               "fatal")
N_FLEET = 14


def _counters(fl):
    s, h = fl.summary(), fl.health()
    return {
        "summary": {k: s[k] for k in SUMMARY_KEYS},
        "per_replica": [{k: r[k] for k in REPLICA_KEYS}
                        for r in s["per_replica"]],
        "by_class": {c: v["completed"]
                     for c, v in s["latency_by_class"].items()},
        "by_endpoint": {e: v["completed"]
                        for e, v in s["latency_by_endpoint"].items()},
        "admission": {k: s["admission"][k] for k in ADMISSION_KEYS},
        "health": {k: h[k] for k in HEALTH_KEYS},
        "shed": [(x["uid"], x["class"], x["endpoint"], x["reason"])
                 for x in fl.shed],
        "placement": {u: (r["replica"], r["class"], r["queue_pos"],
                          r["endpoint"]) for u, r in fl.results.items()},
    }


def _run_fleet(cls, model, params, reqs, replicas, **kw):
    trk = (slo if cls is ServeFleet else jslo).SLOTracker(
        [(slo if cls is ServeFleet else jslo).parse_slo(
            f"{c}:p95<=100") for c in ("interactive", "batch")])
    mod = adm if cls is ServeFleet else jadm
    fl = cls(model, model.hps, params, replicas=replicas,
             classes=mod.parse_admission_classes(CLASSES),
             endpoint_classes=ROUTES, queue_cap=QUEUE_CAP[replicas],
             slo=trk, ckpt_id="ckpt_00000007", **kw)
    fl.warm(reqs[0], endpoints=True)
    admitted = [fl.submit(r) for r in reqs]
    with fl:
        assert fl.drain(timeout=120)
        return fl, admitted, trk.summary()


@pytest.fixture(scope="module")
def jax_fleets(setup):
    """The JAX fleet's closed burst at R=1 and R=2 (the tests' eight
    virtual CPU devices), run once for the module."""
    jm, jp, _, _ = setup
    out = {}
    for r in (1, 2):
        jreqs, _ = _requests(_specs(N_FLEET, seed=8), seed=8)
        fl, admitted, slo_sum = _run_fleet(JServeFleet, jm, jp, jreqs, r)
        out[r] = (fl.results, _counters(fl), admitted, slo_sum)
    return out


@pytest.mark.parametrize("replicas", [1, 2])
def test_fleet_closed_burst_matches_jax_and_the_single_engine(
        setup, jax_fleets, replicas):
    _, _, m, p = setup
    jres, jcount, jadmitted, jslo_sum = jax_fleets[replicas]
    _, treqs = _requests(_specs(N_FLEET, seed=8), seed=8)
    fl, admitted, slo_sum = _run_fleet(ServeFleet, m, p, treqs, replicas,
                                       devices=[CPU] * replicas)
    assert admitted == jadmitted and slo_sum == jslo_sum
    assert _counters(fl) == jcount
    res = fl.results
    assert sorted(res) == sorted(jres) and len(res) > 0
    worst = max(_same_strokes(jres[u]["result"], res[u]["result"])
                for u in res)
    assert worst <= TOL
    for u, rec in res.items():
        assert rec["result"].ckpt_id == "ckpt_00000007"
        f = rec["result"].frames
        assert (f is None) == (rec["endpoint"] != "interpolate")
    # placement invariance: the port's single engine serves the admitted
    # requests to the same bits
    _, single = _requests(_specs(N_FLEET, seed=8), seed=8)
    single = [r for r in single if r.uid in res]
    out = serve_requests(m, m.hps, p, single, device="cpu")
    for r in out["results"]:
        _bitwise(r, res[r.uid]["result"])
    # R=2 runs with a queue cap that sheds
    assert (jcount["summary"]["shed"] > 0) == (replicas == 2)


def test_fleet_checks_and_lifecycle(setup, monkeypatch):
    _, _, m, p = setup
    with pytest.raises(ValueError, match="devices"):
        ServeFleet(m, m.hps, p, replicas=3, devices=[CPU] * 2)
    for kw, item in ((dict(max_replicas=2), "item 5b-ii"),
                     (dict(draft_depth=2), "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            ServeFleet(m, m.hps, p, devices=[CPU], **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=.torch.device..cpu"):
        ServeFleet(m, m.hps, p)
    monkeypatch.undo()
    fl = ServeFleet(m, m.hps, p, devices=[CPU], queue_cap=3)
    _, treqs = _requests(_specs(8, seed=2, endpoints=False), seed=2)
    assert [fl.submit(r) for r in treqs] == [True] * 3 + [False] * 5
    with pytest.raises(ValueError, match="duplicate request uid"):
        fl.submit(dataclasses.replace(treqs[0], enqueue_ts=None))
    with pytest.raises(RuntimeError, match="queued work"):
        fl.reset()
    fl.start()
    assert fl.drain(timeout=60)
    assert fl.summary()["completed"] == 3 and fl.summary()["shed"] == 5
    assert repr(fl).endswith("running)")
    assert fl.close() == []
    fl.reset()                       # a closed fleet reopens
    assert fl.summary()["submitted"] == 0
    fl.submit(Request(key=np.zeros(2, np.uint32),
                      z=np.zeros(6, np.float32), max_len=3))
    with fl:
        assert fl.drain(timeout=60)
        assert fl.summary()["completed"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        fl.submit(Request(key=np.zeros(2, np.uint32),
                          z=np.zeros(6, np.float32)))
    fl = ServeFleet(m, m.hps, p, devices=[CPU])
    fl.submit(Request(key=np.zeros(2, np.uint32),
                      z=np.zeros(6, np.float32)))
    fl.close()
    with pytest.raises(RuntimeError, match="closed while draining"):
        fl.drain(timeout=5)


# -- failover -----------------------------------------------------------------


def _kill_first_burst(fl, replica):
    """Make ``replica``'s engine raise on its first burst."""
    eng = fl._replicas[replica].engine
    real = eng.run
    calls = []

    def run(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected burst failure")
        return real(*a, **k)

    eng.run = run


def test_failover_finishes_on_the_survivor_bitwise(setup):
    _, _, m, p = setup
    specs = _specs(8, seed=6)

    def run(kill):
        _, treqs = _requests(specs, seed=6)
        fl = ServeFleet(m, m.hps, p, replicas=2, devices=[CPU] * 2,
                        retry_backoff_s=0.0)
        if kill:
            _kill_first_burst(fl, 0)
        for r in treqs:
            # arrived 50 s ago: a clock rebased at the requeue would lose
            # it
            r.enqueue_ts = time.perf_counter() - 50.0
            fl.submit(r)
        with fl:
            assert fl.drain(timeout=60)
            return fl.results, fl.summary(), fl.health()

    res0, sum0, health0 = run(False)
    res1, sum1, health1 = run(True)
    assert health0["healthy"] and not health1["healthy"]
    assert "injected burst failure" in health1["replicas_dead"][0]["error"]
    assert sum1["completed"] == 8 and sum1["failed"] == 0
    assert sum1["replicas_dead"] == 1 and sum1["requeues"] > 0
    assert [r["dead"] for r in sum1["per_replica"]] == [True, False]
    assert all(rec["replica"] == 1 for rec in res1.values())
    assert sum1["admission"]["admitted"] == 8
    assert sum1["admission"]["dead_replicas"] == [0]
    assert sorted(res0) == sorted(res1) == list(range(8))
    for u in res0:
        _bitwise(res0[u]["result"], res1[u]["result"])
    # a retried request's clock still starts at its first arrival
    assert all(rec["result"].queue_wait_s >= 50.0
               for rec in res1.values())


def _jax_faulted(jm, jp, replicas, **kw):
    jreqs, _ = _requests(_specs(6, seed=7, endpoints=False), seed=7)
    jfaults.configure("fleet.worker.r0@0")
    try:
        fl = JServeFleet(jm, jm.hps, jp, replicas=replicas,
                         retry_backoff_s=0.0, **kw)
        for r in jreqs:
            fl.submit(r)
        with fl:
            try:
                fl.drain(timeout=60)
                raised = None
            except RuntimeError as e:
                raised = str(e)
            return fl, raised
    finally:
        jfaults.disable()


def _port_faulted(m, p, replicas, **kw):
    _, treqs = _requests(_specs(6, seed=7, endpoints=False), seed=7)
    fl = ServeFleet(m, m.hps, p, replicas=replicas,
                    devices=[CPU] * replicas, retry_backoff_s=0.0, **kw)
    _kill_first_burst(fl, 0)
    for r in treqs:
        fl.submit(r)
    with fl:
        try:
            fl.drain(timeout=60)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        return fl, raised


def test_failover_endings_match_jax(setup):
    jm, jp, m, p = setup
    # the last replica's death fails the fleet
    jfl, jraised = _jax_faulted(jm, jp, 1)
    tfl, traised = _port_faulted(m, p, 1)
    assert traised == jraised == "fleet worker failed"
    for fl in (jfl, tfl):
        h = fl.health()
        assert not h["healthy"] and h["fatal"] is not None
    with pytest.raises(RuntimeError, match="closed"):
        tfl.submit(Request(key=np.zeros(2, np.uint32),
                           z=np.zeros(6, np.float32)))
    # a spent retry budget fails the dead replica's requests, and the
    # drain completes
    jfl, jraised = _jax_faulted(jm, jp, 2, retry_budget=0)
    tfl, traised = _port_faulted(m, p, 2, retry_budget=0)
    assert jraised is None and traised is None
    strip = lambda f: {u: {k: v for k, v in rec.items() if k != "error"}
                       for u, rec in f.items()}
    assert strip(tfl.failed) == strip(jfl.failed) and tfl.failed
    assert sorted(tfl.results) == sorted(jfl.results)
    for fl in (jfl, tfl):
        s = fl.summary()
        assert s["failed"] == len(fl.failed) > 0
        assert s["completed"] == 6 - s["failed"]
    jh, th = jfl.health(), tfl.health()
    assert {k: th[k] for k in ("healthy", "requests_failed",
                               "requests_requeued", "replicas_live")} == \
        {k: jh[k] for k in ("healthy", "requests_failed",
                            "requests_requeued", "replicas_live")}
    with pytest.raises(RuntimeError, match="degraded"):
        tfl.reset()


def test_serving_encoder_at_fused_rnn_matches_jax():
    """At ``fused_rnn=true`` the endpoints' encoder runs through
    ``fused_lstm_seq``'s forward in both packages (row 4f on the card;
    its plain version here, Pallas in interpret mode in JAX)."""
    kw = dict(TINY, fused_rnn=True, dec_model="layer_norm")
    jm = JSketchRNN(JHParams(**kw))
    jp = jm.init_params(jax.random.key(1))
    m = SketchRNN(HParams(**kw))
    p = params_from_jax(jax.device_get(jp), device="cpu")
    specs = [s for s in _specs(8, seed=9) if s["endpoint"] != "generate"]
    jreqs, treqs = _requests(specs, seed=9)
    from sketch_rnn_tpu.serve.endpoints import serve_requests as jserve
    jout = {r.uid: r for r in jserve(jm, jm.hps, jp, jreqs)["results"]}
    tout = serve_requests(m, m.hps, p, treqs, device="cpu")["results"]
    assert len(tout) == len(specs)
    for r in tout:
        _same_strokes(jout[r.uid], r)
