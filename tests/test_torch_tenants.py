"""Paged tenants (``serve/tenants.py``), value-paged engines, the shared
encode reuse and the fleet's tenant paging in the port, against the JAX
package.

At the tiny sizes of ``tests/test_torch_fleet.py`` (encoder 12, decoder
16, z 6, M 3, 2 slots, K=2), weights carried across by ``convert.py``,
fine-tunes made with numpy:

- ``TenantStore``: pages (int8 ``q`` and scale) bitwise JAX's,
  ``materialize`` bitwise JAX's, equal ``memory_table`` and
  ``adapter_report``, the base leaves themselves for a zero-delta tenant,
  raw pages for scalar and integer leaves, and JAX's validation errors.
- ``PrefixReuseIndex``: keys equal JAX's; a racing miss coalesces into
  one compute; two planners claiming the same keys in opposite orders
  both finish (no claim is held while waiting).
- A value-paged engine at float32 and bfloat16: swapping A -> B -> A ->
  base keeps every weight tensor's ``data_ptr()`` and the chunk program,
  and serves each tree's strokes bitwise a fresh engine's (generate and
  complete); the base tree is untouched; a non-congruent tree or a new
  ``param_dtype`` rebinds.
- A fleet with tenants, a cache, a tenant cap and per-tenant SLOs, fed
  the same requests as the JAX fleet before ``start``: strokes within
  ``TOL`` = 1e-5 (steps, lengths and pens exact; the serving tolerance
  ``COND_TOL`` of ``tests/test_pallas_decode.py``), each tenant's strokes
  bitwise the port's own engine on ``materialize(tenant)``, sheds, the
  cache's and the reuse index's counters, tenant swaps and the
  ``summary()["tenants"]`` block's keys and counts equal JAX's; the
  unknown-tenant door rejects as JAX's does.
- ``cli serve-bench --tenants 2``: the report's tenant keys are JAX's, and
  the JAX CLI's tenant usage errors exit 2 with its messages.
"""

import dataclasses
import json
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from sketch_rnn_tpu import cli as jcli
from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.serve import admission as jadm
from sketch_rnn_tpu.serve import cache as jcache
from sketch_rnn_tpu.serve import tenants as jtn
from sketch_rnn_tpu.serve.engine import Request as JRequest
from sketch_rnn_tpu.serve.fleet import ServeFleet as JServeFleet
from sketch_rnn_tpu_torch import cli
from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.serve import admission as adm
from sketch_rnn_tpu_torch.serve import cache
from sketch_rnn_tpu_torch.serve import fleet as fleet_mod
from sketch_rnn_tpu_torch.serve import tenants as tn
from sketch_rnn_tpu_torch.serve.endpoints import (_encode_with_reuse,
                                                  serve_requests)
from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
from sketch_rnn_tpu_torch.serve.fleet import ServeFleet

TINY = dict(batch_size=8, max_seq_len=24, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, serve_slots=2,
            serve_chunk=2, conditional=True)
TOL = 1e-5
CPU = torch.device("cpu")
TENANTS = ("tz", "ta", "tb")


@pytest.fixture(autouse=True)
def _no_stray_fleet_threads():
    yield
    leaked = fleet_mod.stop_all()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(fleet_mod.THREAD_PREFIX)]
    assert not leaked and not alive, (leaked, alive)


def _nudge(tree, want, seed):
    """A fine-tune: leaves whose path holds a ``want`` part (all, with
    True) plus 0.02 N(0, 1), in float64 then back to the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(node[k], f"{path}/{k}" if path else k)
                    for k in sorted(node)}
        a = np.asarray(node)
        if want is True or any(w in path for w in want):
            return (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a.copy()
    return walk(tree)


@pytest.fixture(scope="module")
def setup():
    """The base in both packages and the fine-tunes ``tz`` (a copy),
    ``ta`` (every leaf) and ``tb`` (the output head), registered in a
    JAX store and in a port store."""
    jm = JSketchRNN(JHParams(**TINY))
    base_np = jax.device_get(jm.init_params(jax.random.key(0)))
    m = SketchRNN(HParams(**TINY))
    base = params_from_jax(base_np, device="cpu")
    tunes = {"tz": _nudge(base_np, [], 1), "ta": _nudge(base_np, True, 2),
             "tb": _nudge(base_np, ["out_w", "out_b"], 3)}
    jstore = jtn.TenantStore(base_np, base_ckpt_id="ckpt_00000007")
    store = tn.TenantStore(base, base_ckpt_id="ckpt_00000007")
    reports = {}
    for t in TENANTS:
        reports[t] = (store.register(t, params_from_jax(tunes[t], "cpu")),
                      jstore.register(t, tunes[t]))
    return types.SimpleNamespace(jm=jm, base_np=base_np, m=m, base=base,
                                 tunes=tunes, jstore=jstore, store=store,
                                 reports=reports)


# -- TenantStore ---------------------------------------------------------------


@pytest.mark.parametrize("tenant", TENANTS)
def test_pages_and_trees_are_jax_bitwise(setup, tenant):
    s = setup
    mine, ref = s.reports[tenant]
    assert mine == ref
    assert s.store.adapter_report(tenant) == s.jstore.adapter_report(tenant)
    pages = s.store._adapters[tenant]["pages"]
    jpages = s.jstore._adapters[tenant]["pages"]
    assert sorted(pages) == sorted(jpages)
    for path, p in pages.items():
        q = jpages[path]
        assert p.scale == q.scale and p.q.dtype == q.q.dtype == np.int8
        assert np.array_equal(p.q, q.q)
    got = dict(tn._walk(s.store.materialize(tenant)))
    want = dict(jtn._walk(s.jstore.materialize(tenant)))
    assert list(got) == list(want)
    for path, leaf in got.items():
        w = np.asarray(want[path])
        assert isinstance(leaf, torch.Tensor) and leaf.device == CPU
        assert leaf.numpy().dtype == w.dtype
        assert np.array_equal(leaf.numpy(), w)
    assert s.store.ckpt_id_of(tenant) == s.jstore.ckpt_id_of(tenant) \
        == f"ckpt_00000007+{tenant}"


def test_zero_delta_tenant_is_the_base_and_memory_matches(setup):
    s = setup
    assert s.reports["tz"][0]["pages"] == 0
    got = dict(tn._walk(s.store.materialize("tz")))
    assert all(got[p] is leaf for p, leaf in tn._walk(s.base))
    assert s.store.materialize("") is s.base
    assert s.store.memory_table() == s.jstore.memory_table()
    assert s.store.memory_table()["ratio"] < 1.0
    assert tn.tree_nbytes(s.base) == jtn.tree_nbytes(s.base_np)
    assert s.store.tenants == list(TENANTS) and "" in s.store
    assert "nope" not in s.store


def test_raw_pages_for_scalars_and_ints_match_jax():
    base = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "s": np.float32(0.5), "i": np.array([1, 2], np.int32)}
    tune = {"w": base["w"] + 0.25, "s": np.float32(0.75),
            "i": np.array([1, 3], np.int32)}
    mine = tn.TenantStore({k: torch.from_numpy(np.array(v))
                           for k, v in base.items()})
    ref = jtn.TenantStore(base)
    assert mine.register("t", tune) == ref.register("t", tune)
    got, want = mine.materialize("t"), ref.materialize("t")
    for k in base:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert mine.memory_table() == ref.memory_table()


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["empty_name", "duplicate", "missing",
                                  "extra", "shape", "empty_base"])
def test_validation_errors_are_jax_s(setup, case):
    s = setup
    bad = {k: dict(v) if isinstance(v, dict) else v
           for k, v in s.tunes["tb"].items()}
    if case == "missing":
        del bad["out_b"]
    elif case == "extra":
        bad["zz"] = np.zeros(2, np.float32)
    elif case == "shape":
        bad["out_b"] = np.zeros(3, np.float32)
    name = {"empty_name": "", "duplicate": "ta"}.get(case, "tq")
    if case == "empty_base":
        assert _error(lambda: tn.TenantStore({})) == \
            _error(lambda: jtn.TenantStore({}))
        return
    assert _error(lambda: s.store.register(name, bad)) == \
        _error(lambda: s.jstore.register(name, bad))


# -- PrefixReuseIndex ----------------------------------------------------------


@pytest.mark.parametrize("rows,edge,label", [(3, 32, 0), (7, 64, 5)])
def test_reuse_keys_are_jax_s(rows, edge, label):
    p = np.random.default_rng(rows).normal(size=(rows, 3)).astype(
        np.float32)
    for tenant in ("", "ta"):
        assert tn.PrefixReuseIndex.key(tenant, p, edge, label) == \
            jtn.PrefixReuseIndex.key(tenant, p, edge, label)
    assert tn.PrefixReuseIndex.key("", p, edge) != \
        tn.PrefixReuseIndex.key("", p.reshape(1, -1), edge)


def test_a_racing_miss_coalesces_into_one_compute():
    idx = tn.PrefixReuseIndex()
    key = idx.key("t", np.zeros((2, 3), np.float32), 32)
    assert idx.acquire(key) == ("compute", None)
    assert idx.acquire(key, wait=False) == ("busy", None)
    got = []
    waiter = threading.Thread(target=lambda: got.append(idx.acquire(key)))
    waiter.start()
    time.sleep(0.05)
    assert not got                    # waiting on the claim
    idx.fill(key, ("mu", "carry", "prev"))
    waiter.join(timeout=10)
    assert got == [("hit", ("mu", "carry", "prev"))]
    # an abandoned claim passes to the next caller, counted once
    k2 = idx.key("t", np.ones((2, 3), np.float32), 32)
    assert idx.acquire(k2)[0] == "compute"
    idx.abandon(k2)
    assert idx.acquire(k2)[0] == "compute"
    idx.note_reuses(2)
    assert idx.stats() == {"computes": 2, "reuses": 3, "distinct": 1}


class _GatedIndex(tn.PrefixReuseIndex):
    """An index whose every caller, after its first acquire, waits until
    two callers have made theirs: two planners then each hold one
    claim."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Barrier(2, timeout=10)
        self.started = set()

    def acquire(self, key, wait=True):
        out = super().acquire(key, wait)
        if threading.get_ident() not in self.started:
            self.started.add(threading.get_ident())
            self.gate.wait()
        return out


def test_planners_claiming_in_opposite_orders_both_finish():
    """Two planners on one index, jobs [p1, p2] and [p2, p1], each holding
    the claim on its first prefix when it reaches its second: both
    finish, each prefix encoded once (a planner that waited while holding
    its claim would wait forever)."""
    idx = _GatedIndex()
    encoded = []

    def encode(prefixes, labels):
        encoded.extend(float(p[0, 0]) for p in prefixes)
        n = len(prefixes)
        return (np.stack([np.full(6, p[0, 0], np.float32)
                          for p in prefixes]),
                np.zeros((n, 32), np.float32), np.zeros((n, 5), np.float32))

    engine = types.SimpleNamespace(
        encoder=types.SimpleNamespace(edges=(32,), encode=encode),
        hps=types.SimpleNamespace(z_size=6),
        model=types.SimpleNamespace(dec=types.SimpleNamespace(
            carry_size=32)),
        serving_tenant="t", ckpt_id="")
    p1, p2 = (np.full((2, 3), v, np.float32) for v in (1.0, 2.0))
    req = types.SimpleNamespace(label=0)
    out = {}

    def plan(name, order):
        jobs = [(req, 0, p) for p in order]
        out[name] = _encode_with_reuse(engine, idx, jobs, lambda js: None)

    threads = [threading.Thread(target=plan, args=(n, o))
               for n, o in (("a", (p1, p2)), ("b", (p2, p1)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert sorted(encoded) == [1.0, 2.0]
    assert [r[0] for r in out["a"][0]] == [1.0, 2.0]
    assert [r[0] for r in out["b"][0]] == [2.0, 1.0]
    assert idx.stats() == {"computes": 2, "reuses": 2, "distinct": 2}


# -- the value-paged engine ----------------------------------------------------


def _engine_requests(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(5):
        kw = dict(key=np.array([7, i], np.uint32), uid=i, max_len=6,
                  temperature=0.7)
        if i % 2:
            p = np.zeros((4, 3), np.float32)
            p[:, :2] = rng.normal(size=(4, 2))
            kw.update(endpoint="complete", prefix=p)
        else:
            kw["z"] = rng.standard_normal(6).astype(np.float32)
        out.append(Request(**kw))
    return out


def _served(eng, tree=None):
    """Strokes of ``_engine_requests`` by uid, through ``eng`` (or a
    fresh engine on ``tree``)."""
    out = serve_requests(eng.model, eng.hps, tree, _engine_requests(4),
                         engine=None if tree is not None else eng,
                         device="cpu")
    return {r.uid: r.strokes5 for r in out["results"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_congruent_swap_keeps_every_tensor_and_serves_bitwise(setup,
                                                              dtype):
    s = setup
    m = SketchRNN(HParams(**TINY, compute_dtype=dtype))
    before = {p: leaf.clone() for p, leaf in tn._walk(s.base)}
    eng = ServeEngine(m, m.hps, s.base, device="cpu", param_args=True)
    _served(eng)                          # builds the encoder
    ptrs = [t.data_ptr() for _, t in eng.weights]
    assert len(eng.weights) > len(eng._chunk_fn.weights) > 0
    chunk_fn, encoder = eng._chunk_fn, eng._encoder
    # the engine owns its tensors: none is the caller's
    base_ptrs = {leaf.data_ptr() for _, leaf in tn._walk(s.base)}
    assert not base_ptrs & set(ptrs)
    outs = {}
    for t in ("ta", "tb", "ta", ""):
        tree = s.store.materialize(t)
        eng.swap_params(tree, ckpt_id=s.store.ckpt_id_of(t))
        got, want = _served(eng), _served(eng, tree)
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[u], want[u]) for u in got), t
        outs[t] = got
        assert eng.ckpt_id == s.store.ckpt_id_of(t)
    assert [t.data_ptr() for _, t in eng.weights] == ptrs
    assert eng._chunk_fn is chunk_fn and eng._encoder is encoder
    assert any(not np.array_equal(outs["ta"][u], outs["tb"][u])
               for u in outs["ta"])
    assert all(torch.equal(before[p], leaf) for p, leaf in tn._walk(s.base))
    # a non-congruent tree rebinds: new tensors, a new chunk program
    wide = dict(s.base, out_b=s.base["out_b"].double())
    eng.swap_params(wide)
    assert eng._chunk_fn is not chunk_fn and eng._encoder is None
    eng.swap_params(s.base)
    chunk_fn = eng._chunk_fn
    eng.swap_params(s.base, param_dtype="int8")
    assert eng._chunk_fn is not chunk_fn and eng.param_dtype == "int8"
    # without param_args a swap rebinds too
    plain = ServeEngine(m, m.hps, s.base, device="cpu")
    fn = plain._chunk_fn
    plain.swap_params(s.store.materialize("tb"))
    assert plain._chunk_fn is not fn
    assert plain.encode_reuse is None and plain.serving_tenant == ""


# -- the fleet ----------------------------------------------------------------

N_FLEET = 16
# pre-start, a tenant's rows only add up: the three tenants given five
# rows each shed their last request
TENANT_CAP = 4
TENANT_OF = ("", "ta", "tb", "tz")


def _prefix(rng, n):
    a = np.zeros((n, 3), np.float32)
    a[:, :2] = rng.normal(size=(n, 2))
    a[:, 2] = rng.random(n) < 0.2
    return a


def _fleet_specs(seed):
    """Twelve contents, tenant ``TENANT_OF[i % 4]`` and three consecutive
    endpoints a tenant; every encoder request starts from one shared
    prefix; requests 12-15 repeat 0-3."""
    rng = np.random.default_rng(seed)
    shared = _prefix(rng, 5)
    eps = ["generate", "complete", "reconstruct", "interpolate"]
    out = []
    for i in range(12):
        ep = eps[(i // 4 + i) % 4]
        s = dict(endpoint=ep, temperature=0.8, tenant=TENANT_OF[i % 4],
                 max_len=int(rng.integers(4, 9)))
        if ep == "generate":
            s["z"] = rng.standard_normal(6).astype(np.float32)
        elif ep == "interpolate":
            s.update(prefix=(shared, _prefix(rng, 3)), frames=3)
        else:
            s["prefix"] = shared
        out.append(s)
    return out + out[:4]


def _fleet_requests(seed):
    keys = [jax.random.fold_in(jax.random.key(seed), i % 12)
            for i in range(N_FLEET)]
    specs = _fleet_specs(seed)
    return ([JRequest(key=k, uid=i, **s)
             for i, (k, s) in enumerate(zip(keys, specs))],
            [Request(key=np.asarray(jax.random.key_data(k)), uid=i, **s)
             for i, (k, s) in enumerate(zip(keys, specs))])


def _run_tenant_fleet(cls, model, params, store, reqs, **kw):
    port = cls is ServeFleet
    fl = cls(model, model.hps, params, replicas=1,
             cache=(cache if port else jcache).ResultCache(),
             tenants=store, tenant_cap=TENANT_CAP,
             tenant_slos=(adm if port else jadm).parse_tenant_slos(
                 ["ta:p95<=100", "tb:p99<=100"]),
             **kw)
    with pytest.raises(ValueError) as e:
        fl.submit(dataclasses.replace(reqs[0], uid=999, tenant="nope"))
    admitted = [fl.submit(r) for r in reqs]
    with fl:
        assert fl.drain(timeout=120)
        return (fl.results, fl.summary(), fl.health(), admitted,
                [(x["uid"], x["tenant"], x["reason"]) for x in fl.shed],
                str(e.value))


@pytest.fixture(scope="module")
def jax_tenant_fleet(setup):
    jreqs, _ = _fleet_requests(41)
    return _run_tenant_fleet(JServeFleet, setup.jm, setup.base_np,
                             setup.jstore, jreqs)


def test_tenant_fleet_matches_jax_and_single_tenant_engines(
        setup, jax_tenant_fleet):
    s = setup
    jres, jsum, jhealth, jadmitted, jshed, jdoor = jax_tenant_fleet
    _, treqs = _fleet_requests(41)
    res, summ, health, admitted, shed, door = _run_tenant_fleet(
        ServeFleet, s.m, s.base, s.store, treqs, devices=[CPU])
    assert door == jdoor and "unknown tenant 'nope'" in door
    assert admitted == jadmitted and shed == jshed and shed
    assert sorted(res) == sorted(jres)
    for u, rec in res.items():
        a, b = rec["result"], jres[u]["result"]
        assert (a.steps, a.length, a.endpoint, a.cached, a.ckpt_id) == \
            (b.steps, b.length, b.endpoint, b.cached, b.ckpt_id)
        assert rec["tenant"] == jres[u]["tenant"]
        assert np.array_equal(a.strokes5[:, 2:], b.strokes5[:, 2:])
        assert float(np.max(np.abs(a.strokes5 - b.strokes5))) <= TOL
    jt, tt = jsum["tenants"], summ["tenants"]
    assert set(tt) == set(jt)
    for k in ("registered", "tenant_cap", "tenant_swaps", "shed_by_tenant",
              "memory", "encode_reuse"):
        assert tt[k] == jt[k], k
    assert {t: v["completed"] for t, v in tt["latency_by_tenant"].items()} \
        == {t: v["completed"] for t, v in jt["latency_by_tenant"].items()}
    assert {t: {k: v["total"] for k, v in x.items()}
            for t, x in tt["slo_by_tenant"].items()} == \
        {t: {k: v["total"] for k, v in x.items()}
         for t, x in jt["slo_by_tenant"].items()}
    assert tt["tenant_swaps"] > 0
    reuse = tt["encode_reuse"]
    assert reuse["computes"] == reuse["distinct"] and reuse["reuses"] > 0
    assert summ["cache"] == jsum["cache"] and summ["completed_cached"] > 0
    assert summ["per_replica"][0]["tenant_swaps"] == tt["tenant_swaps"]
    assert health["tenants"] == jhealth["tenants"]
    # each tenant's strokes: bitwise the port's engine on its tree
    by_tenant = {}
    for r in treqs:
        if r.uid in res:
            by_tenant.setdefault(r.tenant, []).append(r.uid)
    _, fresh = _fleet_requests(41)
    for t, uids in by_tenant.items():
        out = serve_requests(s.m, s.m.hps, s.store.materialize(t),
                             [fresh[u] for u in uids], device="cpu")
        for r in out["results"]:
            got = res[r.uid]["result"]
            assert np.array_equal(got.strokes5, r.strokes5), (t, r.uid)
            assert got.ckpt_id == s.store.ckpt_id_of(t)


def test_a_fleet_without_tenants_refuses_a_tenant(setup):
    s = setup
    fl = ServeFleet(s.m, s.m.hps, s.base, devices=[CPU])
    jfl = JServeFleet(s.jm, s.jm.hps, s.base_np)
    _, treqs = _fleet_requests(41)
    jreqs, _ = _fleet_requests(41)
    assert _error(lambda: fl.submit(treqs[1])) == \
        _error(lambda: jfl.submit(jreqs[1]))
    fl.close()
    jfl.close()


# -- cli serve-bench --tenants ------------------------------------------------

HP = ("batch_size=8,max_seq_len=24,enc_rnn_size=12,dec_rnn_size=16,"
      "z_size=6,num_mixture=3,serve_slots=2,serve_chunk=2")
# fleet keys of features the port does not have yet (item 5b-ii, 7)
UNPORTED = {"run_id", "spans", "tail", "metrics_port", "metrics_prom"}
UNPORTED_FLEET = {"replicas_retired", "scale_log", "tail"}


def _report(main, wd, args, capsys, extra=()):
    assert main(["serve-bench", "--random_init", f"--hparams={HP}",
                 f"--workdir={wd}", *args, *extra]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_bench_tenants_reports_the_jax_keys(tmp_path, capsys):
    args = ["-n", "12", "--fleet", "2", "--rate", "400", "--tenants", "2",
            "--tenant_cap", "8", "--tenant_slo", "tn1:p95<=100"]
    jrep = _report(jcli.main, tmp_path / "jax", args, capsys)
    trep = _report(cli.main, tmp_path / "port", args, capsys,
                   ["--device", "cpu"])
    assert set(trep) == set(jrep) - UNPORTED
    assert set(trep["fleet"]) == set(jrep["fleet"]) - UNPORTED_FLEET
    assert set(trep["fleet"]["tenants"]) == set(jrep["fleet"]["tenants"])
    assert trep["fleet"]["tenant_mix"] == jrep["fleet"]["tenant_mix"]
    assert trep["fleet"]["tenants"]["memory"] == \
        jrep["fleet"]["tenants"]["memory"]
    assert set(trep["latency_by_tenant"]) <= {"", "tn0", "tn1"}
    f = trep["fleet"]
    assert f["submitted"] == 12 == f["completed"] + f["shed"]
    assert trep["tenant_swaps"] == f["tenants"]["tenant_swaps"] > 0


@pytest.mark.parametrize("args", [
    ["--tenants", "2"],
    ["--fleet", "--tenants", "1"],
    ["--fleet", "--tenants", "2", "--tenant_cap", "-1"],
    ["--fleet", "--tenants", "2", "--tenant_mix", "tn5:1"],
    ["--fleet", "--tenants", "2", "--tenant_slo", "tn0"],
    ["--fleet", "--tenants", "2", "--tenant_slo", "zz:p95<=1"]])
def test_tenant_usage_errors_exit_2_as_in_jax(tmp_path, capsys, args):
    wd = [f"--workdir={tmp_path}", f"--hparams={HP}"]
    assert jcli.main(["serve-bench", *args, *wd]) == 2
    want = capsys.readouterr().err
    assert cli.main(["serve-bench", *args, *wd, "--device", "cpu"]) == 2
    assert capsys.readouterr().err == want
    assert not any(tmp_path.iterdir())
