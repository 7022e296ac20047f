"""The result cache of the port (``serve/cache.py``) and the fleet's use of
it, against the JAX package.

At the tiny sizes of ``tests/test_torch_fleet.py`` (encoder 12, decoder
16, z 6, M 3, 2 slots, K=2), weights carried across by ``convert.py``:

- ``request_fingerprint``: byte for byte the JAX digest over a table of
  requests (generate with and without z, every endpoint, interpolate's
  pair and frames, labels, temperatures, ``max_len=None``) and
  namespaces (``config_hash``, ``ckpt_id``, a tenant's ckpt_id).
- ``ResultCache``: one get/put sequence through both packages leaves
  equal ``keys()`` and ``stats()``, bounded by entries and by bytes.
- A fleet with a cache (two CPU replicas), each content submitted twice
  before ``start`` and once more after the drain: strokes within
  ``TOL`` = 1e-5 of the JAX fleet's (steps, lengths and pens exact, the
  serving tolerance ``COND_TOL`` of ``tests/test_pallas_decode.py``), the
  coalesced repeats and the later hits bitwise the port's own
  computation at zero attributed steps, the misses that computed (misses
  less coalesced) equal to the distinct contents, and the cache's
  counters equal JAX's.
- A primary whose replica dies with no retry budget fails its coalesced
  waiters, as in JAX.
"""

import dataclasses
import threading
import types

import jax
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.serve import cache as jcache
from sketch_rnn_tpu.serve.engine import Request as JRequest
from sketch_rnn_tpu.serve.fleet import ServeFleet as JServeFleet
from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.serve import cache
from sketch_rnn_tpu_torch.serve import fleet as fleet_mod
from sketch_rnn_tpu_torch.serve.engine import Request
from sketch_rnn_tpu_torch.serve.fleet import ServeFleet

TINY = dict(batch_size=8, max_seq_len=24, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, serve_slots=2,
            serve_chunk=2, conditional=True)
TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_stray_fleet_threads():
    yield
    leaked = fleet_mod.stop_all()
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


def _pair(seed, **fields):
    """The same request in both packages: a JAX key and its two words."""
    k = jax.random.fold_in(jax.random.key(seed), 3)
    return (JRequest(key=k, **fields),
            Request(key=np.asarray(jax.random.key_data(k)), **fields))


_RNG = np.random.default_rng(5)
_Z = _RNG.standard_normal(6).astype(np.float32)
_P1, _P2 = _prefix(_RNG, 7), _prefix(_RNG, 4)
FINGERPRINT_CASES = {
    "generate_z": (dict(z=_Z), ("", "")),
    "generate_no_z": (dict(), ("", "")),
    "generate_label_temp": (dict(z=_Z, label=3, temperature=0.37),
                            ("", "")),
    "generate_max_len": (dict(z=_Z, max_len=17), ("", "")),
    "complete": (dict(endpoint="complete", prefix=_P1), ("", "")),
    "reconstruct": (dict(endpoint="reconstruct", prefix=_P1, label=2),
                    ("", "")),
    "interpolate_frames": (dict(endpoint="interpolate",
                                prefix=(_P1, _P2), frames=4), ("", "")),
    "interpolate_swapped": (dict(endpoint="interpolate",
                                 prefix=(_P2, _P1)), ("", "")),
    "config_hash": (dict(z=_Z), ("9f3a", "")),
    "ckpt_id": (dict(z=_Z), ("9f3a", "ckpt_00000007:int8")),
    "tenant_ckpt_id": (dict(endpoint="complete", prefix=_P2),
                       ("", "ckpt_00000007+tn1")),
}


@pytest.mark.parametrize("case", sorted(FINGERPRINT_CASES))
def test_fingerprint_is_jax_byte_for_byte(case):
    fields, (config_hash, ckpt_id) = FINGERPRINT_CASES[case]
    jreq, treq = _pair(11, **fields)
    want = jcache.request_fingerprint(jreq, config_hash, ckpt_id)
    assert cache.request_fingerprint(treq, config_hash, ckpt_id) == want
    # the cache's namespace, and its override
    assert cache.ResultCache(config_hash, ckpt_id).fingerprint(treq) == \
        jcache.ResultCache(config_hash, ckpt_id).fingerprint(jreq)
    assert cache.ResultCache(config_hash).fingerprint(
        treq, ckpt_id="tn") == jcache.ResultCache(config_hash).fingerprint(
            jreq, ckpt_id="tn")


def test_fingerprints_of_distinct_contents_differ():
    digests = {cache.request_fingerprint(_pair(11, **f)[1], *ns)
               for f, ns in FINGERPRINT_CASES.values()}
    assert len(digests) == len(FINGERPRINT_CASES)


def _result(uid, rows, frames=False):
    s5 = np.arange(rows * 5, dtype=np.float32).reshape(rows, 5)
    return types.SimpleNamespace(
        uid=uid, strokes5=s5, length=rows - 1, steps=rows,
        endpoint="interpolate" if frames else "generate",
        frames=[s5[:1].copy(), s5[1:].copy()] if frames else None,
        ckpt_id=f"v{uid % 2}")


@pytest.mark.parametrize("bounds", [dict(max_entries=3),
                                    dict(max_entries=0, max_bytes=400)])
def test_result_cache_sequence_matches_jax(bounds):
    caches = (cache.ResultCache("cfg", "v0", **bounds),
              jcache.ResultCache("cfg", "v0", **bounds))
    fps = [bytes([i]) * 16 for i in range(7)]
    for c in caches:
        for i, fp in enumerate(fps[:4]):
            c.put(fp, _result(i, 3 + i, frames=i == 2))
        c.get(fps[1])
        c.get(fps[6])
        c.note_coalesced()
        c.put(fps[1], _result(9, 9))          # the first entry stays
        for i, fp in enumerate(fps[4:], start=4):
            c.put(fp, _result(i, 2))
        c.get(fps[4])
        c.get(fps[0])
    mine, ref = caches
    assert mine.keys() == ref.keys() and mine.stats() == ref.stats()
    assert len(mine) == len(ref) and mine.bytes == ref.bytes
    assert repr(mine) == repr(ref)
    for fp in mine.keys():
        a, b = mine.get(fp), ref.get(fp)
        assert (a.origin_uid, a.steps, a.nbytes, a.ckpt_id, a.endpoint) \
            == (b.origin_uid, b.steps, b.nbytes, b.ckpt_id, b.endpoint)
    for c in caches:
        c.clear()
    assert mine.stats() == ref.stats() and mine.keys() == []
    with pytest.raises(ValueError, match="bounds must be >= 0"):
        cache.ResultCache(max_entries=-1)


# -- the fleet's cache --------------------------------------------------------

N_CONTENTS = 6


def _contents(seed):
    """Six distinct contents over the four endpoints, caps 4..8."""
    rng = np.random.default_rng(seed)
    eps = ["generate", "complete", "reconstruct", "interpolate"]
    out = []
    for i in range(N_CONTENTS):
        ep = eps[i % 4]
        s = dict(endpoint=ep, temperature=0.8,
                 max_len=int(rng.integers(4, 9)))
        if ep == "generate":
            s["z"] = rng.standard_normal(6).astype(np.float32)
        elif ep == "interpolate":
            s.update(prefix=(_prefix(rng, 5), _prefix(rng, 3)), frames=3)
        else:
            s["prefix"] = _prefix(rng, int(rng.integers(2, 9)))
        out.append(s)
    return out


def _burst(seed, copies):
    """Each content ``copies`` times in a row (the same key), uids 0..;
    fresh JAX and port lists."""
    keys = [jax.random.fold_in(jax.random.key(seed), i)
            for i in range(N_CONTENTS)]
    jr, tr = [], []
    for i, s in enumerate(_contents(seed)):
        for _ in range(copies):
            uid = len(jr)
            jr.append(JRequest(key=keys[i], uid=uid, **s))
            tr.append(Request(key=np.asarray(jax.random.key_data(keys[i])),
                              uid=uid, **s))
    return jr, tr


def _serve_cached(cls, cache_cls, model, params, seed, **kw):
    """Two copies of each content before start, then one more after the
    drain; returns the fleet's results and summary."""
    fl = cls(model, model.hps, params, replicas=2, cache=cache_cls(),
             ckpt_id="ckpt_00000007", **kw)
    side = 0 if cls is JServeFleet else 1
    for r in _burst(seed, 2)[side]:
        fl.submit(r)
    with fl:
        assert fl.drain(timeout=120)
        for r in _burst(seed, 1)[side]:
            fl.submit(dataclasses.replace(r, uid=r.uid + 100))
        assert fl.drain(timeout=60)
        return fl.results, fl.summary()


@pytest.fixture(scope="module")
def jax_cached(setup):
    jm, jp, _, _ = setup
    return _serve_cached(JServeFleet, jcache.ResultCache, jm, jp, seed=21)


def test_fleet_cache_matches_jax_and_hits_are_bitwise(setup, jax_cached):
    _, _, m, p = setup
    jres, jsum = jax_cached
    res, summ = _serve_cached(ServeFleet, cache.ResultCache, m, p, seed=21,
                              devices=[CPU] * 2)
    assert sorted(res) == sorted(jres) and len(res) == 3 * N_CONTENTS
    for u, rec in res.items():
        a, b = rec["result"], jres[u]["result"]
        assert (a.steps, a.length, a.endpoint, a.cached, a.ended) == \
            (b.steps, b.length, b.endpoint, b.cached, b.ended)
        assert np.array_equal(a.strokes5[:, 2:], b.strokes5[:, 2:])
        assert float(np.max(np.abs(a.strokes5 - b.strokes5))) <= TOL
        assert a.ckpt_id == "ckpt_00000007"
    # the primaries computed; every repeat is their strokes, bitwise,
    # at zero steps
    for u in range(0, 2 * N_CONTENTS, 2):
        prim = res[u]["result"]
        assert not prim.cached and prim.attributed_steps > 0
        for twin in (u + 1, u // 2 + 100):
            hit = res[twin]["result"]
            assert hit.cached and hit.attributed_steps == 0
            assert res[twin]["origin_uid"] == u
            assert np.array_equal(hit.strokes5, prim.strokes5)
            assert (hit.frames is None) == (prim.frames is None)
            if prim.frames is not None:
                assert all(np.array_equal(x, y) for x, y
                           in zip(hit.frames, prim.frames))
    stats = summ["cache"]
    assert stats == jsum["cache"]
    # a coalesced repeat misses at the door, then waits: the misses that
    # computed are the distinct contents
    assert stats["misses"] - stats["coalesced"] == N_CONTENTS
    assert stats["coalesced"] == N_CONTENTS == stats["hits"]
    assert summ["completed_cached"] == jsum["completed_cached"] \
        == 2 * N_CONTENTS
    assert summ["cost"] == jsum["cost"] and summ["cost"]["exact"]


def _kill_first_burst(fl, replica):
    eng = fl._replicas[replica].engine
    real, calls = eng.run, []

    def run(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected burst failure")
        return real(*a, **k)

    eng.run = run


def test_failed_primary_fails_its_waiters_as_in_jax(setup):
    jm, jp, m, p = setup
    out = {}
    for cls, cache_cls, model, params, kw in (
            (JServeFleet, jcache.ResultCache, jm, jp, {}),
            (ServeFleet, cache.ResultCache, m, p,
             dict(devices=[CPU] * 2))):
        fl = cls(model, model.hps, params, replicas=2, cache=cache_cls(),
                 retry_budget=0, retry_backoff_s=0.0, **kw)
        _kill_first_burst(fl, 0)
        jr, tr = _burst(23, 2)
        for r in (jr if cls is JServeFleet else tr):
            fl.submit(r)
        with fl:
            assert fl.drain(timeout=120)
            out[cls] = ({u: f["reason"] for u, f in fl.failed.items()},
                        sorted(fl.results), fl.summary()["cache"])
    failed, done, stats = out[ServeFleet]
    assert out[JServeFleet] == out[ServeFleet]
    waiters = {u: r for u, r in failed.items() if r.startswith("coalesced")}
    assert waiters and all(r == f"coalesced onto failed request {u - 1}"
                           for u, r in waiters.items())
    assert len(failed) + len(done) == 2 * N_CONTENTS
