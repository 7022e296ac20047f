"""The slice as a whole: the port's serving path against the JAX package.

``ServeEngine.run`` and ``serve_requests`` of the port (``device="cpu"``,
so the kernels' plain versions run) against the JAX package's
``ServeEngine(decode_kernel="pallas")`` (Pallas in interpret mode) on
the same JAX-made weights, request keys, z, temperatures and caps. 10
requests on 4 slots with caps of about 16 make the slots recycle. Per
request: ``steps`` and ``length`` equal, pen columns equal, offsets
within 1e-5 (measured here: 2.4e-7). The scheduling metrics, pure
functions of the step counts, are equal too.

A discrete flip (a pen or mixture draw that differs) would make a
request's strokes diverge; the failure message then reports the CDF
margins along the port's own draws, so a near-tie (rounding) is told
apart from a bug (a flip far from any tie).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.serve.endpoints import serve_requests as j_serve_requests
from sketch_rnn_tpu.serve.engine import Request as JRequest
from sketch_rnn_tpu.serve.engine import ServeEngine as JServeEngine
from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import cuda_decode
from sketch_rnn_tpu_torch.serve.endpoints import (DEFAULT_FRAMES,
                                                   pool_rows_of,
                                                   serve_requests,
                                                   validate_request)
from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine

TINY = dict(batch_size=4, max_seq_len=32, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, serve_slots=4,
            serve_chunk=4, decode_kernel="pallas")
TOL = 1e-5
N = 10
SAME_METRICS = ("completed", "decode_steps", "device_steps", "chunks",
                "dispatches", "dispatches_saved", "host_syncs",
                "steps_attributed", "steps_idle",
                "accepted_steps_per_device_step", "slot_utilization")


def _setup(dec_model):
    kw = dict(TINY, conditional=True, dec_model=dec_model)
    jm = JSketchRNN(JHParams(**kw))
    jp = jm.init_params(jax.random.key(5))
    return jm, jp, SketchRNN(HParams(**kw)), params_from_jax(
        jax.device_get(jp), device="cpu")


def _fields(n, seed=11):
    """Per-request keys, z, temperatures and caps, made with numpy."""
    rng = np.random.default_rng(seed)
    keys = [jax.random.fold_in(jax.random.key(seed), i) for i in range(n)]
    z = rng.normal(size=(n, TINY["z_size"])).astype(np.float32)
    temps = rng.uniform(0.5, 1.0, n).astype(np.float32)
    caps = rng.integers(12, 17, n)
    return keys, z, temps, caps


def _margins(model, params, hps, key_words, z, temp, steps):
    """The CDF margin of each of a generate request's draws along the
    port's own trajectory (one step at a time, plain version)."""
    zt = torch.from_numpy(z)[None]
    c, h = (x.contiguous() for x in model.decoder_initial_carry(
        params, zt, 1))
    prev = torch.tensor([[0, 0, 1.0, 0, 0]])
    keys = torch.from_numpy(key_words.astype(np.int64))[None]
    out = []
    for t in range(steps):
        tt = torch.tensor([t], dtype=torch.int32)
        strokes, c, h, _, _, m = cuda_decode.decode_chunk_reference(
            params["dec"], params["out_w"], params["out_b"], c, h, prev, zt,
            cuda_decode.make_uniforms(keys, tt, 1), torch.tensor([temp]),
            tt, torch.zeros(1, dtype=torch.bool),
            torch.tensor([hps.max_seq_len], dtype=torch.int32),
            torch.tensor([0, 0, 0, 0, 1.0]), cell_kind=hps.dec_model,
            num_mixture=hps.num_mixture, return_margin=True)
        prev = strokes[0]
        out.append(float(m[0]))
    return out


def _compare_results(jres, tres, why=lambda uid: ""):
    jby = {r.uid: r for r in jres}
    tby = {r.uid: r for r in tres}
    assert sorted(jby) == sorted(tby)
    worst = 0.0
    for uid, a in jby.items():
        b = tby[uid]
        sa, sb = np.asarray(a.strokes5), np.asarray(b.strokes5)
        same = (a.steps == b.steps and a.length == b.length
                and sa.shape == sb.shape
                and np.array_equal(sa[:, 2:], sb[:, 2:]))
        assert same, f"request {uid} diverged; {why(uid)}"
        err = float(np.max(np.abs(sa - sb)))
        assert err <= TOL, f"request {uid}: offsets err {err}"
        assert a.endpoint == b.endpoint
        assert a.attributed_steps == b.attributed_steps
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("dec_model", ["lstm", "layer_norm"])
def test_engine_run_matches_jax_pallas_engine(dec_model):
    jm, jp, m, p = _setup(dec_model)
    keys, z, temps, caps = _fields(N)
    jreqs = [JRequest(key=keys[i], z=z[i], temperature=float(temps[i]),
                      max_len=int(caps[i])) for i in range(N)]
    treqs = [Request(key=np.asarray(jax.random.key_data(keys[i])),
                     z=z[i], temperature=float(temps[i]),
                     max_len=int(caps[i])) for i in range(N)]
    jout = JServeEngine(jm, jm.hps, jp).run(jreqs)
    tout = ServeEngine(m, m.hps, p, device="cpu").run(treqs)

    def why(uid):
        margins = _margins(m, p, m.hps, treqs[uid].key, z[uid],
                           float(temps[uid]), int(caps[uid]))
        return f"port's CDF margins per step: {margins}"

    _compare_results(jout["results"], tout["results"], why)
    for k in SAME_METRICS:
        assert jout["metrics"][k] == tout["metrics"][k], k
    assert tout["metrics"]["completed"] == N   # 10 requests, 4 slots
    assert tout["metrics"]["decode_kernel"] == "cuda"


def _prefix(rng, n):
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.normal(size=(n, 2))
    p[:, 2] = rng.random(n) < 0.2
    return p


def test_serve_requests_endpoint_mix_matches_jax():
    """generate / complete / reconstruct through both packages'
    ``serve_requests``: the encode phase (bi-LSTM encoder + the replay
    kernel's plain version) and the decode of its planned state."""
    jm, jp, m, p = _setup("layer_norm")
    keys, z, temps, caps = _fields(N, seed=12)
    rng = np.random.default_rng(12)
    eps = ["generate", "complete", "reconstruct"]
    specs = []
    for i in range(N):
        ep = eps[i % 3]
        specs.append(dict(
            endpoint=ep, temperature=float(temps[i]), max_len=int(caps[i]),
            z=z[i] if ep == "generate" else None,
            prefix=None if ep == "generate"
            else _prefix(rng, int(rng.integers(2, 20)))))
    jreqs = [JRequest(key=keys[i], **specs[i]) for i in range(N)]
    treqs = [Request(key=np.asarray(jax.random.key_data(keys[i])),
                     **specs[i]) for i in range(N)]
    jout = j_serve_requests(jm, jm.hps, jp, jreqs)
    before = cuda_decode.replay_chunk_launches
    tout = serve_requests(m, m.hps, p, treqs, device="cpu")
    assert cuda_decode.replay_chunk_launches == before  # plain version
    _compare_results(jout["results"], tout["results"])
    for k in SAME_METRICS:
        assert jout["metrics"][k] == tout["metrics"][k], k
    # the planner stamped the same derived state (encode phase parity)
    for a, b in zip(jreqs, treqs):
        if a.endpoint == "generate":
            continue
        np.testing.assert_allclose(np.asarray(a.z), b.z, rtol=0, atol=TOL)
        if a.endpoint == "complete":
            np.testing.assert_allclose(np.asarray(a.init_carry),
                                       b.init_carry, rtol=0, atol=TOL)
            np.testing.assert_array_equal(np.asarray(a.init_prev),
                                          b.init_prev)


def test_interpolate_endpoint_matches_jax():
    """The ``interpolate`` endpoint through both packages'
    ``serve_requests``, beside generate and complete requests: the same
    request-level results (one per parent), each frame's strokes (pens
    and steps exact, offsets within 1e-5), and the cost identity: a
    parent's ``attributed_steps`` is the integer sum of its frames', and
    attributed + idle steps equal the dispatched steps."""
    jm, jp, m, p = _setup("layer_norm")
    keys, z, temps, caps = _fields(4, seed=13)
    rng = np.random.default_rng(13)
    specs = [
        dict(endpoint="interpolate", prefix=(_prefix(rng, 9),
                                             _prefix(rng, 14)),
             frames=5, temperature=float(temps[0]), max_len=int(caps[0])),
        dict(endpoint="generate", z=z[1], temperature=float(temps[1]),
             max_len=int(caps[1])),
        dict(endpoint="interpolate", prefix=(_prefix(rng, 3),
                                             _prefix(rng, 20)),
             temperature=float(temps[2]), max_len=int(caps[2])),
        dict(endpoint="complete", prefix=_prefix(rng, 6),
             temperature=float(temps[3]), max_len=int(caps[3]))]
    jreqs = [JRequest(key=keys[i], **specs[i]) for i in range(4)]
    treqs = [Request(key=np.asarray(jax.random.key_data(keys[i])),
                     **specs[i]) for i in range(4)]
    jout = j_serve_requests(jm, jm.hps, jp, jreqs)
    tout = serve_requests(m, m.hps, p, treqs, device="cpu")
    _compare_results(jout["results"], tout["results"])
    for k in SAME_METRICS:
        assert jout["metrics"][k] == tout["metrics"][k], k
    tby = {r.uid: r for r in tout["results"]}
    jby = {r.uid: r for r in jout["results"]}
    for uid, frames in ((0, 5), (2, DEFAULT_FRAMES)):
        a, b = jby[uid], tby[uid]
        assert b.endpoint == "interpolate" and len(b.frames) == frames
        for fa, fb in zip(a.frames, b.frames):
            assert fa.shape == fb.shape
            np.testing.assert_array_equal(fa[:, 2:], fb[:, 2:])
            np.testing.assert_allclose(fa, fb, rtol=0, atol=TOL)
        np.testing.assert_array_equal(b.strokes5, np.concatenate(b.frames))
        assert b.steps == sum(len(f) for f in b.frames)
    # 2 + 2 * 5 + 10 engine rows; one result per request
    assert tout["metrics"]["completed"] == 2 + 5 + DEFAULT_FRAMES
    assert sorted(tby) == [0, 1, 2, 3]
    m_t = tout["metrics"]
    assert sum(r.attributed_steps for r in tby.values()) \
        == m_t["steps_attributed"]
    assert m_t["steps_attributed"] + m_t["steps_idle"] \
        == m_t["device_steps"]


def test_interpolate_is_refused_by_name():
    """Malformed interpolations are refused, each with a message naming
    what is wrong: not exactly two prefixes, fewer than two frames, an
    unconditional checkpoint, and a bare ``engine.run`` of an unplanned
    request."""
    _, _, m, p = _setup("lstm")
    pair = (np.zeros((3, 3)), np.zeros((3, 3)))
    bad = [(dict(prefix=pair[:1]), "exactly two"),
           (dict(prefix=np.zeros((2, 3, 3))), "exactly two"),
           (dict(prefix=pair, frames=1), "frames >= 2")]
    for kw, why in bad:
        req = Request(key=np.zeros(2, np.uint32), endpoint="interpolate",
                      **kw)
        with pytest.raises(ValueError, match=why):
            serve_requests(m, m.hps, p, [req], device="cpu")
    req = Request(key=np.zeros(2, np.uint32), endpoint="interpolate",
                  prefix=pair)
    assert pool_rows_of(req) == DEFAULT_FRAMES
    assert pool_rows_of(dataclasses.replace(req, frames=4)) == 4
    with pytest.raises(ValueError, match="plan_batch"):
        ServeEngine(m, m.hps, p, device="cpu").run([req])
    uncond = HParams(**dict(TINY, conditional=False, dec_model="lstm"))
    with pytest.raises(ValueError, match="hps.conditional"):
        validate_request(req, uncond)
