"""The sampling slice: the port's ``sample`` package against the JAX one.

- ``sample_from_mixture`` at temperatures 0.1, 0.5, 1 and greedy, on
  mixture parameters made with numpy: the component choices (the
  categorical draw of ``split(key, 3)[0]``) and the pens equal, offsets
  within 1e-5.
- The batched sampler (``make_sampler``) of the ``lstm``,
  ``layer_norm`` and ``hyper`` decoders, class-conditional, with explicit
  ``z`` and per-row ``max_steps``, on weights carried over with
  ``convert.py``: lengths and pens equal, offsets within 1e-5. The
  Gumbel noise is bitwise JAX's, so a pen or component choice can differ
  only where two logits are within float32 rounding of each other.
- The chunked done check gives the tensors of a step-by-step exit, and
  waits for the device at most ``ceil(steps / check_every)`` times.
- ``slerp`` / ``lerp`` / ``interpolate_latents`` / ``encode_mu``: latents
  within 1e-6. The SVG writers: byte for byte.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.ops import mdn as jmdn
from sketch_rnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from sketch_rnn_tpu.sample import interpolate as jinterp
from sketch_rnn_tpu.sample import sampler as jsampler
from sketch_rnn_tpu.sample import svg as jsvg
from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import mdn
from sketch_rnn_tpu_torch.parallel.mesh import make_mesh
from sketch_rnn_tpu_torch.sample import interpolate, sampler, svg
from sketch_rnn_tpu_torch.utils import prng

TINY = dict(batch_size=4, max_seq_len=32, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, hyper_rnn_size=8,
            hyper_embed_size=4)
TOL = 1e-5
LATENT_TOL = 1e-6
B = 8


def _words(jkey) -> np.ndarray:
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("tau,greedy", [(0.1, False), (0.5, False),
                                        (1.0, False), (1.0, True)])
def test_sample_from_mixture_matches_jax(tau, greedy):
    m = 20
    raw = np.random.default_rng(int(tau * 10)).normal(
        size=(64, 6 * m + 3)).astype(np.float32)
    jmp = jmdn.get_mixture_params(jnp.asarray(raw), m)
    tmp = mdn.get_mixture_params(torch.from_numpy(raw), m)
    for seed in range(2):
        jk = jax.random.key(seed)
        want = np.asarray(jsampler.sample_from_mixture(
            jmp, jk, jnp.float32(tau), greedy=greedy))
        got = sampler.sample_from_mixture(
            tmp, prng.key(seed), tau, greedy=greedy).numpy()
        np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        if greedy:
            continue
        # the component choices behind the offsets
        kc = jax.random.split(jk, 3)[0]
        np.testing.assert_array_equal(
            prng.categorical(prng.split(prng.key(seed), 3)[0],
                             tmp.log_pi / tau).numpy(),
            np.asarray(jax.random.categorical(kc, jmp.log_pi / tau)))


@functools.lru_cache(maxsize=None)
def _models(dec_model, conditional=True, num_classes=3):
    """Both packages' models on one set of JAX-made weights, built once
    per configuration so the samplers each model caches are reused."""
    kw = dict(TINY, conditional=conditional, dec_model=dec_model,
              num_classes=num_classes)
    jm = JSketchRNN(JHParams(**kw))
    jp = jm.init_params(jax.random.key(1))
    # a weak end-of-sketch bias so sketches run to their caps or end late
    jp["out_b"] = jp["out_b"].at[2].set(-2.5)
    tm = SketchRNN(HParams(**kw))
    return jm, jp, tm, params_from_jax(jax.device_get(jp), device="cpu")


def _inputs(hps, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(B, hps.z_size)).astype(np.float32)
         if hps.conditional else None)
    labels = (rng.integers(0, hps.num_classes, B).astype(np.int32)
              if hps.num_classes > 0 else None)
    caps = rng.integers(6, hps.max_seq_len + 8, B).astype(np.int32)
    return z, labels, caps


def _jax_sample(jm, jp, key, z, labels, tau, caps, greedy=False):
    fn = jsampler.make_sampler(jm, jm.hps, greedy=greedy)
    s5, lens = fn(jp, key, B, None if z is None else jnp.asarray(z),
                  None if labels is None else jnp.asarray(labels),
                  jnp.float32(tau), jnp.asarray(caps))
    return np.asarray(s5), np.asarray(lens)


@pytest.mark.parametrize("dec_model,conditional,greedy", [
    ("lstm", True, False), ("layer_norm", True, False),
    ("hyper", True, False), ("lstm", False, True)])
def test_sampler_matches_jax(dec_model, conditional, greedy):
    jm, jp, tm, tp = _models(dec_model, conditional)
    z, labels, caps = _inputs(tm.hps)
    jk = jax.random.key(3)
    want_s, want_l = _jax_sample(jm, jp, jk, z, labels, 0.7, caps, greedy)
    fn = sampler.make_sampler(tm, tm.hps, greedy=greedy, device="cpu")
    got_s, got_l = fn(tp, _words(jk), B, z, labels, 0.7, caps)
    assert got_s.shape == (B, tm.hps.max_seq_len, 5)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(got_s.numpy()[..., 2:], want_s[..., 2:])
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=TOL)
    # the caps and the end-of-sketch state both ended rows here
    assert (want_l == np.minimum(caps, tm.hps.max_seq_len)).any()
    assert (want_l < np.minimum(caps, tm.hps.max_seq_len)).any() or greedy


@pytest.mark.parametrize("check_every", [1, 3, sampler.DONE_CHECK_EVERY, 64])
def test_chunked_done_check_equals_step_by_step_exit(check_every):
    """Any ``check_every`` gives the tensors of the step-by-step exit
    (``check_every=1``, the JAX loop's exit), with at most
    ``ceil(steps / check_every)`` reads of ``done``."""
    _, _, tm, tp = _models("layer_norm")
    z, labels, caps = _inputs(tm.hps, seed=5)
    key = prng.key(9)
    ref = sampler._build_sampler(tm, tm.hps, device="cpu", check_every=1)
    want_s, want_l = ref(tp, key, B, z, labels, 0.8, caps)
    fn = sampler._build_sampler(tm, tm.hps, device="cpu",
                                check_every=check_every)
    got_s, got_l = fn(tp, key, B, z, labels, 0.8, caps)
    assert torch.equal(got_s, want_s) and torch.equal(got_l, want_l)
    last = int(want_l.max())       # the step the last row finished
    assert ref.stats["steps"] == min(last + 1, tm.hps.max_seq_len) or \
        ref.stats["steps"] == tm.hps.max_seq_len
    steps = fn.stats["steps"]
    assert steps >= ref.stats["steps"]
    assert fn.stats["host_syncs"] <= math.ceil(steps / check_every)


def test_sample_matches_jax_and_scales():
    """``sample`` with an explicit ``z``: stroke-3 output scaled by
    ``scale_factor`` and lengths equal to the JAX package's."""
    jm, jp, tm, tp = _models("lstm")
    z, labels, _ = _inputs(tm.hps, seed=2)
    want, want_l = jsampler.sample(jm, jp, jm.hps, jax.random.key(6), n=B,
                                   temperature=0.6, z=jnp.asarray(z),
                                   labels=jnp.asarray(labels),
                                   scale_factor=3.5)
    got, got_l = sampler.sample(tm, tp, tm.hps, _words(jax.random.key(6)),
                                n=B, temperature=0.6, z=z, labels=labels,
                                scale_factor=3.5, device="cpu")
    np.testing.assert_array_equal(got_l, want_l)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 2], b[:, 2])
        np.testing.assert_allclose(a, b, rtol=0, atol=3.5 * TOL)
    # the prior draw (no z): prng.normal is within 1e-6 of JAX's
    got_prior, _ = sampler.sample(tm, tp, tm.hps, prng.key(6), n=B,
                                  labels=labels, device="cpu")
    assert len(got_prior) == B


def test_sampler_refuses_a_mesh_naming_its_item():
    """A mesh of more ranks than the process group holds (none here) is
    refused, naming what it needs; a mesh of one rank is the JAX
    package's one-device mesh: the sampler at ``fold_in(key, 0)``, equal
    to JAX's sharded sampler on one device (the N-rank sampler is in
    ``tests/test_torch_dp.py``)."""
    jm, jp, tm, tp = _models("lstm")
    with pytest.raises(RuntimeError, match="initialize"):
        sampler.make_sampler(tm, tm.hps, mesh=make_mesh(tm.hps, world=2),
                             device="cpu")
    z, labels, caps = _inputs(tm.hps)
    jk = jax.random.key(3)
    fn = jsampler.make_sampler(
        jm, jm.hps, mesh=jmake_mesh(jm.hps, devices=jax.devices()[:1]))
    want_s, want_l = (np.asarray(a) for a in fn(
        jp, jk, B, jnp.asarray(z), jnp.asarray(labels), jnp.float32(0.7),
        jnp.asarray(caps)))
    got_s, got_l = sampler.make_sampler(
        tm, tm.hps, mesh=make_mesh(tm.hps), device="cpu")(
        tp, _words(jk), B, z, labels, 0.7, caps)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(got_s.numpy()[..., 2:], want_s[..., 2:])
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["slerp", "lerp"])
def test_latents_match_jax(mode):
    rng = np.random.default_rng(0)
    for n in (2, 7, 10):
        z0, z1 = rng.normal(size=(2, 128)).astype(np.float32)
        want = np.asarray(jinterp.interpolate_latents(z0, z1, n=n,
                                                      mode=mode))
        got = interpolate.interpolate_latents(torch.from_numpy(z0), z1,
                                              n=n, mode=mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LATENT_TOL)
        t = np.float32(0.3)
        f, jf = ((interpolate.slerp, jinterp.slerp) if mode == "slerp"
                 else (interpolate.lerp, jinterp.lerp))
        np.testing.assert_allclose(
            f(torch.from_numpy(z0), torch.from_numpy(z1), torch.tensor(t))
            .numpy(), np.asarray(jf(z0, z1, t)), rtol=0, atol=LATENT_TOL)
    # (anti)parallel ends: slerp falls back to lerp, as in JAX
    np.testing.assert_allclose(
        interpolate.slerp(torch.from_numpy(z0), 2 * torch.from_numpy(z0),
                          torch.tensor(0.5)).numpy(),
        np.asarray(jinterp.slerp(z0, 2 * z0, 0.5)), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="slerp"):
        interpolate.interpolate_latents(z0, z1, mode="cubic")


def test_encode_mu_matches_jax():
    jm, jp, tm, tp = _models("layer_norm")
    rng = np.random.default_rng(4)
    lens = rng.integers(3, 32, 4).astype(np.int32)
    strokes = np.zeros((4, 33, 5), np.float32)
    for i, n in enumerate(lens):
        strokes[i, 1:n + 1, :2] = rng.normal(size=(n, 2))
        strokes[i, 1:n + 1, 2] = 1.0
        strokes[i, n + 1:, 4] = 1.0
    strokes[:, 0, 2] = 1.0
    batch = {"strokes": strokes, "seq_len": lens}
    want = np.asarray(jinterp.encode_mu(jm, jp, batch))
    got = interpolate.encode_mu(tm, tp, batch, device="cpu")
    assert tuple(got.shape) == (4, tm.hps.z_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LATENT_TOL)


def _sketch(rng, n, lift=0.2):
    s = np.zeros((n, 3), np.float32)
    s[:, :2] = rng.normal(scale=20.0, size=(n, 2))
    s[:, 2] = rng.random(n) < lift
    return s


def test_svg_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    sketches = [_sketch(rng, int(n)) for n in rng.integers(1, 40, 7)]
    sketches.insert(3, np.zeros((0, 3), np.float32))     # an empty cell
    for s in sketches[:3]:
        for kw in ({}, dict(factor=0.5, padding=3.0, stroke_width=2.0,
                            color="red")):
            assert svg.strokes_to_svg(s, **kw) == \
                jsvg.strokes_to_svg(s, **kw)
    assert svg.strokes_to_svg(sketches[3]) == \
        jsvg.strokes_to_svg(sketches[3])
    for cols in (1, 3, 5, 20):
        got = svg.svg_grid(sketches, cols=cols,
                           path=str(tmp_path / "port" / "g.svg"))
        want = jsvg.svg_grid(sketches, cols=cols,
                             path=str(tmp_path / "jax" / "g.svg"))
        assert got == want
        assert (tmp_path / "port" / "g.svg").read_bytes() == \
            (tmp_path / "jax" / "g.svg").read_bytes()
