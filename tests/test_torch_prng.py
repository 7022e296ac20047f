"""The port's threefry2x32 PRNG is BITWISE ``jax.random``.

``sketch_rnn_tpu_torch/utils/prng.py`` reproduces key construction,
``fold_in``, ``split`` and ``uniform(key, (4,))`` in torch integer ops,
so one request key drives the same per-step uniforms in both packages
(the serving engine's determinism contract, ``u = uniform(fold_in(
request_key, t), (4,))``). The layout checked is the partitionable one
(``jax_threefry_partitionable=True``, the default of the JAX this repo
runs); the first test pins that assumption. ``gumbel`` and
``categorical`` are bitwise too: their log is XLA's CPU one, ported
(``prng.xla_log``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.ops.pallas_decode import make_uniforms as j_make_uniforms
from sketch_rnn_tpu_torch.ops.cuda_decode import make_uniforms
from sketch_rnn_tpu_torch.utils import prng

TS = np.arange(301)


def _words(jkey) -> np.ndarray:
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def test_partitionable_layout_and_key_data():
    assert jax.config.jax_threefry_partitionable
    for seed in (0, 1, 7, 12345, 2 ** 31 - 1, -1, -2 ** 31):
        np.testing.assert_array_equal(_words(jax.random.key(seed)),
                                      prng.key(seed).numpy())
    with pytest.raises(ValueError, match="int32"):
        prng.key(2 ** 31)


@pytest.mark.parametrize("seed", range(8))
def test_fold_in_and_uniform_bitwise(seed):
    """fold_in(key(seed), t) and uniform(., (4,)) for t in 0..300."""
    jk = jax.random.key(seed)
    jsteps = jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.asarray(TS))
    ju = jax.vmap(lambda k: jax.random.uniform(k, (4,)))(jsteps)
    tsteps = prng.fold_in(prng.key(seed), torch.from_numpy(TS))
    tu = prng.uniform(tsteps, (4,))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jsteps)).astype(np.int64),
        tsteps.numpy())
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ju).view(np.uint32),
                                  tu.numpy().view(np.uint32))


@pytest.mark.parametrize("num", [2, 3, 10])
def test_split_bitwise(num):
    for seed in range(8):
        np.testing.assert_array_equal(
            _words(jax.random.split(jax.random.key(seed), num)),
            prng.split(prng.key(seed), num).numpy())


def test_make_uniforms_matches_pallas_decode():
    """``cuda_decode.make_uniforms`` is bitwise
    ``pallas_decode.make_uniforms``: per-slot keys at per-slot step
    offsets, ``[K, B, 4]``."""
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.key(9), jnp.arange(5))
    t0 = np.asarray([0, 5, 11, 250, 299], np.int32)
    ju = j_make_uniforms(jkeys, jnp.asarray(t0), 8)
    tu = make_uniforms(torch.from_numpy(_words(jkeys)),
                       torch.from_numpy(t0), 8)
    assert tuple(tu.shape) == (8, 5, 4)
    np.testing.assert_array_equal(np.asarray(ju).view(np.uint32),
                                  tu.numpy().view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (0, 1000), (5, 70000)])
def test_randint_bitwise(lo, hi):
    """``randint(key, (), lo, hi, int32)``: how ``ops/rnn.py`` draws the
    fused kernels' dropout seed (lo=0, hi=int32 max), for 64 keys."""
    for seed in range(64):
        want = int(jax.random.randint(jax.random.key(seed), (), lo, hi,
                                      dtype=jnp.int32))
        got = prng.randint(prng.key(seed), lo, hi)
        assert got.dtype == torch.int32 and int(got) == want
    keys = jax.random.split(jax.random.key(5), 3)
    want = jax.vmap(lambda k: jax.random.randint(k, (), lo, hi,
                                                 dtype=jnp.int32))(keys)
    np.testing.assert_array_equal(
        np.asarray(want), prng.randint(prng.split(prng.key(5), 3), lo,
                                       hi).numpy())


def test_normal_matches_jax():
    """``normal(key, (B, Nz))`` (the VAE's z noise): its uniform is
    bitwise JAX's; XLA's float32 erf_inv is ported polynomial for
    polynomial, but XLA's CPU log1p rounds apart from torch's by an ulp,
    so values agree within 1e-6 (measured 4.8e-7 over 3 x 12800 draws)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    for seed in range(3):
        jk = jax.random.key(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, (100, 128), jnp.float32, lo,
                                          1.0)).view(np.uint32),
            prng.uniform(prng.key(seed), (100, 128), float(lo),
                         1.0).numpy().view(np.uint32))
        want = np.asarray(jax.random.normal(jk, (100, 128), jnp.float32))
        got = prng.normal(prng.key(seed), (100, 128))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_xla_log_bitwise():
    """``prng.xla_log`` is bitwise ``jnp.log`` on the CPU over 300000
    positive floats spread over every exponent (and the uniform range the
    Gumbel draws feed it); torch's own log rounds apart from XLA's on
    about one uniform in seven. Zero, subnormals, negatives, inf and NaN map
    as XLA maps them."""
    rng = np.random.default_rng(0)
    exps = rng.integers(1, 255, 300000).astype(np.uint32)
    x = ((exps << 23) | rng.integers(0, 1 << 23, 300000).astype(np.uint32)
         ).view(np.float32)
    u = np.asarray(prng.uniform(prng.key(0), (20000,)))
    x = np.concatenate([x, u])
    want = np.asarray(jnp.log(x))
    got = prng.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (torch.log(torch.from_numpy(u)).numpy()
            != want[-len(u):]).mean() > 0.1
    special = np.asarray([0.0, 1e-40, -1.0, np.inf, np.nan, 1.0],
                         np.float32)
    np.testing.assert_array_equal(
        prng.xla_log(torch.from_numpy(special)).numpy(),
        np.asarray(jnp.log(special)))


@pytest.mark.parametrize("seed", range(4))
def test_gumbel_bitwise(seed):
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), (64, 20)))
    got = prng.gumbel(prng.key(seed), (64, 20)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", range(6))
def test_categorical_matches_jax(seed):
    """``categorical(key, logits)`` at the sampler's shapes: the
    component draw over M=20 and the pen draw over 3, for B=64 rows of
    logits made with numpy (seed ``seed``) and divided by temperatures
    0.1, 0.5 and 1; also one key per leading row (the sampler's chunk of
    step keys). Indices equal on every case; no draw is a near-tie once
    the Gumbel noise is bitwise."""
    rng = np.random.default_rng(seed)
    for m in (20, 3):
        logits = rng.normal(size=(64, m)).astype(np.float32)
        for tau in (0.1, 0.5, 1.0):
            scaled = logits / np.float32(tau)
            want = np.asarray(jax.random.categorical(
                jax.random.key(seed), scaled))
            got = prng.categorical(prng.key(seed), torch.from_numpy(scaled))
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
    keys = jax.random.split(jax.random.key(seed), 4)
    logits = rng.normal(size=(4, 8, 20)).astype(np.float32)
    want = jax.vmap(jax.random.categorical)(keys, logits)
    got = prng.categorical(torch.from_numpy(_words(keys)),
                           torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="lead"):
        prng.categorical(prng.split(prng.key(0), 4), torch.zeros((3, 5)))
