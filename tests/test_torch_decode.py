"""The port's decode and replay kernels' plain versions vs the JAX package.

``sketch_rnn_tpu_torch.ops.cuda_decode.decode_chunk`` on CPU tensors runs
its plain PyTorch version; it is held against the JAX package's Pallas
``decode_chunk`` (interpret mode, the JAX package's own off-TPU path)
and its ``lax.scan`` chunk program, on the same JAX-made weights, request
keys, z and state. The rule, the JAX package's own conditional budget
(``tests/test_pallas_decode.py::COND_TOL``): step counts, done flags and
pen columns EXACTLY equal; offsets and the carry within 1e-5. Measured on
this suite's shapes: max gap 4.8e-7 (float32 summation order). The same
rule holds at ``compute_dtype=bfloat16`` (bfloat16 weights and product
operands, float32 sums on both sides): max gap 2.4e-7. A pen or
component flip is a discrete divergence; were one to show up the test
reports the row's CDF margin (a near-tie is rounding, a flip far from
any tie is a bug).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.serve.endpoints import make_encode_step as j_encode_step
from sketch_rnn_tpu.serve.engine import make_chunk_step as j_chunk_step
from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import cuda_decode
from sketch_rnn_tpu_torch.serve.endpoints import make_encode_step
from sketch_rnn_tpu_torch.serve.engine import make_chunk_step

TINY = dict(batch_size=4, max_seq_len=32, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, hyper_rnn_size=8,
            hyper_embed_size=4, serve_slots=4, serve_chunk=4)
CHUNK = 4
B = 4
TOL = 1e-5


def _setup(cell, conditional, num_classes=0, seed=0, **over):
    kw = dict(TINY, dec_model=cell, conditional=conditional,
              num_classes=num_classes, **over)
    jmodel = JSketchRNN(JHParams(**kw))
    jparams = jmodel.init_params(jax.random.key(seed))
    model = SketchRNN(HParams(**kw))
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    return jmodel, jparams, model, params


def _pool(hps, caps=None, seed=3):
    """Request pool made with numpy: key words, z, labels, temps, caps."""
    rng = np.random.default_rng(seed)
    keys = np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.key(seed), i))) for i in range(B)])
    z = (rng.normal(size=(B, hps.z_size)).astype(np.float32)
         if hps.conditional else None)
    labels = (np.arange(B) % hps.num_classes if hps.num_classes > 0
              else None)
    caps = np.full((B,), 8 * CHUNK) if caps is None else np.asarray(caps)
    temps = np.full((B,), 0.7, np.float32)
    return keys, z, labels, temps, caps.astype(np.int32)


def _jax_state(jmodel, jparams, pool):
    keys, z, labels, temps, caps = pool
    hps = jmodel.hps
    jpool = (jnp.asarray(keys), None if z is None else jnp.asarray(z),
             None if labels is None else jnp.asarray(labels, jnp.int32),
             jnp.asarray(temps), jnp.asarray(caps), None, None, None)
    z0 = jnp.zeros((B, hps.z_size)) if hps.conditional else None
    carry = jmodel.decoder_initial_carry(jparams, z0, B)
    prev = jnp.broadcast_to(jnp.asarray([0, 0, 1, 0, 0], jnp.float32),
                            (B, 5))
    return [carry, prev, jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool), jnp.ones((B,), bool),
            jnp.arange(B, dtype=jnp.int32), jpool]


def _port_state(model, params, pool):
    keys, z, labels, temps, caps = pool
    hps = model.hps
    tpool = (torch.from_numpy(keys.astype(np.int64)),
             None if z is None else torch.from_numpy(z),
             None if labels is None else torch.from_numpy(labels),
             torch.from_numpy(temps), torch.from_numpy(caps),
             None, None, None)
    z0 = torch.zeros((B, hps.z_size)) if hps.conditional else None
    carry = model.decoder_initial_carry(params, z0, B)
    prev = torch.tensor([0, 0, 1, 0, 0], dtype=torch.float32).expand(B, 5)
    return [carry, prev, torch.zeros((B,), dtype=torch.int32),
            torch.zeros((B,), dtype=torch.bool),
            torch.ones((B,), dtype=torch.bool), torch.arange(B), tpool]


def _margins(model, params, state):
    """Per-row CDF margins of the port's chunk (for failure reports)."""
    carry, prev, t, done, reset, slot_idx, pool = state
    keys, z, labels, temps, caps = (pool[0], pool[1], pool[2], pool[3],
                                    pool[4])
    extra = model._decoder_extra(params, z, labels)
    u = cuda_decode.make_uniforms(keys, t, CHUNK)
    out = cuda_decode.decode_chunk_reference(
        params["dec"], params["out_w"], params["out_b"], carry[0],
        carry[1], prev, extra, u, temps, t, done, caps,
        torch.tensor([0, 0, 0, 0, 1.0]), cell_kind=model.hps.dec_model,
        num_mixture=model.hps.num_mixture, return_margin=True)
    return out[-1].numpy()


def _compare(jout, tout, what, margins=None):
    (jc, jprev, jt, jd, js) = [np.asarray(x) if not isinstance(x, tuple)
                               else tuple(np.asarray(y) for y in x)
                               for x in jout]
    (tc, tprev, tt, td, ts) = [x.numpy() if isinstance(x, torch.Tensor)
                               else tuple(y.numpy() for y in x)
                               for x in tout]
    note = f"{what}; per-row CDF margins {margins}"
    np.testing.assert_array_equal(jt, tt, err_msg=note)
    np.testing.assert_array_equal(jd, td, err_msg=note)
    np.testing.assert_array_equal(js[..., 2:], ts[..., 2:], err_msg=note)
    assert np.max(np.abs(js - ts)) <= TOL, note
    for a, b in zip(jc, tc):
        assert np.max(np.abs(a - b)) <= TOL, note
    return max(float(np.max(np.abs(js - ts))),
               max(float(np.max(np.abs(a - b))) for a, b in zip(jc, tc)))


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
@pytest.mark.parametrize("conditional,ncls", [(False, 0), (True, 0),
                                              (True, 3)])
def test_decode_chunk_matches_pallas_and_scan(cell, conditional, ncls):
    """One chunk from admission: the port's chunk program (plain version
    of the CUDA kernel) against the JAX Pallas and scan programs."""
    jmodel, jparams, model, params = _setup(cell, conditional, ncls)
    pool = _pool(model.hps)
    jstate = _jax_state(jmodel, jparams, pool)
    tstate = _port_state(model, params, pool)
    tout = make_chunk_step(model, model.hps, CHUNK, params)(*tstate)
    margins = _margins(model, params, tstate)
    for kernel in ("pallas", "scan"):
        jout = jax.jit(j_chunk_step(jmodel, jmodel.hps, CHUNK, jparams,
                                    kernel=kernel))(*jstate)
        _compare(jout, tout, f"vs JAX {kernel}", margins)


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
def test_greedy_chunk_matches_pallas(cell):
    """``greedy=True``: argmax component and pen, offsets at the chosen
    component's means."""
    jmodel, jparams, model, params = _setup(cell, conditional=True)
    pool = _pool(model.hps)
    tout = make_chunk_step(model, model.hps, CHUNK, params, greedy=True)(
        *_port_state(model, params, pool))
    jout = jax.jit(j_chunk_step(jmodel, jmodel.hps, CHUNK, jparams,
                                greedy=True, kernel="pallas"))(
        *_jax_state(jmodel, jparams, pool))
    _compare(jout, tout, "greedy vs JAX pallas")


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
def test_masked_slot_schedule_across_chunks(cell):
    """Caps 2/3/9/16 over three consecutive chunks: slots capped
    mid-chunk freeze (END_TOKEN strokes, carry and t held) and stay
    frozen through the next chunk, in both packages alike."""
    jmodel, jparams, model, params = _setup(cell, conditional=False)
    pool = _pool(model.hps, caps=[2, 3, 9, 16])
    jstate = _jax_state(jmodel, jparams, pool)
    tstate = _port_state(model, params, pool)
    jfn = jax.jit(j_chunk_step(jmodel, jmodel.hps, CHUNK, jparams,
                               kernel="pallas"))
    tfn = make_chunk_step(model, model.hps, CHUNK, params)
    for step in range(3):
        jout = jfn(*jstate)
        tout = tfn(*tstate)
        _compare(jout, tout, f"chunk {step}")
        jstate = [*jout[:4], jnp.zeros((B,), bool), *jstate[5:]]
        tstate = [*tout[:4], torch.zeros((B,), dtype=torch.bool),
                  *tstate[5:]]
    t, done, strokes = (tout[2].numpy(), tout[3].numpy(),
                        tout[4].numpy())
    assert np.all(t <= np.minimum([2, 3, 9, 16], 12))
    np.testing.assert_array_equal(done, t < 12)
    np.testing.assert_array_equal(
        strokes[:, 0, :], np.broadcast_to([0, 0, 0, 0, 1.0], (CHUNK, 5)))


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
def test_replay_matches_pallas_encode(cell):
    """The encode step (bi-LSTM encoder + teacher-forced replay through
    the plain version of ``replay_chunk``) against JAX's Pallas encode
    step on ragged prefixes: mu and the replayed carry within 1e-5, the
    last prefix row exactly."""
    jmodel, jparams, model, params = _setup(cell, conditional=True)
    edge = 6
    rng = np.random.default_rng(0)
    strokes = rng.normal(0, 2, (B, edge + 1, 5)).astype(np.float32)
    strokes[..., 2:] = 0
    strokes[..., 2] = 1.0
    seq_len = np.asarray([6, 2, 4, 1], np.int32)
    jmu, jcarry, jprev = jax.jit(j_encode_step(
        jmodel, jmodel.hps, jparams, edge, kernel="pallas"))(
        jnp.asarray(strokes), jnp.asarray(seq_len), None)
    mu, carry, prev = make_encode_step(model, model.hps, params)(
        torch.from_numpy(strokes), torch.from_numpy(seq_len), None)
    assert np.max(np.abs(np.asarray(jmu) - mu.numpy())) <= TOL
    assert np.max(np.abs(np.asarray(jcarry) - carry.numpy())) <= TOL
    np.testing.assert_array_equal(np.asarray(jprev), prev.numpy())


# bfloat16 compute: both packages round each product's operands to
# bfloat16 and accumulate in float32, so only the order of the float32
# sums differs, as at float32. Measured at these shapes: largest
# stroke/carry/mu gap 2.4e-7 with steps, done flags and pens exact; held
# at the float32 budget TOL.


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
@pytest.mark.parametrize("conditional,ncls", [(False, 0), (True, 3)])
def test_bf16_decode_chunk_matches_pallas(cell, conditional, ncls):
    """At ``compute_dtype=bfloat16`` (the flagship preset's): the port's
    chunk program (bfloat16 weights, plain version of the kernel) against
    the JAX Pallas chunk program at the same compute dtype."""
    jmodel, jparams, model, params = _setup(cell, conditional, ncls,
                                            compute_dtype="bfloat16")
    pool = _pool(model.hps)
    tout = make_chunk_step(model, model.hps, CHUNK, params)(
        *_port_state(model, params, pool))
    jout = jax.jit(j_chunk_step(jmodel, jmodel.hps, CHUNK, jparams,
                                kernel="pallas"))(
        *_jax_state(jmodel, jparams, pool))
    gap = _compare(jout, tout, "bf16 vs JAX pallas")
    print(f"\nbf16 decode {cell} cond={conditional}: gap {gap}")


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
def test_bf16_replay_matches_pallas_encode(cell):
    """The encode step at ``compute_dtype=bfloat16``: mu and the carry
    replayed through the plain version of ``replay_chunk`` against JAX's
    Pallas encode step."""
    jmodel, jparams, model, params = _setup(cell, True,
                                            compute_dtype="bfloat16")
    edge = 6
    rng = np.random.default_rng(1)
    strokes = rng.normal(0, 2, (B, edge + 1, 5)).astype(np.float32)
    strokes[..., 2:] = 0
    strokes[..., 2] = 1.0
    seq_len = np.asarray([6, 2, 4, 1], np.int32)
    jmu, jcarry, _ = jax.jit(j_encode_step(
        jmodel, jmodel.hps, jparams, edge, kernel="pallas"))(
        jnp.asarray(strokes), jnp.asarray(seq_len), None)
    mu, carry, _ = make_encode_step(model, model.hps, params)(
        torch.from_numpy(strokes), torch.from_numpy(seq_len), None)
    gap = max(np.max(np.abs(np.asarray(jmu) - mu.numpy())),
              np.max(np.abs(np.asarray(jcarry) - carry.numpy())))
    print(f"\nbf16 replay {cell}: gap {gap}")
    assert gap <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The hyper cell and compute dtypes other than float32/bfloat16 are
    refused by name, bfloat16 compute is served, and a non-CPU, non-CUDA
    tensor is not silently served."""
    with pytest.raises(ValueError, match="hyper"):
        cuda_decode.check_cell_kind("hyper")
    _, _, model, params = _setup("lstm", conditional=False)
    c = torch.zeros((B, 16))
    args = (params["dec"], params["out_w"], params["out_b"], c, c,
            torch.zeros((B, 5)), None, torch.zeros((CHUNK, B, 4)),
            torch.ones((B,)), torch.zeros((B,), dtype=torch.int32),
            torch.zeros((B,), dtype=torch.bool),
            torch.ones((B,), dtype=torch.int32), torch.zeros((5,)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_decode.decode_chunk(*args, cell_kind="lstm", num_mixture=3,
                                 compute_dtype=torch.float16)
    bf = cuda_decode.decode_chunk(*args, cell_kind="lstm", num_mixture=3,
                                  compute_dtype=torch.bfloat16)
    assert bf[0].dtype == torch.float32 and bf[0].shape == (CHUNK, B, 5)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_chunk(*args[:3], c.to("meta"), *args[4:],
                                 cell_kind="lstm", num_mixture=3)
    before = cuda_decode.decode_chunk_launches
    cuda_decode.decode_chunk(*args, cell_kind="lstm", num_mixture=3)
    assert cuda_decode.decode_chunk_launches == before  # plain version
