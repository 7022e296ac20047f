"""Data parallelism in the port against the JAX package, on the CPU.

N ranks of ``tests/_torch_dp_worker.py`` (N = 2 and 4, one gloo group
each on ``127.0.0.1``; the worker imports only the port) run the jobs of
``_torch_dp_worker.JOBS`` on weights the JAX package made and
``convert.py`` carried over, and on global batches made with numpy; the
JAX package runs the same jobs in this process on an N-device mesh of
the tests' virtual CPU devices (``make_mesh(hps, devices=
jax.devices()[:N])``) over the same global batch. Each rank takes its
rows of the global batch (``shard_batch``), folds its keys with its data
index and sums every loss and the gradients over its data group, as the
JAX package's ``shard_map`` does; the eval sweeps run on loaders striped
by rank (``host_id``/``num_hosts``), which the JAX side sees as the
global batches of N hosts (rows concatenated in host order). Both
spawns start before the JAX side computes, so they run meanwhile.

The JAX package's mesh gradient is the data axis's size times the
gradient of its own one-device path (``jax`` 0.9: the autodiff of
``shard_map`` already sums the replicated parameters' gradient, and its
step sums it again). The port's is the gradient of the global loss, so
the checks hold the port's gradients and ``grad_norm`` to JAX's divided
by that size (exact for sizes that are powers of 2), and its parameters
after three steps to JAX's step with ``optax.scale(1 / size)`` ahead of
its optimizer; ``test_gradient_is_the_one_device_gradient`` holds the
port's N-rank gradient to JAX's one-device gradient of the global batch
directly, on a model without randomness.

Tolerances are ``tests/test_torch_train.py``'s: loss and metrics at
float32 ``rtol=1e-5, atol=1e-6``, gradients the same, at bfloat16
``rtol=1e-3, atol=1e-4``; parameters after three steps ``atol=2e-5``.
One more, for bfloat16 gradients on a mesh: each rank's gradient of a
weight reaches float32 through the weight's bfloat16 cast, so the sum
over ranks adds bfloat16-rounded partials (in both packages), and a
partial whose float32 sum lands on the other side of a rounding boundary
moves the total by one bfloat16 ulp of that partial: those gradients are
held to one ulp, ``rtol=2**-7``, with ``atol=1e-4`` (measured: one
element of 1024 in ``dec/wh``, 1.22e-4 on 0.0177). Replicated
parameters are bit for bit equal across ranks.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.data import prefetch as jprefetch
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from sketch_rnn_tpu.parallel.mesh import shard_batch as jshard
from sketch_rnn_tpu.sample import sampler as jsampler
from sketch_rnn_tpu.train import loop as jloop
from sketch_rnn_tpu.train import state as jstate
from sketch_rnn_tpu.train import step as jstep
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.data import loader as tloader
from sketch_rnn_tpu_torch.data import prefetch as tprefetch
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.parallel import mesh as tmesh
from sketch_rnn_tpu_torch.train import loop as tloop
from sketch_rnn_tpu_torch.train import step as tstep
from sketch_rnn_tpu_torch.train.state import tree_items
from tests import _torch_dp_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
BF_RTOL, BF_ATOL = 1e-3, 1e-4
BF_GRAD_RTOL = 2.0 ** -7       # one bfloat16 ulp (module docstring)
PARAM_ATOL = 2e-5
WORKER_TIMEOUT_S = 300


def _tol(cfg):
    return ((BF_RTOL, BF_ATOL) if W.CONFIGS[cfg].get("compute_dtype")
            == "bfloat16" else (RTOL, ATOL))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _jax_params(cfg):
    jh = JHParams(**W.CONFIGS[cfg])
    return jax.jit(JSketchRNN(jh).init_params)(jax.random.key(1))


def _flat_jax(tree):
    """A JAX params tree by the port's paths (``convert.py``)."""
    return {"/".join(p): v.detach().float().numpy()
            for p, v in tree_items(params_from_jax(jax.device_get(tree),
                                                   device="cpu"))}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """``in.npz`` for every world, and the same values for the JAX side:
    the JAX weights of each config, four global batches, the sampler's
    ``z``, labels and caps."""
    d = tmp_path_factory.mktemp("dp")
    params = {cfg: _jax_params(cfg) for cfg in W.CONFIGS}
    loader, _ = jloader.synthetic_loader(JHParams(**W.TINY), num=32, seed=0)
    batches = [loader.random_batch() for _ in range(4)]
    rng = np.random.default_rng(0)
    b = W.TINY["batch_size"]
    sample = {"z": rng.normal(size=(b, W.TINY["z_size"])).astype(np.float32),
              "labels": rng.integers(0, 3, b).astype(np.int32),
              "caps": rng.integers(4, W.TINY["max_seq_len"] + 4,
                                   b).astype(np.int32)}
    flat = {f"params/{cfg}/{k}": v for cfg, p in params.items()
            for k, v in _flat_jax(p).items()}
    flat.update({f"batch/{i}/{k}": v for i, bt in enumerate(batches)
                 for k, v in bt.items()})
    flat.update({f"sample/{k}": v for k, v in sample.items()})
    np.savez(d / "in.npz", **flat)
    return d, params, batches, sample


@pytest.fixture(scope="module")
def spawned(inputs):
    """Both worlds' ranks, started together; their outputs are read by
    :func:`outs` once the JAX side has computed."""
    d = inputs[0]
    procs = {}
    for world in W.JOBS:
        port = _free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_torch_dp_worker.py"),
             str(r), str(world), str(port), str(d)],
            env=_clean_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    yield procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def outs(spawned, inputs):
    """``{world: [rank 0's outputs, rank 1's, ...]}``."""
    d = inputs[0]
    got = {}
    for world, ps in spawned.items():
        for r, p in enumerate(ps):
            log, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"world {world} rank {r}:\n{log}"
        got[world] = [dict(np.load(d / f"out_{world}_{r}.npz"))
                      for r in range(world)]
    return got


def _job(name):
    for world, jobs in W.JOBS.items():
        for job in jobs:
            if job[0] == name:
                return world, job
    raise KeyError(name)


def _jhps(cfg, mesh):
    shape, axes = mesh
    return JHParams(**W.CONFIGS[cfg], mesh_shape=shape, mesh_axes=axes)


def _section(out, job, what):
    pre = f"{job}/{what}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _capture_grads():
    """An optax transformation that applies no update and keeps the
    gradients it was given as its state: JAX's own step core then hands
    back its gradients exactly."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


class _GlobalBatches:
    """N JAX stripes seen as the JAX mesh sees N hosts' feeds: global eval
    batch ``i`` is the stripes' batches ``i`` concatenated in host
    order."""

    def __init__(self, stripes, hps):
        self.stripes, self.hps = stripes, hps

    def __len__(self):
        return sum(len(s) for s in self.stripes)

    @property
    def num_eval_batches(self):
        return self.stripes[0].num_eval_batches

    def eval_pad_len(self, i):
        return self.hps.max_seq_len

    def get_batch(self, i):
        parts = [s.get_batch(i) for s in self.stripes]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def jax_runs(inputs, spawned):
    """The JAX package's result of every job, computed while the ranks
    run: ``{job: {what: ...}}``."""
    _, params, batches, sample = inputs
    res = {}
    for world, jobs in W.JOBS.items():
        for name, cfg, mesh_spec, what in jobs:
            jh = _jhps(cfg, mesh_spec)
            jm = JSketchRNN(jh)
            mesh = jmake_mesh(jh, devices=jax.devices()[:world])
            n = mesh.shape["data"]
            jp = params[cfg]
            key = jax.random.key(W.STEP_KEY)
            r = res[name] = {"data": n}
            if "step" in what:
                tx = _capture_grads()
                core = jax.jit(jstep._make_single_step_core(jm, jh, mesh,
                                                            tx))
                st = jstate.TrainState(_copy(jp), tx.init(jp),
                                       jnp.zeros((), jnp.int32))
                new, met = core(st, jshard(batches[0], mesh), key)
                r["grads"] = _flat_jax(new.opt_state)
                r["step_metrics"] = {k: float(v) for k, v in met.items()}
            if "multi" in what:
                base = jstep.make_optimizer
                with pytest.MonkeyPatch.context() as mp:
                    # the port's gradient is JAX's over n (module docstring)
                    mp.setattr(jstep, "make_optimizer", lambda h: optax.chain(
                        optax.scale(1.0 / n), base(h)))
                    fn = jstep.make_multi_train_step(jm, jh, mesh)
                tx = optax.chain(optax.scale(1.0 / n), base(jh))
                st = jstate.TrainState(_copy(jp), tx.init(jp),
                                       jnp.zeros((), jnp.int32))
                stack = {k: np.stack([b[k] for b in batches[1:4]])
                         for k in batches[1]}
                new, met = fn(st, jshard(stack, mesh, stacked=True), key)
                r["multi_params"] = _flat_jax(new.params)
                r["multi_metrics"] = {k: float(v) for k, v in met.items()}
            if "eval" in what or "per_class" in what:
                lh = jh.replace(batch_size=jh.batch_size // n)
                glob = _GlobalBatches([jloader.synthetic_loader(
                    lh, W.EVAL_NUM, seed=W.EVAL_SEED, host_id=h,
                    num_hosts=n)[0] for h in range(n)], jh)
                r["eval_batches"] = glob.num_eval_batches
                ekey = jax.random.key(W.EVAL_KEY)
            if "eval" in what:
                r["eval"] = jloop.evaluate(
                    jp, glob, jstep.make_eval_step(jm, jh, mesh), mesh,
                    key=ekey)
            if "per_class" in what:
                r["per_class"] = jloop.evaluate_per_class(
                    jp, glob, jstep.make_per_class_eval_step(jm, jh, mesh),
                    jh.num_classes, mesh, key=ekey)
            if "sample" in what:
                fn = jsampler.make_sampler(jm, jh, mesh=mesh)
                s5, lens = fn(jp, jax.random.key(W.SAMPLE_KEY),
                              jh.batch_size, jnp.asarray(sample["z"]),
                              jnp.asarray(sample["labels"]),
                              jnp.float32(W.SAMPLE_TAU),
                              jnp.asarray(sample["caps"]))
                r["sample"] = (np.asarray(s5), np.asarray(lens))
    return res


STEP_JOBS = [j[0] for jobs in W.JOBS.values() for j in jobs
             if "step" in j[3]]
MULTI_JOBS = [j[0] for jobs in W.JOBS.values() for j in jobs
              if "multi" in j[3]]


def _close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=tol[0], atol=tol[1],
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("job", STEP_JOBS)
def test_step_loss_and_metrics_match_jax(jax_runs, outs, job):
    """One step's loss, its terms and the schedules, on every rank, the
    global batch's as JAX's; ``grad_norm`` JAX's over the data size."""
    world, (name, cfg, _, _) = _job(job)
    want = dict(jax_runs[job]["step_metrics"])
    want["grad_norm"] /= jax_runs[job]["data"]
    for out in outs[world]:
        _close(_section(out, name, "step_metrics"), want, _tol(cfg),
               f"{job} metrics")


@pytest.mark.parametrize("job", STEP_JOBS)
def test_step_gradients_match_jax(jax_runs, outs, job):
    """The gradients summed over the data group: JAX's over the data
    size, on every rank."""
    world, (name, cfg, _, _) = _job(job)
    n = jax_runs[job]["data"]
    want = {k: v / n for k, v in jax_runs[job]["grads"].items()}
    tol = _tol(cfg)
    if tol == (BF_RTOL, BF_ATOL):
        tol = (BF_GRAD_RTOL, BF_ATOL)
    for out in outs[world]:
        _close(_section(out, name, "grads"), want, tol, f"{job} grads")


@pytest.mark.parametrize("job", sorted(set(STEP_JOBS + MULTI_JOBS)))
def test_replicated_params_equal_across_ranks(outs, job):
    """Every rank ends a step, a K=3 call and ``train()`` on the same
    parameters, bit for bit (the all-reduce gives every rank the same
    sum)."""
    world, (name, _, _, what) = _job(job)
    for sec in ("step_params", "multi_params", "singles_params", "grads",
                "train_params", "striped_params"):
        ranks = [_section(out, name, sec) for out in outs[world]]
        if not ranks[0]:
            continue
        for other in ranks[1:]:
            assert sorted(other) == sorted(ranks[0])
            for k in ranks[0]:
                np.testing.assert_array_equal(other[k], ranks[0][k],
                                              err_msg=f"{job} {sec} {k}")


@pytest.mark.parametrize("job", MULTI_JOBS)
def test_k3_call_matches_jax_multi_step(jax_runs, outs, job):
    """A K=3 call (three micro-steps, dropout on, on each rank's rows of
    three global batches) ends on JAX's ``make_multi_train_step(mesh)``
    parameters; its window metrics are JAX's."""
    world, (name, cfg, _, _) = _job(job)
    n = jax_runs[job]["data"]
    want = dict(jax_runs[job]["multi_metrics"])
    for k in ("grad_norm", "grad_norm_max"):
        want[k] /= n
    for out in outs[world]:
        _close(_section(out, name, "multi_params"),
               jax_runs[job]["multi_params"], (0.0, PARAM_ATOL),
               f"{job} params")
        _close(_section(out, name, "multi_metrics"), want, _tol(cfg),
               f"{job} metrics")


@pytest.mark.parametrize("job", MULTI_JOBS)
def test_k3_call_is_its_single_steps(outs, job):
    """The K=3 call is bit for bit three single steps with keys
    ``fold_in(key, i)`` on every rank."""
    world, (name, _, _, _) = _job(job)
    for out in outs[world]:
        a = _section(out, name, "multi_params")
        b = _section(out, name, "singles_params")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


TRAIN_JOBS = [j[0] for jobs in W.JOBS.values() for j in jobs
              if "train" in j[3]]


@pytest.mark.parametrize("job", TRAIN_JOBS)
def test_train_feeds_each_rank_its_rows(outs, job):
    """``train()`` on the mesh (its default) over an unstriped loader: each
    rank takes its rows of the global batch in the feed, and the run is
    bit for bit hand-driven mesh steps on those rows with the loop's keys
    ``fold_in(root, step)``."""
    world, (name, _, _, _) = _job(job)
    for out in outs[world]:
        a = _section(out, name, "train_params")
        b = _section(out, name, "hand_params")
        assert sorted(a) == sorted(b) and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


EVAL_JOBS = [j[0] for jobs in W.JOBS.values() for j in jobs
             if "eval" in j[3]]


@pytest.mark.parametrize("job", EVAL_JOBS)
def test_evaluate_matches_jax_on_the_mesh(jax_runs, outs, job):
    """The eval sweep over loaders striped by rank: the same batch count
    on every rank (from the corpus before striping), and JAX's sweep
    over the same global batches on its mesh."""
    world, (name, cfg, _, _) = _job(job)
    for out in outs[world]:
        assert int(out[f"{name}/eval_batches"]) == \
            jax_runs[job]["eval_batches"]
        _close(_section(out, name, "eval"), jax_runs[job]["eval"],
               _tol(cfg), f"{job} eval")


@pytest.mark.parametrize("job", EVAL_JOBS)
def test_evaluate_per_class_matches_jax_on_the_mesh(jax_runs, outs, job):
    """The per-class sweep (in runs of two batches a call on the port's
    side) against JAX's per-class sweep on its mesh, class by class."""
    world, (name, cfg, _, _) = _job(job)
    want = {f"{c}/{k}": v for c, r in jax_runs[job]["per_class"].items()
            if r is not None for k, v in r.items()}
    for out in outs[world]:
        _close(_section(out, name, "per_class"), want, _tol(cfg),
               f"{job} per-class")


SAMPLE_JOBS = [j[0] for jobs in W.JOBS.values() for j in jobs
               if "sample" in j[3]]
DET_JOBS = [j[0] for jobs in W.JOBS.values() for j in jobs
            if "det" in j[3]]


@pytest.mark.parametrize("job", SAMPLE_JOBS)
def test_sharded_sampler_matches_jax(jax_runs, outs, job):
    """Every rank returns all sketches, gathered in data order: lengths
    and pens JAX's sharded sampler's, offsets within 1e-5."""
    world, (name, _, _, _) = _job(job)
    s5, lens = jax_runs[job]["sample"]
    for out in outs[world]:
        got = _section(out, name, "sample")
        np.testing.assert_array_equal(got["lengths"], lens)
        np.testing.assert_array_equal(got["strokes5"][..., 2:], s5[..., 2:])
        np.testing.assert_allclose(got["strokes5"], s5, rtol=0, atol=1e-5)


# -- in this process: no ranks ---------------------------------------------


@pytest.mark.parametrize("host_id,num_hosts", [(0, 2), (1, 2), (3, 4)])
def test_loader_striping_matches_jax(host_id, num_hosts):
    """``synthetic_loader`` striped: bit for bit the JAX package's stripe
    (rows, the stripe's seed and so its augmented stream, the scale of
    the whole corpus, the eval batches and their count)."""
    jh, th = JHParams(**W.TINY), HParams(**W.TINY)
    kw = dict(num=W.EVAL_NUM, seed=4, host_id=host_id,
              num_hosts=num_hosts, augment=True)
    with pytest.MonkeyPatch.context() as mp:
        # both native batchers' own augmentation RNG off, as elsewhere
        mp.setattr(jloader.NB, "assemble_batch_aug", lambda *a, **k: None)
        mp.setenv("SKETCH_RNN_TPU_TORCH_NO_NATIVE", "1")
        (jl, js), (tl, ts) = (jloader.synthetic_loader(jh, **kw),
                              tloader.synthetic_loader(th, **kw))
        assert js == ts and len(jl) == len(tl)
        assert jl.num_eval_batches == tl.num_eval_batches
        pairs = [(jl.next_batch(), tl.next_batch()) for _ in range(2)]
        pairs += [(jl.get_batch(i), tl.get_batch(i))
                  for i in range(jl.num_eval_batches)]
    for a, b in pairs:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shape,axes,world", [
    ((3,), ("data",), 8), ((-1, -1), ("model", "data"), 8),
    ((3, -1), ("model", "data"), 8), ((2,), ("data", "model"), 8),
    ((2, -1), ("model", "data"), 8), ((-1,), ("data",), 4)])
def test_make_mesh_checks_the_shape_as_jax(shape, axes, world):
    """The same ``ValueError`` text as the JAX package's ``make_mesh`` on
    as many devices, or the same shape (``tests/test_train.py:
    test_mesh_shape_validation``)."""
    jh = JHParams(**W.TINY, mesh_shape=shape, mesh_axes=axes)
    th = HParams(**W.TINY, mesh_shape=shape, mesh_axes=axes)
    try:
        want = dict(jmake_mesh(jh, devices=jax.devices()[:world]).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(th, world=world)
        assert str(got.value) == str(e)
        return
    assert tmesh.make_mesh(th, world=world).shape == want


def test_mesh_places_ranks_row_major():
    """Rank ``r`` of a ``("model", "data")`` mesh sits where device ``r``
    sits in JAX's ``np.asarray(devices).reshape(shape)``; its data group
    is its row."""
    th = HParams(**W.TINY, mesh_shape=(2, -1), mesh_axes=("model", "data"))
    m = tmesh.make_mesh(th, world=8)
    assert m.shape == {"model": 2, "data": 4}
    np.testing.assert_array_equal(m.devices, np.arange(8).reshape(2, 4))
    assert (m.coords, m.data_index, m.data_ranks) == \
        ({"model": 0, "data": 0}, 0, (0, 1, 2, 3))


def test_no_fallback_without_a_way_to_sum():
    """A batch that does not split over the data axis raises as JAX's
    (``tests/test_train.py:test_mesh_batch_not_divisible_raises``); a data
    axis of several ranks without a process group raises rather than
    summing locally; the sampler likewise."""
    th = HParams(**dict(W.TINY, batch_size=12))
    tm = SketchRNN(th)
    with pytest.raises(ValueError, match="divisible"):
        tstep.make_train_step(tm, th, device="cpu",
                              mesh=tmesh.make_mesh(th, world=8))
    th = HParams(**W.TINY)
    for make in (tstep.make_train_step, tstep.make_eval_step,
                 tstep.make_per_class_eval_step):
        with pytest.raises(RuntimeError, match="no process group"):
            make(tm, th, device="cpu", mesh=tmesh.make_mesh(th, world=2))


@pytest.mark.parametrize("stack", [1, 2])
def test_prefetcher_hands_a_rank_its_rows(stack):
    """``prefetch_batches(mesh=)``: the rows of each global batch that the
    JAX package's feeder places on this rank's device (rank 0 of a data
    axis of 2 here), stacked or not."""
    jh, th = JHParams(**W.TINY), HParams(**W.TINY)
    kw = dict(num=24, seed=2)
    jmesh = jmake_mesh(jh, devices=jax.devices()[:2])
    want = jprefetch.prefetch_batches(
        jloader.synthetic_loader(jh, **kw)[0], jmesh, 0, stack=stack).get()
    got = tprefetch.prefetch_batches(
        tloader.synthetic_loader(th, **kw)[0], "cpu", 0, stack=stack,
        mesh=tmesh.make_mesh(th, world=2)).get()
    rows = W.TINY["batch_size"] // 2
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        shard = np.asarray(v)[:, :rows] if stack > 1 else \
            np.asarray(v)[:rows]
        np.testing.assert_array_equal(got[k].numpy(), shard, err_msg=k)


def test_shard_batch_takes_this_ranks_rows():
    """A rank's rows of a host batch, stacked or not, as JAX's
    ``shard_batch`` places them on the data axis."""
    th = HParams(**W.TINY, mesh_shape=(2, -1), mesh_axes=("model", "data"))
    m = tmesh.make_mesh(th, world=8)           # this process: rank 0
    x = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    np.testing.assert_array_equal(
        tmesh.shard_batch({"x": x[0]}, m)["x"], x[0, :2])
    np.testing.assert_array_equal(
        tmesh.shard_batch({"x": x}, m, stacked=True)["x"], x[:, :2])
    with pytest.raises(ValueError, match="leading axis"):
        tmesh.shard_batch({"x": x, "y": x[:1]}, m, stacked=True)


@pytest.mark.parametrize("job", DET_JOBS)
def test_gradient_is_the_one_device_gradient(inputs, outs, job):
    """On a model without randomness (unconditional, no dropout), where a
    rank's key does not matter, the port's gradient over N ranks and its
    loss are JAX's one-device (``mesh=None``) gradient and loss of the
    global batch: the global sums and the one all-reduce make the global
    loss's gradient."""
    world, (name, cfg, _, _) = _job(job)
    _, params, batches, _ = inputs
    jm = JSketchRNN(JHParams(**W.CONFIGS[cfg]))

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batches[0].items()},
                       jax.random.key(W.STEP_KEY), 0.0, train=True)

    (_, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params[cfg])
    want = {k: float(v) for k, v in jmet.items() if k != "kl_weight"}
    for out in outs[world]:
        got = _section(out, name, "grad_metrics")
        _close({k: got[k] for k in want}, want, (RTOL, ATOL), f"{job} loss")
        _close(_section(out, name, "grads"), _flat_jax(jg), (RTOL, ATOL),
               f"{job} grads")


def test_world_one_train_matches_jax_one_device_mesh():
    """``train()`` at its default (``use_mesh=True``) in a process with no
    group is one rank: its rows and parameters are JAX's steps on a
    one-device mesh, whose keys fold with 0 (``sketch_rnn_tpu/train/
    step.py:142``), from the same weights, batches and keys."""
    cfg = dict(W.CONFIGS["lstm_plain_f32"], steps_per_call=1)
    jh, th = JHParams(**cfg), HParams(**cfg)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jp = jm.init_params(jax.random.key(3))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    rows = []
    state = tloop.train(th, tloader.synthetic_loader(
        th, num=24, seed=4)[0], seed=9, num_steps=2, params=tp,
        device="cpu", history=rows)
    mesh = jmake_mesh(jh, devices=jax.devices()[:1])
    step = jstep.make_train_step(jm, jh, mesh)
    jl = jloader.synthetic_loader(jh, num=24, seed=4)[0]
    root = jax.random.split(jax.random.key(9))[0]
    st = jstate.TrainState(_copy(jp), jstate.make_optimizer(jh).init(jp),
                           jnp.zeros((), jnp.int32))
    for s in range(2):
        st, met = step(st, jshard(jl.next_batch(), mesh),
                       jax.random.fold_in(root, s))
        for k in ("loss", "recon", "kl", "grad_norm"):
            np.testing.assert_allclose(rows[s][k], float(met[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {s} {k}")
    _close({"/".join(p): v.numpy() for p, v in tree_items(state.params)},
           _flat_jax(st.params), (0.0, PARAM_ATOL), "params")
