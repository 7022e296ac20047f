"""One rank of the port's data-parallel CPU test (``tests/test_torch_dp.py``).

    python tests/_torch_dp_worker.py <rank> <world> <port> <dir>

Imports only the port (as ``tests/_multihost_worker.py`` imports only
the JAX package). Joins a gloo group of ``world`` ranks at
``tcp://127.0.0.1:<port>``, reads ``<dir>/in.npz`` (the weights of each
config of :data:`CONFIGS`, made by the JAX package and carried over with
``convert.py``; the global batches and the sampler's inputs, made with
numpy), runs the jobs of :data:`JOBS` for its world on the meshes they
name, and writes everything it computed to
``<dir>/out_<world>_<rank>.npz``, one key per value:
``<job>/<what>/<name>``.

The test imports this module for :data:`CONFIGS`, :data:`JOBS` and the
shared sizes, so both sides build the same models and batches.
"""

import os
import sys

import numpy as np

TINY = dict(batch_size=8, max_seq_len=8, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, conditional=True, num_classes=3,
            class_embed_size=4, steps_per_call=3)
CONFIGS = {
    # the flagship's shape: LayerNorm-LSTM decoder through the fused
    # kernels' plain versions at bfloat16, recurrent dropout on
    "ln_fused_bf16": dict(TINY, dec_model="layer_norm", fused_rnn=True,
                          compute_dtype="bfloat16",
                          fused_residual_dtype="bfloat16"),
    # the plain cell loop at float32 with every dropout on
    "lstm_plain_f32": dict(TINY, dec_model="lstm", fused_rnn=False,
                           use_input_dropout=True, use_output_dropout=True),
    # no randomness at all: a rank's key does not matter
    "lstm_det": dict(TINY, dec_model="lstm", fused_rnn=False,
                     conditional=False, use_recurrent_dropout=False),
}
# the meshes of the jobs: (mesh_shape, mesh_axes)
DATA = ((-1,), ("data",))
MODEL_DATA = ((2, -1), ("model", "data"))
# per world: (job, config, mesh, what it runs)
JOBS = {
    2: (("ln2", "ln_fused_bf16", DATA,
         ("multi", "eval", "per_class", "sample")),
        ("lstm2", "lstm_plain_f32", DATA, ("step", "train"))),
    4: (("lstm4", "lstm_plain_f32", DATA,
         ("multi", "eval", "per_class", "sample")),
        ("ln4md", "ln_fused_bf16", MODEL_DATA, ("step",)),
        ("det4", "lstm_det", DATA, ("det",))),
}
STEP_KEY, EVAL_KEY, SAMPLE_KEY = 11, 7, 3      # prng.key / jax.random.key
EVAL_NUM, EVAL_SEED = 23, 5     # an uneven split: stripes wrap-fill
TRAIN_SEED = 9
SAMPLE_TAU = 0.7


def job_hps(cfg, mesh):
    from sketch_rnn_tpu_torch import HParams

    shape, axes = mesh
    return HParams(**CONFIGS[cfg], mesh_shape=shape, mesh_axes=axes)


def unflat(flat):
    """``{"a/b": array}`` as the nested dict of tensors ``{"a": {"b":
    tensor}}``."""
    import torch

    tree = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(v))
    return tree


def flat(tree):
    from sketch_rnn_tpu_torch.train.state import tree_items

    return {"/".join(p): v.detach().float().numpy()
            for p, v in tree_items(tree)}


def run_job(name, cfg, mesh_spec, what, inp, out):
    import torch

    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.models.vae import SketchRNN
    from sketch_rnn_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from sketch_rnn_tpu_torch.parallel.multihost import local_batch_hps
    from sketch_rnn_tpu_torch.sample.sampler import make_sampler
    from sketch_rnn_tpu_torch.train import loop, step
    from sketch_rnn_tpu_torch.train.state import make_train_state
    from sketch_rnn_tpu_torch.utils import prng

    hps = job_hps(cfg, mesh_spec)
    mesh = make_mesh(hps)
    model = SketchRNN(hps)
    prefix = f"params/{cfg}/"
    params = unflat({k[len(prefix):]: v for k, v in inp.items()
                     if k.startswith(prefix)})
    batches = [shard_batch({k.split("/")[2]: v for k, v in inp.items()
                            if k.startswith(f"batch/{i}/")}, mesh)
               for i in range(4)]
    key = prng.key(STEP_KEY)

    def put(what_, values):
        for k, v in values.items():
            out[f"{name}/{what_}/{k}"] = np.asarray(v)

    def scalars(metrics):
        return {k: float(v) for k, v in metrics.items()}

    state = make_train_state(params)
    if "step" in what or "det" in what:
        b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
        row = step.stage_steps(model, hps, state, mesh.fold(key[None]),
                               b["strokes"].shape[0])[0]
        grads, gm = step.grads_and_metrics(model, params, b, row, mesh)
        put("grads", flat(grads))
        put("grad_metrics", scalars(gm))
        new, m = step.make_train_step(model, hps, device="cpu",
                                      mesh=mesh)(state, batches[0], key)
        put("step_metrics", scalars(m))
        put("step_params", flat(new.params))
    if "multi" in what:
        k = hps.steps_per_call
        stack = {n: np.stack([b[n] for b in batches[1:1 + k]])
                 for n in batches[1]}
        new, m = step.make_multi_train_step(model, hps, device="cpu",
                                            mesh=mesh)(state, stack, key)
        put("multi_metrics", scalars(m))
        put("multi_params", flat(new.params))
        single, st = step.make_train_step(model, hps, device="cpu",
                                          mesh=mesh), state
        for i in range(k):
            st, _ = single(st, batches[1 + i], prng.fold_in(key, i))
        put("singles_params", flat(st.params))
    if "eval" in what or "per_class" in what:
        lhps = local_batch_hps(hps, mesh.data_size)
        loader, _ = synthetic_loader(lhps, EVAL_NUM, seed=EVAL_SEED,
                                     host_id=mesh.data_index,
                                     num_hosts=mesh.data_size)
        out[f"{name}/eval_batches"] = np.asarray(loader.num_eval_batches)
    if "eval" in what:
        ev = loop.evaluate(params, loader,
                           step.make_eval_step(model, hps, device="cpu",
                                               mesh=mesh),
                           mesh, key=prng.key(EVAL_KEY))
        put("eval", ev)
    if "per_class" in what:
        # in runs of 2 batches a call
        per = loop.evaluate_per_class(
            params, loader,
            step.make_per_class_eval_step(model, hps, device="cpu",
                                          mesh=mesh),
            hps.num_classes, mesh, key=prng.key(EVAL_KEY),
            multi=(step.make_multi_per_class_eval_step(
                model, hps, device="cpu", mesh=mesh), 2))
        put("per_class", {f"{c}/{k}": v for c, r in per.items()
                          if r is not None for k, v in r.items()})
    if "train" in what:
        # train() on the mesh: an unstriped loader's global batches, each
        # rank taking its rows, against hand-driven mesh steps on the same
        # rows and keys; then a loader striped by rank
        th = hps.replace(steps_per_call=1)
        root = prng.split(prng.key(TRAIN_SEED), 2)[0]
        glob = lambda: synthetic_loader(th, 24, seed=TRAIN_SEED)[0]
        st = loop.train(th, glob(), seed=TRAIN_SEED, num_steps=2,
                        params=params, device="cpu")
        put("train_params", flat(st.params))
        single, st, ld = step.make_train_step(model, th, device="cpu",
                                              mesh=mesh), state, glob()
        for s in range(2):
            st, _ = single(st, shard_batch(ld.next_batch(), mesh),
                           prng.fold_in(root, s))
        put("hand_params", flat(st.params))
        striped, _ = synthetic_loader(
            local_batch_hps(th, mesh.data_size), 24, seed=TRAIN_SEED,
            host_id=mesh.data_index, num_hosts=mesh.data_size)
        st = loop.train(th, striped, seed=TRAIN_SEED, num_steps=2,
                        params=params, device="cpu")
        put("striped_params", flat(st.params))
    if "sample" in what:
        fn = make_sampler(model, hps, mesh=mesh, device="cpu")
        s5, lens = fn(params, prng.key(SAMPLE_KEY), hps.batch_size,
                      inp["sample/z"], inp["sample/labels"], SAMPLE_TAU,
                      inp["sample/caps"])
        put("sample", {"strokes5": s5.numpy(), "lengths": lens.numpy()})


def main() -> int:
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    import torch

    from sketch_rnn_tpu_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    mh.initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    out = {}
    try:
        with np.load(os.path.join(outdir, "in.npz")) as f:
            inp = dict(f)
        for name, cfg, mesh, what in JOBS[world]:
            run_job(name, cfg, mesh, what, inp, out)
    finally:
        mh.shutdown()
    np.savez(os.path.join(outdir, f"out_{world}_{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
