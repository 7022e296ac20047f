"""Shared by ``tests/test_torch_dropout.py`` and
``tests/test_torch_dropout_bf16.py``: the tiny models with both dropouts,
and the loss-and-gradients comparison against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.data import loader as jloader
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.utils import prng

TINY = dict(batch_size=4, max_seq_len=8, enc_rnn_size=12, dec_rnn_size=16,
            z_size=6, num_mixture=3, conditional=True, dec_model="layer_norm",
            num_classes=3, class_embed_size=4, fused_rnn=True,
            hyper_rnn_size=8, hyper_embed_size=4, use_input_dropout=True,
            use_output_dropout=True, input_dropout_keep=0.8,
            output_dropout_keep=0.7)
RTOL, ATOL = 1e-5, 1e-6
BF_MET_RTOL, BF_MET_ATOL = 1e-4, 1e-6
BF_RTOL, BF_ATOL = 1e-3, 1e-4
PARAM_ATOL = 2e-5
DROPOUTS = {"input": dict(use_output_dropout=False),
            "output": dict(use_input_dropout=False), "both": {}}


def models(**over):
    kw = dict(TINY, **over)
    jh, th = JHParams(**kw), HParams(**kw)
    jm, tm = JSketchRNN(jh), SketchRNN(th)
    jp = jm.init_params(jax.random.key(5))
    return jh, th, jm, tm, jp, params_from_jax(jax.device_get(jp), "cpu")


def _batch(jh, seed=0):
    return jloader.synthetic_loader(jh, num=24, seed=seed)[0].random_batch()


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _tree_close(a, b, atol, rtol, what):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    assert len(fa) == len(b)
    for (path, x), y in zip(fa, b):
        np.testing.assert_allclose(_np(y), np.asarray(x), rtol=rtol,
                                   atol=atol, err_msg=f"{what}{path}")


CELLS = ["lstm", "layer_norm", "hyper"]


def check_loss_and_gradients(dropout, cell, fused, dtype):
    """``loss(train=True)`` and its gradients against JAX's on one batch
    and key, with ``dropout`` (``DROPOUTS``) on the ``cell`` decoder."""
    over = dict(DROPOUTS[dropout], dec_model=cell, fused_rnn=fused)
    if dtype == "bfloat16":
        over.update(compute_dtype="bfloat16",
                    fused_residual_dtype="bfloat16")
    jh, th, jm, tm, jp, tp = models(**over)
    batch = _batch(jh)

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(11), 0.37, train=True)

    (_, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    flat = [x.requires_grad_(True) for x in jax.tree_util.tree_leaves(tp)]
    ttot, tmet = tm.loss(tp, {k: torch.from_numpy(np.asarray(v))
                              for k, v in batch.items()},
                         prng.key(11), 0.37, train=True)
    tg = torch.autograd.grad(ttot, flat, allow_unused=True)
    tg = [torch.zeros_like(p) if g is None else g for g, p in zip(tg, flat)]
    met_tol = ((RTOL, ATOL) if dtype == "float32"
               else (BF_MET_RTOL, BF_MET_ATOL))
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=met_tol[0], atol=met_tol[1],
                                   err_msg=k)
    tol = (RTOL, ATOL) if dtype == "float32" else (BF_RTOL, BF_ATOL)
    _tree_close(jg, tg, atol=tol[1], rtol=tol[0], what="grad ")
