"""Recurrence over time and the bidirectional encoder.

The port of ``run_rnn``, ``final_hidden``, ``length_reverse_indices`` and
``bidirectional_rnn`` from ``sketch_rnn_tpu/ops/rnn.py``. Two paths:

- the plain path (``fused=False``): a Python loop of cell steps, the
  port of the JAX package's ``lax.scan``. Training at ``fused_rnn=false``
  runs it (every preset but ``quickdraw345_dp``), with recurrent dropout
  drawn from ``(key, t)``, and so does serving's endpoint encode phase.
  ``hoist=True`` projects the inputs of all steps in one product first
  (``cell.precompute_inputs``) and steps ``cell.step_pre``: the layout
  that ``ops/cuda_lstm.py::lstm_seq`` fuses. ``remat=True`` checkpoints
  each step (``torch.utils.checkpoint``): the backward recomputes the
  step's gate block instead of keeping it.
- the fused path (``fused=True``, training): the whole recurrence and its
  backward go through the training kernels of ``ops/cuda_fused.py``
  (``_run_fused``, the port of the JAX package's dispatch of the same
  name). The encoder's LSTM takes ``fused_lstm_seq``, the LSTM decoder
  ``fused_lstm``, the LayerNorm-LSTM decoder ``fused_ln_lstm`` and the
  HyperLSTM (decoder or encoder) ``fused_hyper_lstm``, each decoder with
  its per-example ``x_bias`` (the HyperLSTM with a second one for its
  auxiliary LSTM).

Carries are the cells': ``(c, h)``, or ``((c, h), (hc, hh))`` for the
HyperLSTM.

Everything is time-major ``[T, B, D]``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.ops import linear as L
from sketch_rnn_tpu_torch.ops.cells import HyperLSTMCell, LayerNormLSTMCell
from sketch_rnn_tpu_torch.utils import prng

INT32_MAX = 2 ** 31 - 1


def make_dropout_masks(key: torch.Tensor, keep_prob: float, steps: int,
                       batch_size: int, hidden_size: int) -> torch.Tensor:
    """Per-step inverted-dropout masks ``[T, B, H]`` (float32), bitwise
    the JAX package's ``make_dropout_masks``: ``bernoulli(key, keep, (T,
    B, H)) / keep``."""
    m = prng.bernoulli(key, keep_prob, (steps, batch_size, hidden_size))
    return _scale_mask(m, keep_prob)


def _scale_mask(m, keep_prob):
    # an element is 0 or float32(1 / keep): JAX's m / keep of a 0/1 mask
    return m.to(torch.float32) * torch.full(
        (), float(np.float32(1.0) / np.float32(keep_prob)),
        dtype=torch.float32, device=m.device)


def step_dropout_masks(key: torch.Tensor, keep_prob: float, steps: int,
                       batch_size: int, hidden_size: int) -> torch.Tensor:
    """The masks the JAX package's scan draws in its loop under
    ``rdrop_gen=(key, keep)``: step ``t``'s is ``bernoulli(fold_in(key,
    t), keep, (B, H)) / keep``, ``t`` being the position in the sequence
    (also when it is read back to front). All ``T`` are drawn by one
    vectorised threefry (on the plain path, a draw per step would cost a
    few hundred eager launches each); the bits are the per-step draws'."""
    keys = prng.fold_in(key, torch.arange(steps, device=key.device))
    m = prng.bernoulli(keys, keep_prob, (batch_size, hidden_size))
    return _scale_mask(m, keep_prob)


def _run_fused(cell, params, xs, carry0, rdrop_masks, reverse, rdrop_gen,
               residual_dtype=None, x_extra=None, seq_only=False):
    """Dispatch to the fused training kernels, as the JAX package's
    ``_run_fused`` does. ``reverse`` flips inputs and outputs around the
    kernel. ``rdrop_gen = (key, keep)`` becomes the kernels' in-kernel
    dropout: the seed is ``randint(key, 0, 2**31-1)``, bitwise the JAX
    package's, so the masks are too; ``key`` may be that seed already (an
    int32 scalar, as ``SketchRNN.draws`` makes it). With the cell's ``compute_dtype``
    the weights are cast inside the autograd graph (their gradients come
    back through the cast as float32). ``x_extra [B, E]`` (time-invariant
    inputs) is projected once into the per-example gate bias ``x_extra @
    wx[d_s:]`` (a plain product with float32 accumulation, as the JAX
    package leaves it to XLA) while ``wx[:d_s]`` goes into the kernel.
    The HyperLSTM's auxiliary LSTM reads ``[x; h]``: its input weight
    splits into the rows of the strokes (kernel), of ``x_extra`` (a
    second per-example bias, ``x_extra @ hyper_wx[d_s:d_in]``) and of
    ``h`` (kernel); the ``w_zd_*`` block projections, every bias and the
    LN parameters stay float32."""
    masks = rdrop_masks
    seed, keep = None, 1.0
    if rdrop_gen is not None:
        key, keep = rdrop_gen
        seed = (key if key.dtype == torch.int32
                else prng.randint(key, 0, INT32_MAX)).to(xs.device)
    if reverse:
        xs = torch.flip(xs, dims=(0,))
        if masks is not None:
            masks = torch.flip(masks, dims=(0,))
    xs = xs.contiguous()
    cd = cell.compute_dtype
    cast = (lambda w: w.to(cd)) if cd is not None else (lambda w: w)
    wx, wh = cast(params["wx"]), cast(params["wh"])
    xb = None
    if x_extra is not None:
        d_s = xs.shape[-1]
        xb = L.matmul(x_extra, wx[d_s:], cd)
        wx = wx[:d_s]
    leaves = tuple(c.contiguous() for c in cell.carry_leaves(carry0))
    if isinstance(cell, HyperLSTMCell):
        hyper = params["hyper"]
        d_in = hyper["wx"].shape[0] - cell.hidden_size
        wxh = cast(hyper["wx"])
        xbh = None
        wxh_x = wxh[:d_in]
        if x_extra is not None:
            d_s = xs.shape[-1]
            xbh = L.matmul(x_extra, wxh[d_s:d_in], cd)
            wxh_x = wxh[:d_s]
        hs, fin = CF.fused_hyper_lstm(
            xs, wx, params["b"], wh, wxh_x, wxh[d_in:], hyper["b"],
            cast(hyper["wh"]), cast(params["w_hz_x"]), params["b_hz_x"],
            cast(params["w_hz_h"]), params["b_hz_h"],
            cast(params["w_hz_b"]), params["w_zd_x"], params["w_zd_h"],
            params["w_zd_b"], params["ln_gamma"], params["ln_beta"],
            params["lnc_gamma"], params["lnc_beta"], *leaves,
            cell.forget_bias, masks, seed, keep, residual_dtype, xb, xbh)
    elif isinstance(cell, LayerNormLSTMCell):
        c0, h0 = leaves
        hs, fin = CF.fused_ln_lstm(
            xs, wx, wh, params["ln_gamma"], params["ln_beta"],
            params["lnc_gamma"], params["lnc_beta"], c0, h0,
            cell.forget_bias, masks, seed, keep, residual_dtype, xb)
    elif seq_only and xb is None:
        # encoder: no final carry; xs and the zero carries are not
        # differentiated, so the sequence-only kernel serves
        c0, h0 = leaves
        hs = CF.fused_lstm_seq(xs, wx, params["b"], wh, c0, h0,
                               cell.forget_bias, masks, seed, keep,
                               residual_dtype)
        fin = None
    else:
        c0, h0 = leaves
        hs, fin = CF.fused_lstm(xs, wx, params["b"], wh, c0, h0,
                                cell.forget_bias, masks, seed, keep,
                                residual_dtype, xb)
    if reverse:
        hs = torch.flip(hs, dims=(0,))
    return fin, hs


def run_rnn(cell, params, xs: torch.Tensor, carry0: Optional[Any] = None,
            rdrop_masks: Optional[torch.Tensor] = None,
            reverse: bool = False, hoist: bool = False,
            rdrop_gen: Optional[Tuple[torch.Tensor, float]] = None,
            remat: bool = False, fused: bool = False, residual_dtype=None,
            x_extra: Optional[torch.Tensor] = None,
            need_final: bool = True) -> Tuple[Any, torch.Tensor]:
    """Step ``cell`` over time-major inputs ``xs [T, B, D]``.

    Returns ``(final_carry, hs [T, B, H])``. ``reverse=True`` runs back
    to front and returns the outputs in the original time order.
    Recurrent dropout: ``rdrop_masks [T, B, H]`` streams masks;
    ``rdrop_gen = (key, keep)`` draws them from ``(key, t)`` on the plain
    path (:func:`step_dropout_masks`) and inside the fused kernels. On
    the plain path ``hoist`` steps ``cell.step_pre`` over
    ``cell.precompute_inputs(xs)`` and ``remat`` recomputes each step in
    the backward; the fused path ignores both (its kernels keep no gate
    block). ``x_extra [B, E]``: time-invariant input features (the cell's
    input weight covers ``D + E`` rows); a per-example gate bias on the
    fused path, broadcast and concatenated on the plain one.
    ``need_final=False`` declares that only ``hs`` is used and neither
    ``xs`` nor the (zero) carries are differentiated: the fused LSTM then
    takes the sequence-only kernel and returns no final carry.
    """
    if rdrop_masks is not None and rdrop_gen is not None:
        raise ValueError("pass rdrop_masks or rdrop_gen, not both")
    zero_carry = carry0 is None
    if carry0 is None:
        carry0 = cell.initial_carry(xs.shape[1], device=xs.device)
    if fused:
        return _run_fused(cell, params, xs, carry0, rdrop_masks, reverse,
                          rdrop_gen, residual_dtype, x_extra,
                          seq_only=not need_final and zero_carry)
    t_len, b = xs.shape[:2]
    masks = rdrop_masks
    if rdrop_gen is not None:
        key, keep = rdrop_gen
        masks = step_dropout_masks(key.to(xs.device), keep, t_len, b,
                                   cell.hidden_size)
    if x_extra is not None:
        xs = torch.cat([xs, x_extra[None].expand(t_len, *x_extra.shape)],
                       dim=-1)
    inputs = cell.precompute_inputs(params, xs) if hoist else xs
    stepper = cell.step_pre if hoist else cell
    if remat:
        # masks come from (key, t), so the recomputation needs no torch
        # RNG state
        def step(carry, x, m):
            return checkpoint(stepper, params, carry, x, m,
                              use_reentrant=False, preserve_rng_state=False)
    else:
        def step(carry, x, m):
            return stepper(params, carry, x, m)
    at = (lambda t: tuple(a[t] for a in inputs)) \
        if isinstance(inputs, tuple) else (lambda t: inputs[t])
    carry = carry0
    order = range(t_len - 1, -1, -1) if reverse else range(t_len)
    hs = [None] * t_len
    for t in order:
        carry, hs[t] = step(carry, at(t),
                            masks[t] if masks is not None else None)
    return carry, torch.stack(hs)


def final_hidden(cell, carry) -> torch.Tensor:
    """The hidden state ``h`` of a cell's carry: ``(c, h)``, or the
    HyperLSTM's ``((c, h), hyper_carry)``."""
    head = carry[0]
    if isinstance(head, tuple):
        return head[1]
    return carry[1]


def length_reverse_indices(t: int, seq_len: torch.Tensor) -> torch.Tensor:
    """``[T, B]`` time indices that flip each sequence's valid prefix
    ``[0, len)`` and keep the padding rows in place."""
    idx = torch.arange(t, device=seq_len.device)[:, None]
    sl = seq_len.to(idx.dtype)[None, :]
    return torch.where(idx < sl, sl - 1 - idx, idx)


def bidirectional_rnn(cell_fwd, cell_bwd, params_fwd, params_bwd,
                      xs: torch.Tensor,
                      seq_len: Optional[torch.Tensor] = None,
                      rdrop_masks_fwd: Optional[torch.Tensor] = None,
                      rdrop_masks_bwd: Optional[torch.Tensor] = None,
                      rdrop_gen_fwd=None, rdrop_gen_bwd=None,
                      remat: bool = False, fused: bool = False,
                      residual_dtype=None,
                      xs_rev: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward + backward passes; returns ``(h_final [B, 2H], hs [T, B,
    2H])``. ``h_final`` is the forward pass's state at each sequence's
    last VALID step and the backward pass's state after reading the
    sequence back to front, selected by the same one-hot contraction as
    the JAX package (exact: one term of each sum is the value times 1).
    ``xs_rev``: the length-aware-reversed inputs, if the caller gathered
    them already (the model does, on its batch-major strokes)."""
    t = xs.shape[0]
    if seq_len is None and xs_rev is not None:
        raise ValueError(
            "xs_rev was supplied but seq_len is None: the no-seq_len path "
            "runs a plain reverse pass over xs and would ignore it")
    kw = dict(remat=remat, fused=fused, residual_dtype=residual_dtype)
    if seq_len is None:
        fwd_carry, hs_f = run_rnn(cell_fwd, params_fwd, xs,
                                  rdrop_masks=rdrop_masks_fwd,
                                  rdrop_gen=rdrop_gen_fwd, **kw)
        bwd_carry, hs_b = run_rnn(cell_bwd, params_bwd, xs, reverse=True,
                                  rdrop_masks=rdrop_masks_bwd,
                                  rdrop_gen=rdrop_gen_bwd, **kw)
        h_f = final_hidden(cell_fwd, fwd_carry)
        h_b = final_hidden(cell_bwd, bwd_carry)
    else:
        rev_idx = length_reverse_indices(t, seq_len)
        if xs_rev is None:
            xs_rev = torch.take_along_dim(xs, rev_idx[:, :, None], dim=0)
        _, hs_f = run_rnn(cell_fwd, params_fwd, xs,
                          rdrop_masks=rdrop_masks_fwd,
                          rdrop_gen=rdrop_gen_fwd, need_final=False, **kw)
        _, hs_b_rev = run_rnn(cell_bwd, params_bwd, xs_rev,
                              rdrop_masks=rdrop_masks_bwd,
                              rdrop_gen=rdrop_gen_bwd, need_final=False,
                              **kw)
        # float32 accumulation, then back to the residual dtype, as the
        # JAX package's preferred_element_type einsum and astype
        last = torch.clamp(seq_len.long() - 1, 0, t - 1)
        onehot = torch.nn.functional.one_hot(last, t).float()
        h_f = torch.einsum("tbh,bt->bh", hs_f.float(), onehot).to(hs_f.dtype)
        h_b = torch.einsum("tbh,bt->bh", hs_b_rev.float(),
                           onehot).to(hs_b_rev.dtype)
        hs_b = torch.take_along_dim(hs_b_rev, rev_idx[:, :, None], dim=0)
    return torch.cat([h_f, h_b], dim=-1), torch.cat([hs_f, hs_b], dim=-1)
