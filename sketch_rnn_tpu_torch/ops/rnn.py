"""Recurrence over time and the bidirectional encoder.

The port of ``run_rnn``, ``final_hidden``, ``length_reverse_indices`` and
``bidirectional_rnn`` from ``sketch_rnn_tpu/ops/rnn.py``. Two paths:

- the plain path (``fused=False``): a Python loop of cell steps, with
  optional streamed recurrent-dropout masks. Serving's endpoint encode
  phase runs it, as the JAX package does at ``fused_rnn=false``.
- the fused path (``fused=True``, training): the whole recurrence and its
  backward go through the training kernels of ``ops/cuda_fused.py``
  (``_run_fused``, the port of the JAX package's dispatch of the same
  name). The encoder's LSTM takes ``fused_lstm_seq``, the LayerNorm-LSTM
  decoder ``fused_ln_lstm`` with its per-example ``x_bias``.

Everything is time-major ``[T, B, D]``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF
from sketch_rnn_tpu_torch.ops.cells import LayerNormLSTMCell
from sketch_rnn_tpu_torch.utils import prng

INT32_MAX = 2 ** 31 - 1


def _run_fused(cell, params, xs, carry0, rdrop_masks, reverse, rdrop_gen,
               residual_dtype=None, x_extra=None, seq_only=False):
    """Dispatch to the fused training kernels. ``reverse`` flips inputs
    and outputs around the kernel. ``rdrop_gen = (key, keep)`` becomes
    the kernels' in-kernel dropout: the seed is ``randint(key, 0,
    2**31-1)``, bitwise the JAX package's, so the masks are too.
    ``x_extra [B, E]`` (time-invariant inputs) is projected once into the
    per-example gate bias ``x_extra @ wx[d_s:]`` (a plain product, as the
    JAX package leaves it to XLA) while ``wx[:d_s]`` goes into the
    kernel."""
    if cell.compute_dtype is not None:
        raise NotImplementedError(
            "compute_dtype=bfloat16 on the fused training kernels comes "
            "with the next slice of the PyTorch port; train with "
            "compute_dtype=float32")
    masks = rdrop_masks
    seed, keep = None, 1.0
    if rdrop_gen is not None:
        key, keep = rdrop_gen
        seed = prng.randint(key, 0, INT32_MAX).to(xs.device)
    if reverse:
        xs = torch.flip(xs, dims=(0,))
        if masks is not None:
            masks = torch.flip(masks, dims=(0,))
    xs = xs.contiguous()
    wx, wh = params["wx"], params["wh"]
    xb = None
    if x_extra is not None:
        d_s = xs.shape[-1]
        xb = torch.matmul(x_extra, wx[d_s:])
        wx = wx[:d_s]
    c0, h0 = (c.contiguous() for c in carry0)
    if isinstance(cell, LayerNormLSTMCell):
        hs, fin = CF.fused_ln_lstm(
            xs, wx, wh, params["ln_gamma"], params["ln_beta"],
            params["lnc_gamma"], params["lnc_beta"], c0, h0,
            cell.forget_bias, masks, seed, keep, residual_dtype, xb)
    elif seq_only and xb is None:
        # encoder: no final carry; xs and the zero carries are not
        # differentiated, so the sequence-only kernel serves
        hs = CF.fused_lstm_seq(xs, wx, params["b"], wh, c0, h0,
                               cell.forget_bias, masks, seed, keep,
                               residual_dtype)
        fin = None
    else:
        raise NotImplementedError(
            "the fused LSTM with a final carry or x_bias (fused_lstm, the "
            "lstm decoder's kernel) comes with the next slice of the "
            "PyTorch port; train the layer_norm decoder")
    if reverse:
        hs = torch.flip(hs, dims=(0,))
    return fin, hs


def run_rnn(cell, params, xs: torch.Tensor, carry0: Optional[Any] = None,
            rdrop_masks: Optional[torch.Tensor] = None,
            reverse: bool = False,
            rdrop_gen: Optional[Tuple[torch.Tensor, float]] = None,
            fused: bool = False, residual_dtype=None,
            x_extra: Optional[torch.Tensor] = None,
            need_final: bool = True) -> Tuple[Any, torch.Tensor]:
    """Step ``cell`` over time-major inputs ``xs [T, B, D]``.

    Returns ``(final_carry, hs [T, B, H])``. ``reverse=True`` runs back
    to front and returns the outputs in the original time order.
    Recurrent dropout: ``rdrop_masks [T, B, H]`` streams masks;
    ``rdrop_gen = (key, keep)`` draws them inside the fused kernels.
    ``x_extra [B, E]``: time-invariant input features (the cell's input
    weight covers ``D + E`` rows); a per-example gate bias on the fused
    path, broadcast and concatenated on the plain one. ``need_final=False``
    declares that only ``hs`` is used and neither ``xs`` nor the (zero)
    carries are differentiated: the fused LSTM then takes the
    sequence-only kernel and returns no final carry.
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
    if rdrop_gen is not None:
        raise NotImplementedError(
            "in-loop recurrent dropout on the plain path (fused_rnn=false "
            "in training, whose scan draws bernoulli masks) comes with a "
            "later slice of the PyTorch port; train with fused_rnn=true")
    if x_extra is not None:
        xs = torch.cat([xs, x_extra[None].expand(xs.shape[0],
                                                 *x_extra.shape)], dim=-1)
    carry = carry0
    order = range(xs.shape[0] - 1, -1, -1) if reverse \
        else range(xs.shape[0])
    hs = [None] * xs.shape[0]
    for t in order:
        m = rdrop_masks[t] if rdrop_masks is not None else None
        carry, hs[t] = cell(params, carry, xs[t], m)
    return carry, torch.stack(hs)


def final_hidden(cell, carry) -> torch.Tensor:
    """The hidden state ``h`` of a cell's ``(c, h)`` carry."""
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
                      fused: bool = False, residual_dtype=None,
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
    kw = dict(fused=fused, residual_dtype=residual_dtype)
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
        last = torch.clamp(seq_len.long() - 1, 0, t - 1)
        onehot = torch.nn.functional.one_hot(last, t).to(hs_f.dtype)
        h_f = torch.einsum("tbh,bt->bh", hs_f, onehot)
        h_b = torch.einsum("tbh,bt->bh", hs_b_rev, onehot)
        hs_b = torch.take_along_dim(hs_b_rev, rev_idx[:, :, None], dim=0)
    return torch.cat([h_f, h_b], dim=-1), torch.cat([hs_f, hs_b], dim=-1)
