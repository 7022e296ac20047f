"""Recurrence over time and the bidirectional encoder.

The port of ``run_rnn`` (forward only), ``final_hidden``,
``length_reverse_indices`` and ``bidirectional_rnn`` from
``sketch_rnn_tpu/ops/rnn.py``. The time loop is a Python loop of cell
steps: in serving only the endpoint encode phase runs it, and the JAX
package leaves these products to XLA outside any Pallas kernel when
``fused_rnn=false``, so here they are plain ``torch.matmul``. The fused
training kernels (``fused_lstm_seq`` and kin) come with the training
slice.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch


def run_rnn(cell, params, xs: torch.Tensor, carry0: Optional[Any] = None,
            reverse: bool = False) -> Tuple[Any, torch.Tensor]:
    """Step ``cell`` over time-major inputs ``xs [T, B, D]``.

    Returns ``(final_carry, hs [T, B, H])``. ``reverse=True`` runs back
    to front and returns the outputs in the original time order.
    """
    carry = carry0 if carry0 is not None else \
        cell.initial_carry(xs.shape[1], device=xs.device)
    order = range(xs.shape[0] - 1, -1, -1) if reverse \
        else range(xs.shape[0])
    hs = [None] * xs.shape[0]
    for t in order:
        carry, hs[t] = cell(params, carry, xs[t])
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
                      seq_len: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward + backward passes; returns ``(h_final [B, 2H], hs [T, B,
    2H])``. ``h_final`` is the forward pass's state at each sequence's
    last VALID step and the backward pass's state after reading the
    sequence back to front, selected by the same one-hot contraction as
    the JAX package (exact: one term of each sum is the value times 1)."""
    t = xs.shape[0]
    if seq_len is None:
        fwd_carry, hs_f = run_rnn(cell_fwd, params_fwd, xs)
        bwd_carry, hs_b = run_rnn(cell_bwd, params_bwd, xs, reverse=True)
        h_f = final_hidden(cell_fwd, fwd_carry)
        h_b = final_hidden(cell_bwd, bwd_carry)
    else:
        rev_idx = length_reverse_indices(t, seq_len)
        xs_rev = torch.take_along_dim(xs, rev_idx[:, :, None], dim=0)
        _, hs_f = run_rnn(cell_fwd, params_fwd, xs)
        _, hs_b_rev = run_rnn(cell_bwd, params_bwd, xs_rev)
        last = torch.clamp(seq_len.long() - 1, 0, t - 1)
        onehot = torch.nn.functional.one_hot(last, t).to(hs_f.dtype)
        h_f = torch.einsum("tbh,bt->bh", hs_f, onehot)
        h_b = torch.einsum("tbh,bt->bh", hs_b_rev, onehot)
        hs_b = torch.take_along_dim(hs_b_rev, rev_idx[:, :, None], dim=0)
    return torch.cat([h_f, h_b], dim=-1), torch.cat([hs_f, hs_b], dim=-1)
