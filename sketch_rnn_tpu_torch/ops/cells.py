"""RNN cells as ``(params, carry, x) -> (carry, h)`` step functions.

The port of ``sketch_rnn_tpu/ops/cells.py`` for the two cells serving
runs: ``LSTMCell`` and ``LayerNormLSTMCell``. Cell objects hold only
static configuration; parameters are plain dicts of tensors with the
JAX package's names and layouts (``wx [D, 4H]``, ``wh [H, 4H]``,
``ln_gamma/ln_beta [4, H]``). Gate order is ``(i, g, f, o)``; the
forget bias is added to the forget pre-activation, after the layer norm
in the LN variant. Recurrent dropout multiplies the candidate ``g``
after its ``tanh`` by a per-step mask (``rdrop_mask [B, H]``), as the JAX
cells and the fused kernels (``ops/cuda_fused.py``) do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.ops import linear as L

Params = Dict[str, torch.Tensor]
Carry = Tuple[torch.Tensor, torch.Tensor]


class LSTMCell:
    """Vanilla LSTM with orthogonal recurrent init and forget-gate bias."""

    def __init__(self, hidden_size: int, forget_bias: float = 1.0,
                 compute_dtype=None):
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias
        self.compute_dtype = compute_dtype

    def init_params(self, gen: torch.Generator, input_size: int) -> Params:
        h = self.hidden_size
        return {
            "wx": L.xavier_uniform(gen, (input_size, 4 * h)),
            "wh": L.orthogonal(gen, (h, 4 * h)),
            "b": torch.zeros((4 * h,), dtype=torch.float32),
        }

    def initial_carry(self, batch_size: int, device=None) -> Carry:
        z = torch.zeros((batch_size, self.hidden_size),
                        dtype=torch.float32, device=device)
        return (z, z.clone())

    @property
    def carry_size(self) -> int:
        """Flat width of the carry, for z -> initial-state projections."""
        return 2 * self.hidden_size

    def unflatten_carry(self, flat: torch.Tensor) -> Carry:
        c, h = torch.chunk(flat, 2, dim=-1)
        return (c, h)

    def __call__(self, params: Params, carry: Carry, x: torch.Tensor,
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        xp = L.matmul(x, params["wx"], self.compute_dtype) + params["b"]
        pre = xp + L.matmul(h, params["wh"], self.compute_dtype)
        i, g, f, o = torch.chunk(pre, 4, dim=-1)
        g = torch.tanh(g)
        if rdrop_mask is not None:
            g = g * rdrop_mask
        new_c = c * torch.sigmoid(f + self.forget_bias) \
            + torch.sigmoid(i) * g
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        return (new_c, new_h), new_h


class LayerNormLSTMCell:
    """LSTM with per-gate layer norm and a norm on the cell state; the
    linear layers carry no bias (the LN betas take that role)."""

    def __init__(self, hidden_size: int, forget_bias: float = 1.0,
                 compute_dtype=None):
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias
        self.compute_dtype = compute_dtype

    def init_params(self, gen: torch.Generator, input_size: int) -> Params:
        h = self.hidden_size
        return {
            "wx": L.xavier_uniform(gen, (input_size, 4 * h)),
            "wh": L.orthogonal(gen, (h, 4 * h)),
            "ln_gamma": torch.ones((4, h), dtype=torch.float32),
            "ln_beta": torch.zeros((4, h), dtype=torch.float32),
            "lnc_gamma": torch.ones((h,), dtype=torch.float32),
            "lnc_beta": torch.zeros((h,), dtype=torch.float32),
        }

    initial_carry = LSTMCell.initial_carry
    carry_size = LSTMCell.carry_size
    unflatten_carry = LSTMCell.unflatten_carry

    def __call__(self, params: Params, carry: Carry, x: torch.Tensor,
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        xp = L.matmul(x, params["wx"], self.compute_dtype)
        pre = xp + L.matmul(h, params["wh"], self.compute_dtype)
        i, g, f, o = (L.layer_norm(gate, params["ln_gamma"][j],
                                   params["ln_beta"][j])
                      for j, gate in enumerate(torch.chunk(pre, 4, dim=-1)))
        g = torch.tanh(g)
        if rdrop_mask is not None:
            g = g * rdrop_mask
        new_c = c * torch.sigmoid(f + self.forget_bias) \
            + torch.sigmoid(i) * g
        normed_c = L.layer_norm(new_c, params["lnc_gamma"],
                                params["lnc_beta"])
        new_h = torch.tanh(normed_c) * torch.sigmoid(o)
        return (new_c, new_h), new_h


def make_cell(kind: str, hidden_size: int, compute_dtype=None):
    """Map the ``enc_model``/``dec_model`` hparam to a cell object."""
    if kind == "lstm":
        return LSTMCell(hidden_size, compute_dtype=compute_dtype)
    if kind == "layer_norm":
        return LayerNormLSTMCell(hidden_size, compute_dtype=compute_dtype)
    if kind == "hyper":
        raise NotImplementedError(
            "the HyperLSTM cell is not ported yet: it comes with a later "
            "slice of the PyTorch port (with its fused_hyper_lstm kernel); "
            "serve the lstm or layer_norm cells")
    raise ValueError(f"unknown cell kind {kind!r}")
