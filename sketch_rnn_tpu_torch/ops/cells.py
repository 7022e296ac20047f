"""RNN cells as ``(params, carry, x) -> (carry, h)`` step functions.

The port of ``sketch_rnn_tpu/ops/cells.py``: ``LSTMCell``,
``LayerNormLSTMCell`` and ``HyperLSTMCell`` (the layer-norm variant, the
only one ``make_cell`` builds). Cell objects hold only static
configuration; parameters are plain dicts of tensors with the JAX
package's names and layouts (``wx [D, 4H]``, ``wh [H, 4H]``,
``ln_gamma/ln_beta [4, H]``; the HyperLSTM's auxiliary LSTM under the
nested ``"hyper"`` dict). Gate order is ``(i, g, f, o)``; the forget
bias is added to the forget pre-activation, after the layer norm in the
LN variants. Recurrent dropout multiplies the candidate ``g`` after its
``tanh`` by a per-step mask (``rdrop_mask [B, H]``), as the JAX cells
and the fused kernels (``ops/cuda_fused.py``) do.

A carry is ``(c, h)``, or ``((c, h), (hc, hh))`` for the HyperLSTM;
``carry_leaves`` / ``carry_from_leaves`` flatten it to its tensors in
tree-leaf order and back, for code that treats carries generically.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.ops import linear as L

Params = Dict[str, Any]
Carry = Any
Leaves = Tuple[torch.Tensor, ...]


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

    @staticmethod
    def carry_leaves(carry: Carry) -> Leaves:
        return tuple(carry)

    @staticmethod
    def carry_from_leaves(leaves: Leaves) -> Carry:
        c, h = leaves
        return (c, h)

    def __call__(self, params: Params, carry: Carry, x: torch.Tensor,
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        return self.step_pre(params, carry,
                             self.precompute_inputs(params, x), rdrop_mask)

    def precompute_inputs(self, params: Params, xs: torch.Tensor
                          ) -> torch.Tensor:
        """``[..., D] -> [..., 4H]`` input projections ``xs @ wx + b``:
        for a whole sequence, one product outside the recurrence (the
        cuDNN layout of ``run_rnn(hoist=True)`` and ``ops/cuda_lstm.py``)."""
        return L.matmul(xs, params["wx"], self.compute_dtype) + params["b"]

    def step_pre(self, params: Params, carry: Carry, xp: torch.Tensor,
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        """The step from the precomputed input projection ``xp``."""
        c, h = carry
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
    carry_leaves = staticmethod(LSTMCell.carry_leaves)
    carry_from_leaves = staticmethod(LSTMCell.carry_from_leaves)

    def __call__(self, params: Params, carry: Carry, x: torch.Tensor,
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        return self.step_pre(params, carry,
                             self.precompute_inputs(params, x), rdrop_mask)

    def precompute_inputs(self, params: Params, xs: torch.Tensor
                          ) -> torch.Tensor:
        """``[..., D] -> [..., 4H]``, ``xs @ wx``: no bias (the LN betas
        take that role)."""
        return L.matmul(xs, params["wx"], self.compute_dtype)

    def step_pre(self, params: Params, carry: Carry, xp: torch.Tensor,
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        """The step from the precomputed input projection ``xp``."""
        c, h = carry
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


class HyperLSTMCell:
    """HyperNetwork-modulated LSTM with layer-normalised main gates.

    A small auxiliary LSTM reads ``[x; h]`` and emits, per step and per
    gate, multiplicative scale vectors for the input path and the
    recurrent path plus a dynamic bias: ``pre = s_x * (x @ wx) + s_h * (h
    @ wh) + s_b + b``, then the LayerNorm-LSTM gate block. The auxiliary
    LSTM takes no recurrent dropout. Init: the ``hyper_h -> embedding``
    projections start at weight 0 / bias 1 and the ``embedding -> scale``
    projections at ``0.1 / embed_size``, so every scale starts at exactly
    0.1; dynamic biases start at 0.
    """

    def __init__(self, hidden_size: int, hyper_size: int = 256,
                 embed_size: int = 32, forget_bias: float = 1.0,
                 compute_dtype=None):
        self.hidden_size = hidden_size
        self.hyper_size = hyper_size
        self.embed_size = embed_size
        self.forget_bias = forget_bias
        self.compute_dtype = compute_dtype
        self._hyper_cell = LSTMCell(hyper_size, forget_bias,
                                    compute_dtype=compute_dtype)

    def init_params(self, gen: torch.Generator, input_size: int) -> Params:
        h, hh, e = self.hidden_size, self.hyper_size, self.embed_size
        f32 = torch.float32
        return {
            "wx": L.xavier_uniform(gen, (input_size, 4 * h)),
            "wh": L.orthogonal(gen, (h, 4 * h)),
            "b": torch.zeros((4 * h,), dtype=f32),
            "w_hz_x": torch.zeros((hh, 4 * e), dtype=f32),
            "b_hz_x": torch.ones((4 * e,), dtype=f32),
            "w_hz_h": torch.zeros((hh, 4 * e), dtype=f32),
            "b_hz_h": torch.ones((4 * e,), dtype=f32),
            "w_hz_b": L.normal_init(gen, (hh, 4 * e), 0.01),
            "w_zd_x": torch.full((4, e, h), 0.1 / e, dtype=f32),
            "w_zd_h": torch.full((4, e, h), 0.1 / e, dtype=f32),
            "w_zd_b": torch.zeros((4, e, h), dtype=f32),
            "hyper": self._hyper_cell.init_params(gen, input_size + h),
            "ln_gamma": torch.ones((4, h), dtype=f32),
            "ln_beta": torch.zeros((4, h), dtype=f32),
            "lnc_gamma": torch.ones((h,), dtype=f32),
            "lnc_beta": torch.zeros((h,), dtype=f32),
        }

    def initial_carry(self, batch_size: int, device=None) -> Carry:
        z = torch.zeros((batch_size, self.hidden_size),
                        dtype=torch.float32, device=device)
        return ((z, z.clone()),
                self._hyper_cell.initial_carry(batch_size, device=device))

    @property
    def carry_size(self) -> int:
        """Main ``(c, h)`` plus the auxiliary LSTM's ``(c, h)``."""
        return 2 * self.hidden_size + 2 * self.hyper_size

    def unflatten_carry(self, flat: torch.Tensor) -> Carry:
        h, hh = self.hidden_size, self.hyper_size
        c, hm, hc, hyh = torch.split(flat, [h, h, hh, hh], dim=-1)
        return ((c, hm), (hc, hyh))

    @staticmethod
    def carry_leaves(carry: Carry) -> Leaves:
        (c, h), (hc, hh) = carry
        return (c, h, hc, hh)

    @staticmethod
    def carry_from_leaves(leaves: Leaves) -> Carry:
        c, h, hc, hh = leaves
        return ((c, h), (hc, hh))

    def _scales(self, params: Params, hyper_h: torch.Tensor, path: str
                ) -> torch.Tensor:
        """``hyper_h -> [B, 4, H]`` scale (or bias) vectors of one path."""
        z = L.matmul(hyper_h, params[f"w_hz_{path}"], self.compute_dtype)
        if path != "b":
            z = z + params[f"b_hz_{path}"]
        z = z.reshape(z.shape[0], 4, self.embed_size)
        return torch.einsum("bje,jeh->bjh", z, params[f"w_zd_{path}"])

    def __call__(self, params: Params, carry: Carry, x: torch.Tensor,
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        return self.step_pre(params, carry,
                             self.precompute_inputs(params, x), rdrop_mask)

    def precompute_inputs(self, params: Params, xs: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The x-dependent projections of the main and auxiliary cells:
        ``(xs @ wx, xs @ hyper_wx[:D] + hyper_b)``. The auxiliary LSTM
        reads ``[x; h]``; its input weight splits row-wise into this
        x-part and the recurrent h-part of :meth:`step_pre`."""
        wxh = params["hyper"]["wx"]
        d = wxh.shape[0] - self.hidden_size
        return (L.matmul(xs, params["wx"], self.compute_dtype),
                L.matmul(xs, wxh[:d], self.compute_dtype)
                + params["hyper"]["b"])

    def step_pre(self, params: Params, carry: Carry,
                 xp: Tuple[torch.Tensor, torch.Tensor],
                 rdrop_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Carry, torch.Tensor]:
        (c, h), hyper_carry = carry
        xh, hyper_xp = xp
        hsz = self.hidden_size
        wxh = params["hyper"]["wx"]
        d = wxh.shape[0] - hsz
        hyper_pre = hyper_xp + L.matmul(h, wxh[d:], self.compute_dtype)
        hyper_carry, hyper_h = self._hyper_cell.step_pre(
            params["hyper"], hyper_carry, hyper_pre)
        hhp = L.matmul(h, params["wh"], self.compute_dtype)
        b4 = params["b"].reshape(4, hsz)
        sx = self._scales(params, hyper_h, "x")
        sh = self._scales(params, hyper_h, "h")
        sb = self._scales(params, hyper_h, "b")
        pre = sx * xh.reshape(-1, 4, hsz) + sh * hhp.reshape(-1, 4, hsz) \
            + sb + b4
        i, g, f, o = (L.layer_norm(pre[:, j], params["ln_gamma"][j],
                                   params["ln_beta"][j]) for j in range(4))
        g = torch.tanh(g)
        if rdrop_mask is not None:
            g = g * rdrop_mask
        new_c = c * torch.sigmoid(f + self.forget_bias) \
            + torch.sigmoid(i) * g
        normed_c = L.layer_norm(new_c, params["lnc_gamma"],
                                params["lnc_beta"])
        new_h = torch.tanh(normed_c) * torch.sigmoid(o)
        return ((new_c, new_h), hyper_carry), new_h


def make_cell(kind: str, hidden_size: int, hyper_size: int = 256,
              hyper_embed_size: int = 32, compute_dtype=None):
    """Map the ``enc_model``/``dec_model`` hparam to a cell object."""
    if kind == "lstm":
        return LSTMCell(hidden_size, compute_dtype=compute_dtype)
    if kind == "layer_norm":
        return LayerNormLSTMCell(hidden_size, compute_dtype=compute_dtype)
    if kind == "hyper":
        return HyperLSTMCell(hidden_size, hyper_size=hyper_size,
                             embed_size=hyper_embed_size,
                             compute_dtype=compute_dtype)
    raise ValueError(f"unknown cell kind {kind!r}")
