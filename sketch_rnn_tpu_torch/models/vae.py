"""The sketch-rnn seq2seq VAE: the parts serving runs.

The port of ``sketch_rnn_tpu/models/vae.py::SketchRNN``: parameters,
the bidirectional encoder, ``sample_z`` with its noise passed in, the
decoder's initial carry (``tanh(z @ W + b)`` over the full carry) and
one autoregressive decoder step. ``decode``, ``_forward`` and the loss
come with the training slice. Parameters are a plain dict of tensors
with the JAX package's names and layouts (``convert.py`` carries them
across).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.ops import linear as L
from sketch_rnn_tpu_torch.ops.cells import make_cell
from sketch_rnn_tpu_torch.ops.rnn import bidirectional_rnn
from sketch_rnn_tpu_torch.utils.device import resolve_device, tree_to

Params = Dict[str, Any]


def _dtype(hps: HParams):
    return {"float32": None, "bfloat16": torch.bfloat16}[hps.compute_dtype]


class SketchRNN:
    """Static model definition; parameters are explicit dicts."""

    def __init__(self, hps: HParams):
        self.hps = hps
        cd = _dtype(hps)
        if hps.conditional:
            self.enc_fwd = make_cell(hps.enc_model, hps.enc_rnn_size, cd)
            self.enc_bwd = make_cell(hps.enc_model, hps.enc_rnn_size, cd)
        self.dec = make_cell(hps.dec_model, hps.dec_rnn_size, cd)
        self.out_dim = 6 * hps.num_mixture + 3

    # -- parameters --------------------------------------------------------

    def init_params(self, gen: torch.Generator, device=None) -> Params:
        """Random parameters drawn on the CPU from ``gen`` (so a seed gives
        the same weights on any device), then moved to ``device`` — the
        card unless ``device="cpu"``."""
        device = resolve_device(device)
        hps = self.hps
        params: Params = {
            "dec": self.dec.init_params(gen, self.decoder_input_size),
            "out_w": L.xavier_uniform(gen, (hps.dec_rnn_size, self.out_dim)),
            "out_b": torch.zeros((self.out_dim,), dtype=torch.float32),
        }
        if hps.conditional:
            params.update({
                "enc_fwd": self.enc_fwd.init_params(gen, 5),
                "enc_bwd": self.enc_bwd.init_params(gen, 5),
                "mu_w": L.xavier_uniform(gen, (2 * hps.enc_rnn_size,
                                               hps.z_size)),
                "mu_b": torch.zeros((hps.z_size,), dtype=torch.float32),
                "presig_w": L.xavier_uniform(gen, (2 * hps.enc_rnn_size,
                                                   hps.z_size)),
                "presig_b": torch.zeros((hps.z_size,), dtype=torch.float32),
                "dec_init_w": L.xavier_uniform(gen, (hps.z_size,
                                                     self.dec.carry_size)),
                "dec_init_b": torch.zeros((self.dec.carry_size,),
                                          dtype=torch.float32),
            })
        if hps.num_classes > 0:
            params["class_embed"] = L.normal_init(
                gen, (hps.num_classes, hps.class_embed_size), 0.05)
        return tree_to(params, device)

    @property
    def decoder_input_size(self) -> int:
        hps = self.hps
        size = 5
        if hps.conditional:
            size += hps.z_size
        if hps.num_classes > 0:
            size += hps.class_embed_size
        return size

    # -- submodules --------------------------------------------------------

    def encode(self, params: Params, x_tm: torch.Tensor,
               seq_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Time-major strokes ``[T, B, 5]`` -> (mu, presig), each [B, Nz]."""
        h_final, _ = bidirectional_rnn(
            self.enc_fwd, self.enc_bwd, params["enc_fwd"],
            params["enc_bwd"], x_tm.float(), seq_len=seq_len)
        cd = _dtype(self.hps)
        mu = L.matmul(h_final, params["mu_w"], cd) + params["mu_b"]
        presig = L.matmul(h_final, params["presig_w"], cd) \
            + params["presig_b"]
        return mu, presig

    @staticmethod
    def sample_z(mu: torch.Tensor, presig: torch.Tensor,
                 eps: torch.Tensor) -> torch.Tensor:
        """Reparameterised ``z = mu + exp(presig / 2) * eps``; the caller
        draws ``eps`` (randomness is an input)."""
        return mu + torch.exp(presig / 2.0) * eps

    def decoder_initial_carry(self, params: Params,
                              z: Optional[torch.Tensor], batch_size: int,
                              device=None):
        if z is None:
            return self.dec.initial_carry(batch_size, device=device)
        flat = torch.tanh(
            L.matmul(z, params["dec_init_w"], _dtype(self.hps))
            + params["dec_init_b"])
        return self.dec.unflatten_carry(flat)

    def _decoder_extra(self, params: Params, z: Optional[torch.Tensor],
                       labels: Optional[torch.Tensor]
                       ) -> Optional[torch.Tensor]:
        """Time-invariant decoder features ``[B, E]``: z, class embedding."""
        parts = []
        if z is not None:
            parts.append(z)
        if self.hps.num_classes > 0:
            if labels is None:
                raise ValueError("num_classes > 0 requires batch labels")
            parts.append(params["class_embed"][labels.long()])
        return torch.cat(parts, dim=-1) if parts else None

    def decode_step(self, params: Params, carry, x_prev: torch.Tensor,
                    z: Optional[torch.Tensor] = None,
                    labels: Optional[torch.Tensor] = None
                    ) -> Tuple[Any, torch.Tensor]:
        """One autoregressive decoder step: previous stroke-5 ``[B, 5]`` ->
        (new carry, raw MDN projection ``[B, 6M+3]``)."""
        extra = self._decoder_extra(params, z, labels)
        inputs = x_prev if extra is None else torch.cat([x_prev, extra], -1)
        carry, h = self.dec(params["dec"], carry, inputs)
        return carry, L.matmul(h, params["out_w"], _dtype(self.hps)) \
            + params["out_b"]
