"""The sketch-rnn seq2seq VAE.

The port of ``sketch_rnn_tpu/models/vae.py::SketchRNN``: parameters,
the bidirectional encoder (with recurrent dropout in training),
``sample_z``, the decoder's initial carry (``tanh(z @ W + b)`` over the
full carry), the teacher-forced decoder with the time-invariant features
(z, class embedding) as a per-example gate bias, one autoregressive
decoder step, and the VAE loss. Parameters are a plain dict of tensors
with the JAX package's names and layouts (``convert.py`` carries them
across).

Randomness derives from one step key exactly as in the JAX package
(``kenc, kz, kdec = split(key, 3)``; the encoder's dropout keys ``split(
kenc)``; the decoder's ``split(kdec, 3)[0]``), with the port's bitwise
threefry (``utils/prng.py``), so the kernels' dropout masks equal the
JAX package's and ``z``'s noise agrees to an ulp.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.ops import linear as L
from sketch_rnn_tpu_torch.ops import mdn
from sketch_rnn_tpu_torch.ops.cells import make_cell
from sketch_rnn_tpu_torch.ops.rnn import (bidirectional_rnn,
                                          length_reverse_indices, run_rnn)
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.device import resolve_device, tree_to

Params = Dict[str, Any]


def _dtype(hps: HParams):
    return {"float32": None, "bfloat16": torch.bfloat16}[hps.compute_dtype]


def _rdtype(hps: HParams):
    """Fused-kernel residual storage dtype (None = float32)."""
    return {"float32": None,
            "bfloat16": torch.bfloat16}[hps.fused_residual_dtype]


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
               seq_len: torch.Tensor, key: Optional[torch.Tensor] = None,
               train: bool = False,
               x_rev_tm: Optional[torch.Tensor] = None,
               fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Time-major strokes ``[T, B, 5]`` -> (mu, presig), each [B, Nz].

        ``train`` with a ``key`` turns on recurrent dropout (keys
        ``split(key)`` for the two directions); ``x_rev_tm``: the
        length-aware-reversed inputs, gathered by the caller; ``fused``
        runs both directions through ``fused_lstm_seq`` (training).
        Serving calls it with neither, on the plain cell path."""
        hps = self.hps
        gen_f = gen_b = None
        if train and hps.use_recurrent_dropout and key is not None:
            kf, kb = prng.split(key, 2).unbind(dim=-2)
            gen_f = (kf, hps.recurrent_dropout_keep)
            gen_b = (kb, hps.recurrent_dropout_keep)
        h_final, _ = bidirectional_rnn(
            self.enc_fwd, self.enc_bwd, params["enc_fwd"],
            params["enc_bwd"], x_tm.float(), seq_len=seq_len,
            rdrop_gen_fwd=gen_f, rdrop_gen_bwd=gen_b, fused=fused,
            residual_dtype=_rdtype(hps),
            xs_rev=None if x_rev_tm is None else x_rev_tm.float())
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

    def decode(self, params: Params, x_in_tm: torch.Tensor,
               z: Optional[torch.Tensor],
               labels: Optional[torch.Tensor] = None,
               key: Optional[torch.Tensor] = None, train: bool = False,
               fused: bool = False) -> torch.Tensor:
        """Teacher-forced decoder -> raw MDN projections ``[T, B, 6M+3]``.
        The time-invariant features (z, class embedding) ride as a
        per-example gate bias on the fused path; recurrent dropout (in
        training, with a key) uses ``split(key, 3)[0]``."""
        hps = self.hps
        b = x_in_tm.shape[1]
        extra = self._decoder_extra(params, z, labels)
        rgen = None
        if train and key is not None:
            if hps.use_input_dropout or hps.use_output_dropout:
                raise NotImplementedError(
                    "input and output dropout come with a later slice of "
                    "the PyTorch port; train with use_input_dropout=false "
                    "and use_output_dropout=false")
            if hps.use_recurrent_dropout:
                krec = prng.split(key, 3)[..., 0, :]
                rgen = (krec, hps.recurrent_dropout_keep)
        carry0 = self.decoder_initial_carry(params, z, b,
                                            device=x_in_tm.device)
        _, hs = run_rnn(self.dec, params["dec"], x_in_tm, carry0,
                        rdrop_gen=rgen, fused=fused,
                        residual_dtype=_rdtype(hps), x_extra=extra)
        return L.matmul(hs, params["out_w"], _dtype(hps)) + params["out_b"]

    # -- loss --------------------------------------------------------------

    def _forward(self, params: Params, batch: Dict[str, torch.Tensor],
                 key: torch.Tensor, train: bool):
        """Batch-major strokes -> mixture params (+ posterior). The
        length-aware reversal for the encoder's backward direction is
        gathered on the batch-major raw strokes, as in the JAX package.
        Returns ``(mp, x_target, labels, mu, presig)``; the posterior
        terms are None for unconditional models."""
        hps = self.hps
        raw_bm = batch["strokes"]
        if raw_bm.dtype == torch.int16:
            raise NotImplementedError(
                "int16-transferred strokes come with a later slice of the "
                "PyTorch port; train with transfer_dtype=float32")
        seq_len = batch["seq_len"]
        raw_rev = None
        if hps.conditional:
            rev_bm = length_reverse_indices(raw_bm.shape[1] - 1, seq_len).T
            raw_rev = torch.take_along_dim(raw_bm[:, 1:],
                                           rev_bm[:, :, None], dim=1)

        def prep(bm):
            return bm.transpose(0, 1).float()

        strokes = prep(raw_bm)                   # [T+1, B, 5]
        x_in, x_target = strokes[:-1], strokes[1:]
        labels = batch.get("labels") if hps.num_classes > 0 else None
        kenc, kz, kdec = prng.split(key, 3).unbind(dim=-2)
        mu = presig = z = None
        if hps.conditional:
            mu, presig = self.encode(params, x_target, seq_len, key=kenc,
                                     train=train, x_rev_tm=prep(raw_rev),
                                     fused=hps.fused_rnn)
            eps = prng.normal(kz, tuple(mu.shape)).to(mu.device)
            z = self.sample_z(mu, presig, eps)
        raw = self.decode(params, x_in, z, labels, key=kdec, train=train,
                          fused=hps.fused_rnn)
        mp = mdn.get_mixture_params(raw, hps.num_mixture)
        return mp, x_target, labels, mu, presig

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             key: torch.Tensor, kl_weight, train: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The VAE loss on a batch of tensors (``strokes [B, Nmax+1, 5]``
        with the start token at t=0, ``seq_len [B]``, ``labels [B]``,
        optional ``weights [B]``); ``kl_weight`` is the annealed weight.
        Returns ``(total, metrics)`` with the JAX package's metric names.
        """
        hps = self.hps
        weights = batch.get("weights")
        mp, x_target, labels, mu, presig = self._forward(
            params, batch, key, train)
        dev = x_target.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        kl_raw = mdn.kl_loss(mu, presig, weights) if hps.conditional \
            else zero
        # canonical asymmetry: pen CE unmasked in training, masked in eval
        offset_nll, pen_ce = mdn.reconstruction_loss(
            mp, x_target, hps.max_seq_len, mask_pen=not train,
            weights=weights)
        r_cost = offset_nll + pen_ce
        kl_w = torch.as_tensor(kl_weight, dtype=torch.float32).to(dev)
        if hps.conditional:
            kl_floored = mdn.kl_cost_with_floor(kl_raw, hps.kl_tolerance)
            total = r_cost + kl_w * kl_floored
        else:
            kl_floored = zero
            total = r_cost
        metrics = {"loss": total, "recon": r_cost, "offset_nll": offset_nll,
                   "pen_ce": pen_ce, "kl": kl_floored, "kl_raw": kl_raw,
                   "kl_weight": kl_w}
        return total, metrics
