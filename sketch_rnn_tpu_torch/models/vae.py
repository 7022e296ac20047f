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
kenc)``; the decoder's ``krec, kin, kout = split(kdec, 3)``), with the
port's bitwise threefry (``utils/prng.py``), so every dropout mask equals
the JAX package's and ``z``'s noise agrees to an ulp.
:meth:`SketchRNN.draws` makes a step's draws from its key (the noise
``eps``, the recurrent dropout seeds, or keys on the plain path, and the
input and output dropout keys ``kin``/``kout``), and the loss takes
either the key or the draws: the train and eval steps draw on the host
and hand the draws to the card in one staged copy
(:meth:`SketchRNN.packed_draws`). The input and output dropout masks
(``[T, B, D + E]`` and ``[T, B, H]``, millions of elements) are too large
for that copy: only their keys travel in it, and :meth:`SketchRNN.decode`
draws the masks from them on the parameters' device with
``prng.bernoulli``, inside the step (no host sync, so a CUDA graph
captures it), as the plain path draws its recurrent masks.
``eval_metrics_per_class`` gives the eval metrics split by class label in
one forward.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.ops import linear as L
from sketch_rnn_tpu_torch.ops import mdn
from sketch_rnn_tpu_torch.ops.cells import make_cell
from sketch_rnn_tpu_torch.ops.rnn import (INT32_MAX, bidirectional_rnn,
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


def _dropout(x: torch.Tensor, key: torch.Tensor, keep: float
             ) -> torch.Tensor:
    """Inverted dropout as the JAX package writes it, ``x * bernoulli(key,
    keep, x.shape) / keep``, bit for bit: the mask drawn on ``x``'s
    device, the division by ``keep`` in ``x``'s dtype (JAX's weakly typed
    Python float)."""
    mask = prng.bernoulli(key.to(x.device), keep, tuple(x.shape))
    return (x * mask) / torch.full((), keep, dtype=x.dtype, device=x.device)


class SketchRNN:
    """Static model definition; parameters are explicit dicts."""

    def __init__(self, hps: HParams):
        self.hps = hps
        cd = _dtype(hps)
        kw = dict(hyper_size=hps.hyper_rnn_size,
                  hyper_embed_size=hps.hyper_embed_size, compute_dtype=cd)
        if hps.conditional:
            self.enc_fwd = make_cell(hps.enc_model, hps.enc_rnn_size, **kw)
            self.enc_bwd = make_cell(hps.enc_model, hps.enc_rnn_size, **kw)
        self.dec = make_cell(hps.dec_model, hps.dec_rnn_size, **kw)
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
               seq_len: torch.Tensor,
               rdrop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               x_rev_tm: Optional[torch.Tensor] = None,
               fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Time-major strokes ``[T, B, 5]`` -> (mu, presig), each [B, Nz].

        ``rdrop``: the two directions' recurrent dropout (:meth:`draws`'s
        ``enc_fwd`` and ``enc_bwd``), None for none; ``x_rev_tm``: the
        length-aware-reversed inputs, gathered by the caller; ``fused``
        runs both directions through ``fused_lstm_seq`` (training and
        the serving encoder at ``fused_rnn=true``), else the plain cell
        path (``fused_rnn=false``, where ``hps.remat`` checkpoints each
        training step; the sampler's ``encode_mu``)."""
        hps = self.hps
        gen_f = gen_b = None
        if rdrop is not None:
            gen_f = (rdrop[0], hps.recurrent_dropout_keep)
            gen_b = (rdrop[1], hps.recurrent_dropout_keep)
        h_final, _ = bidirectional_rnn(
            self.enc_fwd, self.enc_bwd, params["enc_fwd"],
            params["enc_bwd"], x_tm.float(), seq_len=seq_len,
            rdrop_gen_fwd=gen_f, rdrop_gen_bwd=gen_b, remat=hps.remat,
            fused=fused, residual_dtype=_rdtype(hps),
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
               rdrop: Optional[torch.Tensor] = None,
               fused: bool = False, kin: Optional[torch.Tensor] = None,
               kout: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced decoder -> raw MDN projections ``[T, B, 6M+3]``.
        The time-invariant features (z, class embedding) ride as a
        per-example gate bias on the fused path; ``rdrop``: the recurrent
        dropout (:meth:`draws`'s ``dec``), None for none. ``kin``: the
        input dropout's key (:meth:`draws`'s), which makes the decoder's
        input the whole stream ``[x; z; class embedding]`` (``[T, B, D +
        E]``, no gate bias) times ``bernoulli(kin, keep, [T, B, D + E]) /
        keep``; ``kout``: the output dropout's, ``hs`` times
        ``bernoulli(kout, keep, [T, B, H]) / keep``. Both masks are drawn
        on the inputs' device."""
        hps = self.hps
        b = x_in_tm.shape[1]
        extra = self._decoder_extra(params, z, labels)
        inputs = x_in_tm
        if kin is not None:
            if extra is not None:
                t = x_in_tm.shape[0]
                inputs = torch.cat(
                    [x_in_tm, extra[None].expand(t, *extra.shape)], dim=-1)
                extra = None
            inputs = _dropout(inputs, kin, hps.input_dropout_keep)
        rgen = (None if rdrop is None
                else (rdrop, hps.recurrent_dropout_keep))
        carry0 = self.decoder_initial_carry(params, z, b,
                                            device=x_in_tm.device)
        _, hs = run_rnn(self.dec, params["dec"], inputs, carry0,
                        rdrop_gen=rgen, remat=hps.remat, fused=fused,
                        residual_dtype=_rdtype(hps), x_extra=extra)
        if kout is not None:
            hs = _dropout(hs, kout, hps.output_dropout_keep)
        return L.matmul(hs, params["out_w"], _dtype(hps)) + params["out_b"]

    # -- randomness --------------------------------------------------------

    def _draw_layout(self, batch_size: int, train: bool):
        """``(name, shape, dtype)`` of each of :meth:`draws`'s values, in
        :meth:`packed_draws`'s order."""
        hps = self.hps
        out = []
        if hps.conditional:
            out.append(("eps", (batch_size, hps.z_size), torch.float32))
        if train and hps.use_recurrent_dropout:
            shape, dtype = (((), torch.int32) if hps.fused_rnn
                            else ((2,), torch.int64))
            names = (("enc_fwd", "enc_bwd") if hps.conditional else ()) \
                + ("dec",)
            out += [(n, shape, dtype) for n in names]
        if train and hps.use_input_dropout:
            out.append(("kin", (2,), torch.int64))
        if train and hps.use_output_dropout:
            out.append(("kout", (2,), torch.int64))
        return out

    def draws(self, key: torch.Tensor, batch_size: int, train: bool
              ) -> Dict[str, torch.Tensor]:
        """A step's randomness from its key (``[..., 2]``; leading
        dimensions draw for several keys at once), made on the key's
        device as the JAX package draws it from ``kenc, kz, kdec =
        split(key, 3)``: ``eps [..., B, Nz] = normal(kz)`` (conditional
        models) and, in training with recurrent dropout, the encoder's
        ``enc_fwd``, ``enc_bwd`` (``split(kenc)``) and the decoder's
        ``dec`` (``krec``, ``split(kdec, 3)[0]``): the fused kernels'
        dropout seeds ``randint(k, 0, 2**31-1)`` (int32), or on the plain
        path the keys themselves, from which the masks are drawn; with
        input and output dropout, their keys ``kin`` and ``kout``
        (``split(kdec, 3)[1:]``), from which :meth:`decode` draws the
        masks."""
        hps = self.hps
        kenc, kz, kdec = prng.split(key, 3).unbind(dim=-2)
        krec, kin, kout = prng.split(kdec, 3).unbind(dim=-2)
        out = {}
        if hps.conditional:
            out["eps"] = prng.normal(kz, (batch_size, hps.z_size))
        if train and hps.use_input_dropout:
            out["kin"] = kin
        if train and hps.use_output_dropout:
            out["kout"] = kout
        if train and hps.use_recurrent_dropout:
            keys = {"dec": krec}
            if hps.conditional:
                keys["enc_fwd"], keys["enc_bwd"] = prng.split(
                    kenc, 2).unbind(dim=-2)
            for name, k in keys.items():
                out[name] = (prng.randint(k, 0, INT32_MAX) if hps.fused_rnn
                             else k)
        return out

    def packed_draws(self, key: torch.Tensor, batch_size: int,
                     train: bool) -> torch.Tensor:
        """:meth:`draws` as one float32 tensor ``[..., L]`` (the integers
        by their 32-bit patterns), to cross to the card in one copy;
        :meth:`unpack_draws` takes one ``[L]`` row apart."""
        lead = tuple(key.shape[:-1])
        draws = self.draws(key, batch_size, train)
        parts = [torch.zeros(lead + (0,))]
        for name, shape, dtype in self._draw_layout(batch_size, train):
            v = draws[name]
            if dtype == torch.int64:        # uint32 words held in int64
                v = torch.where(v >= 2 ** 31, v - 2 ** 32, v)
            if dtype != torch.float32:
                v = v.to(torch.int32).view(torch.float32)
            parts.append(v.reshape(lead + (-1,)))
        return torch.cat(parts, dim=-1)

    def unpack_draws(self, row: torch.Tensor, batch_size: int,
                     train: bool) -> Dict[str, torch.Tensor]:
        """One step's draws from its packed ``[L]`` row (:meth:`packed_draws`),
        as views of the row where the dtype allows."""
        out, at = {}, 0
        for name, shape, dtype in self._draw_layout(batch_size, train):
            n = math.prod(shape)
            v = row[at:at + n]
            at += n
            if dtype != torch.float32:
                v = v.view(torch.int32)
            if dtype == torch.int64:
                v = v.to(torch.int64) & 0xFFFFFFFF
            out[name] = v.reshape(shape)
        return out

    # -- loss --------------------------------------------------------------

    def _forward(self, params: Params, batch: Dict[str, torch.Tensor],
                 key, train: bool):
        """Batch-major strokes -> mixture params (+ posterior). ``key``:
        the step's key, or its :meth:`draws` already made. The
        length-aware reversal for the encoder's backward direction is
        gathered on the batch-major raw strokes, as in the JAX package;
        then each stream is dequantized (int16 strokes divided by the
        batch's ``transfer_scale``), made time-major and upcast to
        float32 (``data/prefetch.py``'s transfer dtypes).
        Returns ``(mp, x_target, labels, mu, presig)``; the posterior
        terms are None for unconditional models."""
        hps = self.hps
        raw_bm = batch["strokes"]
        seq_len = batch["seq_len"]
        raw_rev = None
        if hps.conditional:
            rev_bm = length_reverse_indices(raw_bm.shape[1] - 1, seq_len).T
            raw_rev = torch.take_along_dim(raw_bm[:, 1:],
                                           rev_bm[:, :, None], dim=1)

        def prep(bm):
            if bm.dtype == torch.int16:
                # integer data units and 0/1 pen bits: the division gives
                # the host's float32 normalization bit for bit for an
                # integer-origin corpus
                sc = batch["transfer_scale"].float()
                f = bm.float()
                bm = torch.cat([f[..., :2] / sc[:, None, None], f[..., 2:]],
                               dim=-1)
            return bm.transpose(0, 1).float()

        strokes = prep(raw_bm)                   # [T+1, B, 5]
        x_in, x_target = strokes[:-1], strokes[1:]
        labels = batch.get("labels") if hps.num_classes > 0 else None
        d = (key if isinstance(key, dict)
             else self.draws(key, raw_bm.shape[0], train))
        mu = presig = z = None
        if hps.conditional:
            enc = ((d["enc_fwd"], d["enc_bwd"]) if "enc_fwd" in d
                   else None)
            mu, presig = self.encode(params, x_target, seq_len, rdrop=enc,
                                     x_rev_tm=prep(raw_rev),
                                     fused=hps.fused_rnn)
            z = self.sample_z(mu, presig, d["eps"].to(mu.device))
        raw = self.decode(params, x_in, z, labels, rdrop=d.get("dec"),
                          fused=hps.fused_rnn, kin=d.get("kin"),
                          kout=d.get("kout"))
        mp = mdn.get_mixture_params(raw, hps.num_mixture)
        return mp, x_target, labels, mu, presig

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             key, kl_weight, train: bool = True, axis_name=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The VAE loss on a batch of tensors (``strokes [B, Nmax+1, 5]``
        with the start token at t=0, ``seq_len [B]``, ``labels [B]``,
        optional ``weights [B]``); ``key``: the step's key or its
        :meth:`draws`; ``kl_weight`` is the annealed weight.
        Returns ``(total, metrics)`` with the JAX package's metric names.

        ``axis_name``: a ``parallel/mesh.Mesh`` when ``batch`` is this
        rank's rows; every scalar is then the global batch's (``ops/
        mdn.py``'s global sums), the free-bits floor taken on the global
        KL, and the gradient of ``total`` is this rank's contribution to
        the global loss's gradient (the step sums them over the ranks).
        """
        hps = self.hps
        weights = batch.get("weights")
        mp, x_target, labels, mu, presig = self._forward(
            params, batch, key, train)
        dev = x_target.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        kl_raw = (mdn.kl_loss(mu, presig, weights, axis_name=axis_name)
                  if hps.conditional else zero)
        # canonical asymmetry: pen CE unmasked in training, masked in eval
        offset_nll, pen_ce = mdn.reconstruction_loss(
            mp, x_target, hps.max_seq_len, mask_pen=not train,
            weights=weights, axis_name=axis_name)
        r_cost = offset_nll + pen_ce
        # a fill, not a host copy, for a float weight: a captured CUDA
        # graph refuses host-to-device copies
        kl_w = (kl_weight.to(dev, torch.float32)
                if isinstance(kl_weight, torch.Tensor) else
                torch.full((), float(kl_weight), dtype=torch.float32,
                           device=dev))
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

    def eval_metrics_per_class(self, params: Params,
                               batch: Dict[str, torch.Tensor],
                               key, axis_name=None
                               ) -> Dict[str, torch.Tensor]:
        """The eval-mode metrics as ``[num_classes]`` vectors in one
        forward, plus ``weight_sum``, each class's count of real
        (weight > 0) rows: per-example sums reduced by a ``[C, B]`` class
        mask. As in eval, no dropout, pen CE masked and KL weight 1, the
        free-bits floor applied to each class's KL mean over this batch;
        a class absent from the batch reports zeros at ``weight_sum`` 0.
        ``axis_name``: a mesh whose data group's class sums (one
        all-reduce of the four ``[C]`` sums) make the global batch's.
        """
        hps = self.hps
        if hps.num_classes <= 0:
            raise ValueError("per-class eval needs num_classes > 0")
        labels = batch["labels"]
        weights = batch.get("weights")
        dev = labels.device
        w = (torch.ones(labels.shape, dtype=torch.float32, device=dev)
             if weights is None else weights.to(torch.float32))
        mp, x_target, _, mu, presig = self._forward(params, batch, key,
                                                    train=False)
        kl_ex = (mdn.kl_per_example(mu, presig) if hps.conditional
                 else torch.zeros(labels.shape, dtype=torch.float32,
                                  device=dev))
        nll_ex, pen_ex = mdn.reconstruction_sums(mp, x_target, mask_pen=True)
        cls = torch.arange(hps.num_classes, device=dev)
        mask = (labels[None, :] == cls[:, None]).to(torch.float32) \
            * w[None, :]                                        # [C, B]
        cnt, nll_c, pen_c, kl_c = mdn._global_sum(torch.stack(
            [mask.sum(dim=-1), mask @ nll_ex, mask @ pen_ex, mask @ kl_ex]),
            axis_name).unbind()
        safe = torch.clamp_min(cnt, 1.0)
        offset_nll = nll_c / (hps.max_seq_len * safe)
        pen_ce = pen_c / (hps.max_seq_len * safe)
        kl_raw = kl_c / safe
        recon = offset_nll + pen_ce
        if hps.conditional:
            kl_floored = mdn.kl_cost_with_floor(kl_raw, hps.kl_tolerance)
            total = recon + kl_floored
        else:
            kl_floored = torch.zeros_like(kl_raw)
            total = recon
        return {"loss": total, "recon": recon, "offset_nll": offset_nll,
                "pen_ce": pen_ce, "kl": kl_floored, "kl_raw": kl_raw,
                "kl_weight": torch.ones_like(cnt), "weight_sum": cnt}
