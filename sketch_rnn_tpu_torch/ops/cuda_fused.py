"""The training kernels: the encoder's and the decoder's recurrences.

The port of the four kernel families of ``sketch_rnn_tpu/ops/pallas_fused.py``
that training runs. Eight hand-written CUDA kernels (``csrc/fused_rnn.cu``,
``csrc/fused_hyper.cu``) replace eight Pallas kernels:

- :func:`fused_lstm_seq` (the bi-LSTM encoder, each direction): the
  forward replaces ``pallas_fused._lstm_seq_fwd_kernel``, the backward
  ``pallas_fused._lstm_seq_bwd_kernel``. It returns ``hs`` only, and its
  backward defines the ``xs``, ``c0`` and ``h0`` gradients as ZERO (the
  encoder's contract: the strokes are data, the carries constant zeros),
  exactly as the JAX package's custom VJP does.
- :func:`fused_lstm` (the ``lstm`` decoder, and any LSTM with a final
  carry or ``x_bias``): the forward replaces
  ``pallas_fused._lstm_fwd_kernel``, the backward
  ``pallas_fused._lstm_bwd_kernel``, with every input's gradient.
- :func:`fused_ln_lstm` (the LayerNorm-LSTM decoder): the forward
  replaces ``pallas_fused._lnlstm_fwd_kernel``, the backward
  ``pallas_fused._lnlstm_bwd_kernel``, with the per-example gate bias
  ``x_bias`` and every input's gradient.
- :func:`fused_hyper_lstm` (the HyperLSTM, layer-norm variant): the
  forward replaces ``pallas_fused._hyper_fwd_kernel``, the backward
  ``pallas_fused._hyper_bwd_kernel``: an auxiliary LSTM over ``[x; h]``,
  the ``hyper_h -> z -> s`` projections, the scaled pre-activation ``s_x
  * (x @ wx + x_bias) + s_h * (h @ wh) + s_b + b``, the LayerNorm-LSTM
  gate block, four carry streams, two per-example biases and the
  gradient of every input (nineteen parameters among them). Its
  weights travel as one :class:`HyperWeights`.

All keep the Pallas kernels' memory contract: no ``[T, B, 4H]`` gate
buffer and no mask buffer exist in the forward; it saves only ``hs`` and
the pre-step cell states ``cs``, and the backward recomputes the gates
from ``(x, h_prev, c_prev)`` walking time backwards (the LSTM and
LayerNorm-LSTM backwards hoist that recompute out of their loops, into
the ``d_pre`` scratch they then overwrite, the latter its layer-norm
statistics too; the forwards' blocks exchange ``h`` through a ``[2, B,
H]`` scratch, the LayerNorm-LSTM's also its layer norms' row moments;
a batch whose tiles do not fit in shared memory runs as several launches
over windows of rows: ``csrc/fused_rnn.cu``'s header). Recurrent dropout on
the candidate ``g`` is either streamed ``masks [T, B, H]`` or drawn in
the kernel from ``dropout_seed`` by :func:`prng_mask`, whose counter does
not depend on any tiling, so the CUDA kernels reproduce the JAX package's
masks bit for bit.

Mixed precision follows the Pallas contract (``pallas_fused.py``'s
module docstring and ``_cast``): ``wx``/``wh`` arrive pre-cast (float32
or bfloat16); each product rounds its activation operand to the weight
dtype and accumulates in float32; ``b``, the LN parameters and
``x_bias`` stay float32. ``residual_dtype`` (float32 or bfloat16) is the
storage dtype of ``hs`` and ``cs``; the recurrence itself reads the
unrounded float32 carry. The backward recomputes from the STORED ``hs``
and ``cs`` (step 0 from ``h0`` rounded to ``hs``'s dtype), rounds
``d_pre`` to the weight dtype for the transposed products and the
weight-gradient sums, and takes ``db``, ``dx_bias`` and the LN-parameter
sums from the unrounded ``d_pre``. Gradients come back in the primals'
dtypes: bfloat16 ``dwx``/``dwh`` are float32 sums rounded once.

Beside each kernel pair are its plain PyTorch versions: a forward and a
backward written step by step (the backward mirrors
``_lstm_step_bwd_math`` and ``_ln_lstm_bwd_gates``; it does not run
autograd of the forward). Each kernel has one wrapper with its plain
version's signature (``lstm_seq_fwd``, ``lstm_seq_bwd``, ``lstm_fwd``,
``lstm_bwd``, ``ln_lstm_fwd``, ``ln_lstm_bwd``, ``hyper_lstm_fwd``,
``hyper_lstm_bwd``): the plain version for
CPU tensors, for CUDA tensors the kernel or a raise. The public functions
are ``torch.autograd.Function``s over those wrappers. The ``*_launches``
counters count kernel launches only (one per wrapper call, whatever the
number of CUDA kernels inside), never plain-version calls.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.ops.cuda_decode import _require

_MASK = 0xFFFFFFFF
_LN_EPS = 1e-6
MAX_HIDDEN = 512    # one thread per hidden unit, 512 threads per block
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
RESIDUAL_DTYPES = (torch.float32, torch.bfloat16)

_KERNELS = ("fused_lstm_seq_fwd", "fused_lstm_seq_bwd", "fused_lstm_fwd",
            "fused_lstm_bwd", "fused_ln_lstm_fwd", "fused_ln_lstm_bwd",
            "fused_hyper_lstm_fwd", "fused_hyper_lstm_bwd")
_launches = dict.fromkeys(_KERNELS, 0)
# the fleet's replicas launch the encoder from their own worker threads
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> dict:
    return dict(_launches)


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` to the counters: a CUDA graph's replay adds the
    launches its capture recorded (``train/graph.py``)."""
    with _count_lock:
        for k, v in counts.items():
            _launches[k] += v


# -- the in-kernel dropout mask ---------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values held in int64, split so no
    intermediate leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def hash32(x: torch.Tensor) -> torch.Tensor:
    """``pallas_fused._hash32`` (a murmur3-style avalanche over uint32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def prng_mask(seed, t: int, b: int, h: int, keep: float) -> torch.Tensor:
    """Recurrent-dropout mask ``[B, H]`` of step ``t``, bitwise
    ``pallas_fused._prng_mask``: element ``(row, col)`` hashes the counter
    ``seed * 2654435761 + (t * B + row) * H + col (mod 2**32)``; the top
    24 bits give ``u = (bits >> 8) * 2**-24`` and the mask is ``(u < keep)
    * float32(1 / keep)``. ``seed``: int or int32 tensor (any device)."""
    seed = torch.as_tensor(seed).to(torch.int64).reshape(())
    dev = seed.device
    base = (_mul32(seed & _MASK, 2654435761) + (t * b) * h) & _MASK
    idx = torch.arange(b * h, dtype=torch.int64, device=dev).reshape(b, h)
    bits = hash32((base + idx) & _MASK)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    inv = torch.tensor(np.float32(1.0 / keep), device=dev)
    return (u < np.float32(keep)).to(torch.float32) * inv


def _step_mask(masks, seed, t, b, h, keep):
    if masks is not None:
        return masks[t]
    if seed is not None:
        return prng_mask(seed, t, b, h, keep)
    return None


def _check_args(wx, wh, masks, seed, residual_dtype):
    """What every public function refuses on any device: both dropout
    forms at once, weights outside float32/bfloat16 or of two dtypes,
    a residual dtype outside float32/bfloat16."""
    if masks is not None and seed is not None:
        raise ValueError("pass masks or dropout_seed, not both")
    if wx.dtype not in WEIGHT_DTYPES or wh.dtype != wx.dtype:
        raise TypeError(f"wx/wh have dtypes {wx.dtype}/{wh.dtype}: the "
                        f"fused RNN kernels take both in one of "
                        f"{WEIGHT_DTYPES}")
    _residual(residual_dtype)


# -- mixed precision --------------------------------------------------------


def _rnd(x, dtype):
    """``x`` rounded to ``dtype``'s precision when that is bfloat16 (the
    Pallas ``_cast`` of an activation operand), held in float32."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def _wide(w):
    """A weight as the accumulation dtype sees it (bfloat16 -> float32,
    exactly; float32 and float64 as they are)."""
    return w.float() if w.dtype == torch.bfloat16 else w


def _acc_dtype(w):
    return torch.float32 if w.dtype == torch.bfloat16 else w.dtype


def _mm(a, w, wide):
    """``a @ w`` as the Pallas kernels compute it: ``a`` rounded to the
    weight dtype, products accumulated in float32 (``wide`` is ``w``
    widened once per call)."""
    return _rnd(a, w.dtype) @ wide


def _store(x, residual_dtype):
    return x if residual_dtype is None else x.to(residual_dtype)


# -- plain PyTorch versions: forward ----------------------------------------


def _lstm_gates(pre, c_prev, m, forget_bias):
    h = c_prev.shape[-1]
    i = torch.sigmoid(pre[:, :h])
    g_u = torch.tanh(pre[:, h:2 * h])
    g = g_u * m if m is not None else g_u
    f = torch.sigmoid(pre[:, 2 * h:3 * h] + forget_bias)
    o = torch.sigmoid(pre[:, 3 * h:])
    return i, g_u, f, o, c_prev * f + i * g


def _ln_fwd(u, gamma, beta):
    """Row layer norm; returns ``(y, xhat, r)``."""
    mu = u.mean(dim=-1, keepdim=True)
    xc = u - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + _LN_EPS)
    xhat = xc * r
    return xhat * gamma + beta, xhat, r


def _ln_bwd_input(dy, gamma, xhat, r):
    dxhat = dy * gamma
    return r * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))


def _ln_gates(pre, c_prev, m, gam, bet, gc, bc, forget_bias):
    """LayerNorm-LSTM gate block; returns every residual the backward
    needs: ``(i, g_u, f, o, new_c, new_h, yc, xhat_c, r_c, xhats, rs)``."""
    h = c_prev.shape[-1]
    ys, xhats, rs = [], [], []
    for j in range(4):
        y, xhat, r = _ln_fwd(pre[:, j * h:(j + 1) * h], gam[j], bet[j])
        ys.append(y)
        xhats.append(xhat)
        rs.append(r)
    i = torch.sigmoid(ys[0])
    g_u = torch.tanh(ys[1])
    g = g_u * m if m is not None else g_u
    f = torch.sigmoid(ys[2] + forget_bias)
    o = torch.sigmoid(ys[3])
    new_c = c_prev * f + i * g
    yc, xhat_c, r_c = _ln_fwd(new_c, gc, bc)
    new_h = torch.tanh(yc) * o
    return i, g_u, f, o, new_c, new_h, yc, xhat_c, r_c, xhats, rs


class _Weights:
    """``wx``/``wh`` with their float32 views, widened once per call."""

    def __init__(self, wx, wh):
        self.wx, self.wh = wx, wh
        self.wxf, self.whf = _wide(wx), _wide(wh)

    def lstm_pre(self, x, h_prev, b, xb):
        """``((x @ wx + b) + h @ wh) [+ xb]``, the Pallas association."""
        pre = _mm(x, self.wx, self.wxf) + b + _mm(h_prev, self.wh, self.whf)
        return pre + xb if xb is not None else pre

    def ln_pre(self, x, h_prev, xb):
        """``(x @ wx + h @ wh) [+ xb]``."""
        pre = _mm(x, self.wx, self.wxf) + _mm(h_prev, self.wh, self.whf)
        return pre + xb if xb is not None else pre


def lstm_fwd_reference(xs, wx, b, wh, c0, h0, forget_bias=1.0, masks=None,
                       dropout_seed=None, keep_prob=1.0, x_bias=None,
                       residual_dtype=None):
    """The plain forward of :func:`fused_lstm` (and, without ``x_bias``
    and the final carry, of :func:`fused_lstm_seq`): ``(hs, cs, cT,
    hT)``, ``cs`` being the pre-step cell states the backward reads,
    ``hs``/``cs`` in ``residual_dtype``, the final carry float32."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    w = _Weights(wx, wh)
    c, hh = c0, h0
    hs, cs = [], []
    for t in range(t_len):
        pre = w.lstm_pre(xs[t], hh, b, x_bias)
        m = _step_mask(masks, dropout_seed, t, bsz, h, keep_prob)
        _, _, _, o, new_c = _lstm_gates(pre, c, m, forget_bias)
        cs.append(_store(c, residual_dtype))
        c, hh = new_c, torch.tanh(new_c) * o
        hs.append(_store(hh, residual_dtype))
    return torch.stack(hs), torch.stack(cs), c, hh


def lstm_seq_fwd_reference(xs, wx, b, wh, c0, h0, forget_bias=1.0,
                           masks=None, dropout_seed=None, keep_prob=1.0,
                           residual_dtype=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward of :func:`fused_lstm_seq`: ``(hs, cs)``."""
    return lstm_fwd_reference(xs, wx, b, wh, c0, h0, forget_bias, masks,
                              dropout_seed, keep_prob, None,
                              residual_dtype)[:2]


def ln_lstm_fwd_reference(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma,
                          lnc_beta, c0, h0, forget_bias=1.0, masks=None,
                          dropout_seed=None, keep_prob=1.0, x_bias=None,
                          residual_dtype=None):
    """The plain forward of :func:`fused_ln_lstm`: ``(hs, cs, cT, hT)``."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    w = _Weights(wx, wh)
    c, hh = c0, h0
    hs, cs = [], []
    for t in range(t_len):
        pre = w.ln_pre(xs[t], hh, x_bias)
        m = _step_mask(masks, dropout_seed, t, bsz, h, keep_prob)
        res = _ln_gates(pre, c, m, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
                        forget_bias)
        cs.append(_store(c, residual_dtype))
        c, hh = res[4], res[5]
        hs.append(_store(hh, residual_dtype))
    return torch.stack(hs), torch.stack(cs), c, hh


class HyperWeights(NamedTuple):
    """The HyperLSTM's parameters as ``fused_hyper_lstm`` takes them (and,
    from the backward, their gradients in the same slots).

    ``wx [D, 4H]``, ``b [4H]``, ``wh [H, 4H]``: the main gates. ``wxh_x
    [D, 4HH]``, ``wxh_h [H, 4HH]``, ``bh [4HH]``, ``whh [HH, 4HH]``: the
    auxiliary LSTM over ``[x; h]`` (its input weight split row-wise) and
    its recurrent weight. ``w_hz_p [HH, 4e]`` (``b_hz_p [4e]`` for p in
    x, h): ``hyper_h`` to the per-gate embeddings. ``zd_p [4, e, H]``: the
    per-gate embedding-to-scale blocks. ``ln_gamma/ln_beta [4, H]``,
    ``lnc_gamma/lnc_beta [H]``. The matrices ``wx, wh, wxh_x, wxh_h,
    whh, w_hz_*`` share one dtype (float32 or pre-cast bfloat16);
    everything else is float32."""

    wx: torch.Tensor
    b: torch.Tensor
    wh: torch.Tensor
    wxh_x: torch.Tensor
    wxh_h: torch.Tensor
    bh: torch.Tensor
    whh: torch.Tensor
    w_hz_x: torch.Tensor
    b_hz_x: torch.Tensor
    w_hz_h: torch.Tensor
    b_hz_h: torch.Tensor
    w_hz_b: torch.Tensor
    zd_x: torch.Tensor
    zd_h: torch.Tensor
    zd_b: torch.Tensor
    ln_gamma: torch.Tensor
    ln_beta: torch.Tensor
    lnc_gamma: torch.Tensor
    lnc_beta: torch.Tensor


# the slots of HyperWeights that hold matrices of the weight dtype
HYPER_MATRICES = ("wx", "wh", "wxh_x", "wxh_h", "whh", "w_hz_x", "w_hz_h",
                  "w_hz_b")


def _block_scale(z, zd):
    """``[B, 4e] x [4, e, H] -> [B, 4H]``: each gate's embedding slice
    times its own block (``pallas_fused._block_scale``)."""
    e = zd.shape[1]
    return torch.cat([z[:, j * e:(j + 1) * e] @ zd[j] for j in range(4)],
                     dim=-1)


def _block_unscale(ds, zd):
    """The backward of :func:`_block_scale` w.r.t. ``z``."""
    h = zd.shape[2]
    return torch.cat([ds[:, j * h:(j + 1) * h] @ zd[j].T for j in range(4)],
                     dim=-1)


def _block_scale_grad(z, ds, zd):
    """``[4, e, H]``: ``z_j^T @ ds_j`` per gate."""
    e, h = zd.shape[1], zd.shape[2]
    return torch.stack([z[:, j * e:(j + 1) * e].T @ ds[:, j * h:(j + 1) * h]
                        for j in range(4)])


class _HyperStep:
    """One HyperLSTM step from ``(x, carries)``, shared by the plain
    forward and backward (``pallas_fused._hyper_recompute``)."""

    def __init__(self, w: HyperWeights, forget_bias, xb, xbh):
        self.w = w
        self.wide = {n: _wide(getattr(w, n)) for n in HYPER_MATRICES}
        self.forget_bias, self.xb, self.xbh = forget_bias, xb, xbh

    def mm(self, a, name):
        return _mm(a, getattr(self.w, name), self.wide[name])

    def __call__(self, x, h, c, hc, hh, m):
        w = self.w
        hyper_pre = (self.mm(x, "wxh_x") + self.mm(h, "wxh_h") + w.bh
                     + self.mm(hh, "whh"))
        if self.xbh is not None:
            hyper_pre = hyper_pre + self.xbh
        hi, hg, hf, ho, new_hc = _lstm_gates(hyper_pre, hc, None,
                                             self.forget_bias)
        new_hh = torch.tanh(new_hc) * ho
        xp = self.mm(x, "wx")
        if self.xb is not None:
            xp = xp + self.xb
        hp = self.mm(h, "wh")
        zx = self.mm(new_hh, "w_hz_x") + w.b_hz_x
        zh = self.mm(new_hh, "w_hz_h") + w.b_hz_h
        zb = self.mm(new_hh, "w_hz_b")
        sx = _block_scale(zx, w.zd_x)
        sh = _block_scale(zh, w.zd_h)
        sb = _block_scale(zb, w.zd_b)
        pre = sx * xp + sh * hp + sb + w.b
        ln = _ln_gates(pre, c, m, w.ln_gamma, w.ln_beta, w.lnc_gamma,
                       w.lnc_beta, self.forget_bias)
        return ln, (hi, hg, hf, ho, new_hc, new_hh, xp, hp, zx, zh, zb, sx,
                    sh)


def _check_bias_pair(x_bias, x_bias_hyper):
    if (x_bias is None) != (x_bias_hyper is None):
        raise ValueError("pass both x_bias and x_bias_hyper or neither")


def hyper_lstm_fwd_reference(xs, w: HyperWeights, c0, h0, hc0, hh0,
                             forget_bias=1.0, masks=None, dropout_seed=None,
                             keep_prob=1.0, x_bias=None, x_bias_hyper=None,
                             residual_dtype=None):
    """The plain forward of :func:`fused_hyper_lstm`: ``(hs, cs, hycs,
    hyhs, cT, hT, hcT, hhT)``. ``cs``/``hycs`` are the PRE-step main and
    auxiliary cell states, ``hs``/``hyhs`` the post-step hidden states,
    all in ``residual_dtype``; the final carries are float32. Dropout
    masks the main candidate only, with the main ``H`` in its counter."""
    _check_bias_pair(x_bias, x_bias_hyper)
    t_len, bsz, _ = xs.shape
    h = w.wh.shape[0]
    step = _HyperStep(w, forget_bias, x_bias, x_bias_hyper)
    c, hm, hc, hh = c0, h0, hc0, hh0
    hs, cs, hycs, hyhs = [], [], [], []
    for t in range(t_len):
        m = _step_mask(masks, dropout_seed, t, bsz, h, keep_prob)
        ln, aux = step(xs[t], hm, c, hc, hh, m)
        cs.append(_store(c, residual_dtype))
        hycs.append(_store(hc, residual_dtype))
        c, hm, hc, hh = ln[4], ln[5], aux[4], aux[5]
        hs.append(_store(hm, residual_dtype))
        hyhs.append(_store(hh, residual_dtype))
    return (torch.stack(hs), torch.stack(cs), torch.stack(hycs),
            torch.stack(hyhs), c, hm, hc, hh)


# -- plain PyTorch versions: backward ---------------------------------------


class _BwdStep:
    """What every backward step shares: the recompute operands read from
    the stored residuals, and the products of ``d_pre`` (rounded to the
    weight dtype) into the transposed and weight-gradient sums."""

    def __init__(self, xs, wx, wh, h0, hs, cs, dhs):
        self.xs, self.hs, self.cs, self.dhs = xs, hs, cs, dhs
        self.w = _Weights(wx, wh)
        self.h00 = h0.to(hs.dtype)      # pallas_fused._prev_block
        acc = _acc_dtype(wx)
        self.dwx = torch.zeros(wx.shape, dtype=acc, device=wx.device)
        self.dwh = torch.zeros(wh.shape, dtype=acc, device=wh.device)

    def operands(self, s, dh):
        """``(x, h_prev, c_prev, dh + dhs[s])`` at step ``s``."""
        h_prev = self.hs[s - 1] if s > 0 else self.h00
        return (self.xs[s], h_prev.to(dh.dtype), self.cs[s].to(dh.dtype),
                dh + self.dhs[s].to(dh.dtype))

    def products(self, x, h_prev, d_pre, want_dx):
        """Accumulate ``dwx``/``dwh``; return ``(dx or None, dh_prev)``."""
        w = self.w
        dpc = _rnd(d_pre, w.wx.dtype)
        dx = dpc @ w.wxf.T if want_dx else None
        self.dwx += _rnd(x, w.wx.dtype).T @ dpc
        dh = dpc @ w.whf.T
        self.dwh += _rnd(h_prev, w.wh.dtype).T @ dpc
        return dx, dh

    def weight_grads(self):
        return self.dwx.to(self.w.wx.dtype), self.dwh.to(self.w.wh.dtype)


def lstm_bwd_reference(xs, wx, b, wh, h0, hs, cs, dhs, dcT=None, dhT=None,
                       forget_bias=1.0, masks=None, dropout_seed=None,
                       keep_prob=1.0, x_bias=None):
    """The plain backward of :func:`fused_lstm`, step by step
    (``pallas_fused._lstm_step_bwd_math``): recompute each step's gates
    from ``(x, h_prev, c_prev)``, walk time backwards from the final
    carry's cotangents (zero when None). Returns ``(dxs, dxb, dwx, db,
    dwh, dc0, dh0)``; ``dxb`` is None without ``x_bias``."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    st = _BwdStep(xs, wx, wh, h0, hs, cs, dhs)
    acc = _acc_dtype(wx)
    dxs = torch.empty(xs.shape, dtype=acc, device=xs.device)
    dxb = torch.zeros_like(x_bias) if x_bias is not None else None
    db = torch.zeros(b.shape, dtype=acc, device=b.device)
    zero = torch.zeros((bsz, h), dtype=acc, device=xs.device)
    dc = dcT if dcT is not None else zero
    dh = dhT if dhT is not None else zero
    for s in range(t_len - 1, -1, -1):
        x, h_prev, c_prev, dh = st.operands(s, dh)
        m = _step_mask(masks, dropout_seed, s, bsz, h, keep_prob)
        pre = st.w.lstm_pre(x, h_prev, b, x_bias)
        i, g_u, f, o, new_c = _lstm_gates(pre, c_prev, m, forget_bias)
        tanh_c = torch.tanh(new_c)
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        do = dh * tanh_c
        df = dc * c_prev
        g = g_u * m if m is not None else g_u
        di = dc * g
        dg_u = dc * i * m if m is not None else dc * i
        d_pre = torch.cat([di * i * (1.0 - i), dg_u * (1.0 - g_u * g_u),
                           df * f * (1.0 - f), do * o * (1.0 - o)], dim=-1)
        if dxb is not None:
            dxb += d_pre
        db += d_pre.sum(dim=0)
        dxs[s], dh = st.products(x, h_prev, d_pre, True)
        dc = dc * f
    dwx, dwh = st.weight_grads()
    return dxs.to(xs.dtype), dxb, dwx, db, dwh, dc, dh


def lstm_seq_bwd_reference(xs, wx, b, wh, h0, hs, cs, dhs, forget_bias=1.0,
                           masks=None, dropout_seed=None, keep_prob=1.0):
    """The plain backward of :func:`fused_lstm_seq`: zero carry
    cotangents at the end; returns ``(dwx, db, dwh)``."""
    _, _, dwx, db, dwh, _, _ = lstm_bwd_reference(
        xs, wx, b, wh, h0, hs, cs, dhs, None, None, forget_bias, masks,
        dropout_seed, keep_prob)
    return dwx, db, dwh


def ln_lstm_bwd_reference(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma,
                          lnc_beta, h0, hs, cs, dhs, dcT, dhT,
                          forget_bias=1.0, masks=None, dropout_seed=None,
                          keep_prob=1.0, x_bias=None, f32_weight_grads=False):
    """The plain backward of :func:`fused_ln_lstm`, step by step
    (``pallas_fused._ln_lstm_bwd_gates``). Returns ``(dxs, dxb, dwx, dwh,
    dgam, dbet, dgc, dbc, dc0, dh0)``; ``dxb`` is None without
    ``x_bias``. ``dwx``/``dwh`` come back in the weights' dtype, or as
    their float32 sums with ``f32_weight_grads``."""
    t_len, bsz, _ = xs.shape
    h = wh.shape[0]
    st = _BwdStep(xs, wx, wh, h0, hs, cs, dhs)
    dxs = torch.empty(xs.shape, dtype=_acc_dtype(wx), device=xs.device)
    dxb = torch.zeros_like(x_bias) if x_bias is not None else None
    dgam = torch.zeros_like(ln_gamma)
    dbet = torch.zeros_like(ln_beta)
    dgc = torch.zeros_like(lnc_gamma)
    dbc = torch.zeros_like(lnc_beta)
    dc, dh = dcT, dhT
    for s in range(t_len - 1, -1, -1):
        x, h_prev, c_prev, dh = st.operands(s, dh)
        pre = st.w.ln_pre(x, h_prev, x_bias)
        m = _step_mask(masks, dropout_seed, s, bsz, h, keep_prob)
        (i, g_u, f, o, _, _, yc, xhat_c, r_c, xhats, rs) = _ln_gates(
            pre, c_prev, m, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
            forget_bias)
        tanh_yc = torch.tanh(yc)
        do = dh * tanh_yc
        dyc = dh * o * (1.0 - tanh_yc * tanh_yc)
        dgc += (dyc * xhat_c).sum(dim=0)
        dbc += dyc.sum(dim=0)
        dc = dc + _ln_bwd_input(dyc, lnc_gamma, xhat_c, r_c)
        df = dc * c_prev
        g = g_u * m if m is not None else g_u
        di = dc * g
        dg_u = dc * i * m if m is not None else dc * i
        dys = [di * i * (1.0 - i), dg_u * (1.0 - g_u * g_u),
               df * f * (1.0 - f), do * o * (1.0 - o)]
        parts = []
        for j in range(4):
            dgam[j] += (dys[j] * xhats[j]).sum(dim=0)
            dbet[j] += dys[j].sum(dim=0)
            parts.append(_ln_bwd_input(dys[j], ln_gamma[j], xhats[j], rs[j]))
        d_pre = torch.cat(parts, dim=-1)
        if dxb is not None:
            dxb += d_pre
        dxs[s], dh = st.products(x, h_prev, d_pre, True)
        dc = dc * f
    dwx, dwh = (st.dwx, st.dwh) if f32_weight_grads else st.weight_grads()
    return (dxs.to(xs.dtype), dxb, dwx, dwh, dgam, dbet, dgc, dbc, dc, dh)


def hyper_lstm_bwd_reference(xs, w: HyperWeights, h0, hh0, hs, cs, hycs,
                             hyhs, dhs, dcT, dhT, dhcT, dhhT,
                             forget_bias=1.0, masks=None, dropout_seed=None,
                             keep_prob=1.0, x_bias=None, x_bias_hyper=None):
    """The plain backward of :func:`fused_hyper_lstm`, step by step
    (``pallas_fused._hyper_bwd_kernel``): recompute each step from the
    stored residuals (``h0``/``hh0`` rounded to their dtype at step 0),
    back through the LayerNorm-LSTM gate block, the scaling, the block
    and ``z`` projections and the auxiliary LSTM. ``x_bias`` sits inside
    the scaling, so its gradient sums ``d_pre * s_x``. Operands of
    products with a bfloat16 matrix are rounded to it; the ``zd_*``
    products, every bias gradient and the LN sums take float32 values.
    Returns ``(dxs, dxb, dxbh, dw, dc0, dh0, dhc0, dhh0)``, ``dw`` a
    :class:`HyperWeights` of gradients in the primals' dtypes; ``dxb``
    and ``dxbh`` are None without the biases."""
    _check_bias_pair(x_bias, x_bias_hyper)
    t_len, bsz, _ = xs.shape
    h = w.wh.shape[0]
    wd = w.wx.dtype
    acc = _acc_dtype(w.wx)
    step = _HyperStep(w, forget_bias, x_bias, x_bias_hyper)
    h00, hh00 = h0.to(hs.dtype), hh0.to(hyhs.dtype)   # _prev_block
    g = {n: torch.zeros(getattr(w, n).shape, dtype=acc, device=xs.device)
         for n in HyperWeights._fields}
    dxs = torch.empty(xs.shape, dtype=acc, device=xs.device)
    dxb = torch.zeros_like(x_bias) if x_bias is not None else None
    dxbh = torch.zeros_like(x_bias_hyper) if x_bias is not None else None
    dc, dh, dhc, dhh = dcT, dhT, dhcT, dhhT
    for s in range(t_len - 1, -1, -1):
        x = xs[s]
        h_prev = (hs[s - 1] if s > 0 else h00).to(acc)
        hh_prev = (hyhs[s - 1] if s > 0 else hh00).to(acc)
        c_prev, hc_prev = cs[s].to(acc), hycs[s].to(acc)
        m = _step_mask(masks, dropout_seed, s, bsz, h, keep_prob)
        ln, aux = step(x, h_prev, c_prev, hc_prev, hh_prev, m)
        (i, g_u, f, o, _, _, yc, xhat_c, r_c, xhats, rs) = ln
        (hi, hg, hf, ho, new_hc, new_hh, xp, hp, zx, zh, zb, sx, sh) = aux

        # the LayerNorm-LSTM gate block (as ln_lstm_bwd_reference)
        dh = dh + dhs[s].to(acc)
        tanh_yc = torch.tanh(yc)
        do = dh * tanh_yc
        dyc = dh * o * (1.0 - tanh_yc * tanh_yc)
        g["lnc_gamma"] += (dyc * xhat_c).sum(dim=0)
        g["lnc_beta"] += dyc.sum(dim=0)
        dc = dc + _ln_bwd_input(dyc, w.lnc_gamma, xhat_c, r_c)
        df = dc * c_prev
        gm = g_u * m if m is not None else g_u
        di = dc * gm
        dg_u = dc * i * m if m is not None else dc * i
        dys = [di * i * (1.0 - i), dg_u * (1.0 - g_u * g_u),
               df * f * (1.0 - f), do * o * (1.0 - o)]
        parts = []
        for j in range(4):
            g["ln_gamma"][j] += (dys[j] * xhats[j]).sum(dim=0)
            g["ln_beta"][j] += dys[j].sum(dim=0)
            parts.append(_ln_bwd_input(dys[j], w.ln_gamma[j], xhats[j],
                                       rs[j]))
        d_pre = torch.cat(parts, dim=-1)
        dc = dc * f

        # pre = sx * xp + sh * hp + sb + b
        dsx, dxp = d_pre * xp, d_pre * sx
        dsh, dhp = d_pre * hp, d_pre * sh
        g["b"] += d_pre.sum(dim=0)
        if dxb is not None:
            dxb += dxp

        # the per-gate block projections (float32 products)
        dzx = _block_unscale(dsx, w.zd_x)
        dzh = _block_unscale(dsh, w.zd_h)
        dzb = _block_unscale(d_pre, w.zd_b)
        g["zd_x"] += _block_scale_grad(zx, dsx, w.zd_x)
        g["zd_h"] += _block_scale_grad(zh, dsh, w.zd_h)
        g["zd_b"] += _block_scale_grad(zb, d_pre, w.zd_b)

        # hyper_h -> z
        dzx_c, dzh_c, dzb_c = (_rnd(d, wd) for d in (dzx, dzh, dzb))
        dhh = (dhh + dzx_c @ step.wide["w_hz_x"].T
               + dzh_c @ step.wide["w_hz_h"].T
               + dzb_c @ step.wide["w_hz_b"].T)
        hh_c = _rnd(new_hh, wd)
        g["w_hz_x"] += hh_c.T @ dzx_c
        g["w_hz_h"] += hh_c.T @ dzh_c
        g["w_hz_b"] += hh_c.T @ dzb_c
        g["b_hz_x"] += dzx.sum(dim=0)
        g["b_hz_h"] += dzh.sum(dim=0)

        # the auxiliary LSTM (no dropout)
        tanh_hc = torch.tanh(new_hc)
        dhc = dhc + dhh * ho * (1.0 - tanh_hc * tanh_hc)
        dho = dhh * tanh_hc
        dhf, dhi, dhg = dhc * hc_prev, dhc * hg, dhc * hi
        dh_pre = torch.cat([dhi * hi * (1.0 - hi), dhg * (1.0 - hg * hg),
                            dhf * hf * (1.0 - hf), dho * ho * (1.0 - ho)],
                           dim=-1)
        dhc = dhc * hf
        if dxbh is not None:
            dxbh += dh_pre
        dh_pre_c = _rnd(dh_pre, wd)
        x_c, h_c = _rnd(x, wd), _rnd(h_prev, wd)
        g["bh"] += dh_pre.sum(dim=0)
        g["wxh_x"] += x_c.T @ dh_pre_c
        g["wxh_h"] += h_c.T @ dh_pre_c
        g["whh"] += _rnd(hh_prev, wd).T @ dh_pre_c
        dhh = dh_pre_c @ step.wide["whh"].T

        # the main projections and the carries' gradients
        dxp_c, dhp_c = _rnd(dxp, wd), _rnd(dhp, wd)
        dxs[s] = dxp_c @ step.wide["wx"].T + dh_pre_c @ step.wide["wxh_x"].T
        g["wx"] += x_c.T @ dxp_c
        g["wh"] += h_c.T @ dhp_c
        dh = dhp_c @ step.wide["wh"].T + dh_pre_c @ step.wide["wxh_h"].T
    dw = HyperWeights(**{n: g[n].to(getattr(w, n).dtype)
                         for n in HyperWeights._fields})
    return dxs.to(xs.dtype), dxb, dxbh, dw, dc, dh, dhc, dhh


# -- the kernels ------------------------------------------------------------
#
# One function per kernel, with its plain version's signature: the plain
# version on CPU tensors, the CUDA kernel on CUDA tensors (or a raise).
# Each adds one to its launch counter when it launches.


def _residual(residual_dtype):
    rd = torch.float32 if residual_dtype is None else residual_dtype
    if rd not in RESIDUAL_DTYPES:
        raise TypeError(f"residual_dtype {rd}: the fused RNN kernels store "
                        f"residuals as {RESIDUAL_DTYPES}")
    return rd


def _kernel_common(xs, wx, wh, c0, h0, masks, seed):
    """Validate what every kernel shares; returns ``(dev, t, b, d, h,
    mask_ptr, seed_ptr, w_bf16)``. ``wx`` and ``wh`` are float32, or
    both bfloat16 (pre-cast); every other float operand is float32."""
    if xs.device.type != "cuda":
        raise ValueError(f"the fused RNN kernels run on CUDA or CPU "
                         f"tensors, not {xs.device}")
    dev = xs.device
    t, b, d = xs.shape
    h = wh.shape[0]
    if not 0 < h <= MAX_HIDDEN:
        raise ValueError(f"hidden size {h}: the fused RNN kernels hold one "
                         f"thread per hidden unit, at most {MAX_HIDDEN}")
    wd = wx.dtype
    if wd not in WEIGHT_DTYPES:
        raise TypeError(f"wx has dtype {wd}: the fused RNN kernels take "
                        f"weights in {WEIGHT_DTYPES}")
    f32 = torch.float32
    for n, x, dt, shape in (("xs", xs, f32, (t, b, d)),
                            ("wx", wx, wd, (d, 4 * h)),
                            ("wh", wh, wd, (h, 4 * h)),
                            ("c0", c0, f32, (b, h)),
                            ("h0", h0, f32, (b, h))):
        _require(n, x, dev, dt, shape)
    if masks is not None:
        _require("masks", masks, dev, f32, (t, b, h))
    if seed is not None:
        _require("dropout_seed", seed, dev, torch.int32, ())
    return dev, t, b, d, h, _ptr(masks), _ptr(seed), int(wd == torch.bfloat16)


def _residuals_check(dev, t, b, h, hs, cs, dhs):
    rd = hs.dtype
    if rd not in RESIDUAL_DTYPES:
        raise TypeError(f"hs has dtype {rd}: the fused RNN kernels store "
                        f"residuals as {RESIDUAL_DTYPES}")
    for n, x in (("hs", hs), ("cs", cs), ("dhs", dhs)):
        _require(n, x, dev, rd, (t, b, h))
    return int(rd == torch.bfloat16)


def _f32_check(dev, named):
    for n, x, shape in named:
        if x is not None:
            _require(n, x, dev, torch.float32, shape)


def _ln_params_check(dev, h, gam, bet, gc, bc, x_bias, bsz):
    _f32_check(dev, (("ln_gamma", gam, (4, h)), ("ln_beta", bet, (4, h)),
                     ("lnc_gamma", gc, (h,)), ("lnc_beta", bc, (h,)),
                     ("x_bias", x_bias, (bsz, 4 * h))))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _keep_args(keep_prob):
    return float(np.float32(keep_prob)), float(np.float32(1.0 / keep_prob))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(entry, what, counter, *args, lib="fused_rnn"):
    from sketch_rnn_tpu_torch.ops import _build

    lib = _build.load(lib)
    _build.check(lib, getattr(lib, entry)(*args), what)
    with _count_lock:
        _launches[counter] += 1


def _entries_on_cuda(what, xs):
    """The A/B helpers run C entries and have no plain version."""
    if xs.device.type != "cuda":
        raise ValueError(f"{what} drives the C entries on CUDA tensors "
                         f"only, not {xs.device}")


def _lstm_fwd_args(xs, wx, b, wh, c0, h0, forget_bias, masks, seed,
                   keep_prob, x_bias, residual_dtype, final):
    """Check the LSTM forward's inputs and allocate its outputs and its
    ``hx`` scratch: ``(args, outs, hx)``, the arguments of the
    ``srt_lstm_fwd*`` entries, ``(hs, cs, cT, hT)`` (the final carry
    ``None`` unless ``final``) and the ``[2, B, H]`` weight-dtype scratch
    through which the kernel's blocks exchange ``h``, which the caller
    keeps alive while the launches use it (``args`` holds only its
    address)."""
    dev, t, bsz, d, h, mp, sp, wb = _kernel_common(xs, wx, wh, c0, h0,
                                                   masks, seed)
    rd = _residual(residual_dtype)
    _f32_check(dev, (("b", b, (4 * h,)), ("x_bias", x_bias, (bsz, 4 * h))))
    hs = torch.empty((t, bsz, h), dtype=rd, device=dev)
    cs = torch.empty_like(hs)
    cT = hT = None
    if final:
        cT = torch.empty((bsz, h), dtype=torch.float32, device=dev)
        hT = torch.empty_like(cT)
    hx = torch.empty((2, bsz, h), dtype=wx.dtype, device=dev)
    args = (xs.data_ptr(), _ptr(x_bias), wx.data_ptr(), b.data_ptr(),
            wh.data_ptr(), c0.data_ptr(), h0.data_ptr(), mp, sp, t, bsz, d,
            h, wb, int(rd == torch.bfloat16), *_keep_args(keep_prob),
            float(forget_bias), hs.data_ptr(), cs.data_ptr(), _ptr(cT),
            _ptr(hT), hx.data_ptr(), _stream(dev))
    return args, (hs, cs, cT, hT), hx


def _lstm_fwd_kernel(counter, xs, wx, b, wh, c0, h0, forget_bias, masks,
                     seed, keep_prob, x_bias, residual_dtype, final):
    args, outs, _hx = _lstm_fwd_args(xs, wx, b, wh, c0, h0, forget_bias,
                                     masks, seed, keep_prob, x_bias,
                                     residual_dtype, final)
    _launch("srt_lstm_fwd", counter.replace("_", " "), counter, *args)
    return outs


def lstm_fwd_entries(xs, wx, b, wh, c0, h0, forget_bias=1.0, masks=None,
                     dropout_seed=None, keep_prob=1.0, x_bias=None,
                     residual_dtype=None, full=True):
    """The C entries behind :func:`lstm_fwd` (``full``: the final carry
    too) and :func:`lstm_seq_fwd` on CUDA tensors, for the A/B of the
    forward's two designs; no wrapper calls it, and it counts no launch.
    Returns ``(run, outs)``: ``run(entry)`` launches ``"srt_lstm_fwd"``
    (the cooperative loop) or ``"srt_lstm_fwd_rowblock"`` (the row-block
    design it replaced) on one set of buffers, and keeps the inputs alive
    (the entries take raw addresses); ``outs`` are ``(hs, cs, cT, hT)`` as
    the last launch left them."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("lstm_fwd_entries", xs)
    args, outs, hx = _lstm_fwd_args(xs, wx, b, wh, c0, h0, forget_bias,
                                    masks, dropout_seed, keep_prob, x_bias,
                                    residual_dtype, full)
    lib = _build.load("fused_rnn")
    held = (hx, xs, wx, b, wh, c0, h0, masks, dropout_seed, x_bias)

    def run(entry, _held=held):     # holds the scratch and the inputs
        _build.check(lib, getattr(lib, entry)(*args), entry)

    return run, outs


# -- the weight pass (csrc/weight_grad.cuh) -----------------------------------
#
# Every backward entry ends with [dwx; dwh; db] = sum over k = t * B + b of
# [x; h_{t-1}; 1]^T d_pre[k], a product over K = T * B row-steps cut into
# slices whose partial sums a second launch adds in slice order. The plan
# depends on the shape alone, never on the card, so the sums' order, and
# every bit of the result, is the same on any card.

WG_TILE = 128           # output rows and columns of one block
WG_FOLD = 8             # float32: extra rows that ride with row tile 0
WG_CHUNK = {torch.float32: 16, torch.bfloat16: 32}   # k rows per step
WG_BLOCKS = 1024        # blocks the plan aims for (several per SM)
WG_MAX_SLICES = 64      # caps the partials scratch, whatever K
WG_SCRATCH_SHARE = 4    # partials at most 1/4 of d_pre's floats


class WeightGradPlan(NamedTuple):
    """Slice ``s`` of ``[0, K)`` is ``[s * kslice, min((s + 1) * kslice,
    K))``; ``kslice`` is a whole number of the kernel's k steps."""
    slices: int
    kslice: int

    def bounds(self, k: int):
        return [(s * self.kslice, min((s + 1) * self.kslice, k))
                for s in range(self.slices)]


def weight_grad_tiles(d, h, ones, dtype, n=None) -> int:
    """Blocks of one slice of the weight pass (``weight_grad.cuh``,
    ``wg_row_tiles``): 128 x 128 output tiles over the ``n`` columns
    (``4H`` by default) and the ``H`` main rows (those of ``dwh``), then
    the extra rows in tiles of their own: the ``D`` rows of ``dwx`` at
    bfloat16 (and ``db``'s sums, alone when ``D = 0``); at float32 ``[x;
    1]``, unless their ``D + ones`` rows fold into the first row tile (at
    most ``WG_FOLD``, and only where there are main rows)."""
    cdiv = lambda x, y: -(-x // y)
    if dtype == torch.bfloat16:
        extra = max(d, ones)
    else:
        extra = 0 if d + ones <= WG_FOLD and h > 0 else d + ones
    n = 4 * h if n is None else n
    return cdiv(n, WG_TILE) * (cdiv(h, WG_TILE) + cdiv(extra, WG_TILE))


def _wg_plan(k, d, m, n, ones, dtype) -> WeightGradPlan:
    """The split-K plan of a product over ``k`` row-steps with ``d`` extra
    rows, ``m`` main rows, ``n`` columns and a row of ones or not
    (``weight_grad.cuh``'s ``wg_plan``, the same rule)."""
    if dtype not in WG_CHUNK:
        raise TypeError(f"weight dtype {dtype}: the weight pass takes "
                        f"{tuple(WG_CHUNK)}")
    r = d + m + ones
    cdiv = lambda x, y: -(-x // y)
    s = max(1, min(cdiv(WG_BLOCKS, weight_grad_tiles(d, m, ones, dtype, n)),
                   WG_MAX_SLICES,
                   k // (WG_SCRATCH_SHARE * r)))
    chunk = WG_CHUNK[dtype]
    kslice = max(chunk, cdiv(cdiv(k, s), chunk) * chunk)
    return WeightGradPlan(max(1, cdiv(k, kslice)), kslice)


def weight_grad_plan(t, b, d, h, ones, dtype) -> WeightGradPlan:
    """The weight pass's split-K plan for ``T * B`` row-steps, ``D``
    inputs, ``H`` units, a row of ones (``db``) or not, and weight dtype
    ``dtype``: enough slices that the grid of 128 x 128 tiles holds about
    ``WG_BLOCKS`` blocks, at most ``WG_MAX_SLICES``, and few enough that
    the ``[slices, D + H + ones, 4H]`` float partials stay within a
    ``WG_SCRATCH_SHARE``-th of ``d_pre``'s floats; at least one slice."""
    return _wg_plan(t * b, d, h, 4 * h, ones, dtype)


def weight_grad_reference(xs, h0, hs, d_pre, d, h, ones, w_dtype,
                          k_range=None):
    """The plain version of the weight pass, in one product over all row
    steps (or those of ``k_range``, ``(k0, k1)``): ``(dwx [D, 4H], dwh
    [H, 4H], db [4H] or None)`` in float32, from ``xs [T, B, D]``, ``h0
    [B, H]`` (rounded to ``hs``'s dtype first), ``hs [T, B, H]`` and
    ``d_pre [T, B, 4H]``. The ``x`` and ``h_{t-1}`` operands and ``d_pre``
    are rounded to ``w_dtype``, the sums float32; ``db`` sums the
    unrounded ``d_pre``."""
    t, b = d_pre.shape[:2]
    k0, k1 = (0, t * b) if k_range is None else k_range
    dp = d_pre.reshape(t * b, 4 * h)[k0:k1]
    dpw = _rnd(dp, w_dtype)
    h_prev = torch.cat([h0.to(hs.dtype)[None], hs[:-1]]).reshape(t * b, h)
    dwh = _rnd(h_prev[k0:k1].float(), w_dtype).T @ dpw
    dwx = _rnd(xs.reshape(t * b, d)[k0:k1], w_dtype).T @ dpw
    return dwx, dwh, (dp.sum(dim=0) if ones else None)


def _wg_scratch(t, b, d, h, ones, w_dtype, dev):
    """The weight pass's plan and its partials scratch: ``(args, part)``,
    ``args`` the entries' ``(wg_slices, wg_kslice, wg_part)``."""
    p = weight_grad_plan(t, b, d, h, ones, w_dtype)
    part = torch.empty((p.slices, d + h + ones, 4 * h), dtype=torch.float32,
                       device=dev)
    return (p.slices, p.kslice, part.data_ptr()), part


def weight_grad_entries(xs, h0, hs, d_pre, ones, w_dtype):
    """``srt_weight_grad`` on CUDA tensors, for the A/B of the weight pass
    over a ``d_pre`` scratch a backward entry (or one of its stages) left;
    no wrapper calls it, and it counts no launch. Returns ``(run,
    outs)``: ``run(variant)`` launches the split-K pass every backward
    entry runs (0) or the pass it replaced (1), on one set of buffers,
    and keeps the inputs alive; ``outs`` are ``(dwx, dwh, db)`` in
    float32 as the last launch left them (``db`` None without
    ``ones``)."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("weight_grad_entries", xs)
    if w_dtype not in WEIGHT_DTYPES:
        raise TypeError(f"weight dtype {w_dtype}: the weight pass takes "
                        f"{WEIGHT_DTYPES}")
    dev, f32 = xs.device, torch.float32
    t, b, d = xs.shape
    h = h0.shape[1]
    if hs.dtype not in RESIDUAL_DTYPES:
        raise TypeError(f"hs has dtype {hs.dtype}: the fused RNN kernels "
                        f"store residuals as {RESIDUAL_DTYPES}")
    for n, x, dt, shape in (("xs", xs, f32, (t, b, d)), ("h0", h0, f32, (b, h)),
                            ("hs", hs, hs.dtype, (t, b, h)),
                            ("d_pre", d_pre, f32, (t, b, 4 * h))):
        _require(n, x, dev, dt, shape)
    wg, part = _wg_scratch(t, b, d, h, ones, w_dtype, dev)
    dwx = torch.empty((d, 4 * h), dtype=f32, device=dev)
    dwh = torch.empty((h, 4 * h), dtype=f32, device=dev)
    db = torch.empty((4 * h,), dtype=f32, device=dev) if ones else None
    args = (xs.data_ptr(), h0.data_ptr(), hs.data_ptr(), d_pre.data_ptr(), t,
            b, d, h, int(bool(ones)), int(w_dtype == torch.bfloat16),
            int(hs.dtype == torch.bfloat16), *wg, dwx.data_ptr(),
            dwh.data_ptr(), _ptr(db), _stream(dev))
    lib = _build.load("fused_rnn")
    held = (part, xs, h0, hs, d_pre)

    def run(variant, _held=held):   # holds the scratch and the inputs
        _build.check(lib, lib.srt_weight_grad(variant, *args),
                     f"srt_weight_grad({variant})")

    return run, (dwx, dwh, db)


def _lstm_bwd_args(xs, wx, b, wh, h0, hs, cs, dhs, dcT, dhT, forget_bias,
                   masks, seed, keep_prob, x_bias, full):
    """Check the LSTM backward's inputs and allocate its outputs and its
    scratch: ``(args, outs, scratch)``, the arguments of the
    ``srt_lstm_bwd*`` entries, ``(dxs, dxb, dwx, db, dwh, dc0, dh0)``
    (the weight gradients float32, ``None`` where not ``full``) and the
    ``d_pre`` and weight-pass scratch, which the caller keeps alive while
    the launches use them (``args`` holds only their addresses)."""
    dev, t, bsz, d, h, mp, sp, wb = _kernel_common(xs, wx, wh, h0, h0,
                                                   masks, seed)
    rb = _residuals_check(dev, t, bsz, h, hs, cs, dhs)
    _f32_check(dev, (("b", b, (4 * h,)), ("x_bias", x_bias, (bsz, 4 * h)),
                     ("dcT", dcT, (bsz, h)), ("dhT", dhT, (bsz, h))))
    f32 = torch.float32
    # scratch: the recomputed pre-activations of every step, overwritten
    # by their gradients (float32, unrounded), read by the weight pass
    dpre = torch.empty((t, bsz, 4 * h), dtype=f32, device=dev)
    dwx = torch.empty(wx.shape, dtype=f32, device=dev)
    dwh = torch.empty(wh.shape, dtype=f32, device=dev)
    db = torch.empty((4 * h,), dtype=f32, device=dev)
    dxs = dc0 = dh0 = dxb = None
    if full:
        dxs = torch.empty_like(xs)
        dc0 = torch.empty((bsz, h), dtype=f32, device=dev)
        dh0 = torch.empty_like(dc0)
        dxb = torch.empty_like(x_bias) if x_bias is not None else None
    wg, wg_part = _wg_scratch(t, bsz, d, h, 1, wx.dtype, dev)
    args = (xs.data_ptr(), _ptr(x_bias), wx.data_ptr(), b.data_ptr(),
            wh.data_ptr(), h0.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhs.data_ptr(), _ptr(dcT), _ptr(dhT), mp, sp, t, bsz, d, h, wb,
            rb, *_keep_args(keep_prob), float(forget_bias), dpre.data_ptr(),
            _ptr(dxs), _ptr(dxb), dwx.data_ptr(), db.data_ptr(),
            dwh.data_ptr(), _ptr(dc0), _ptr(dh0), *wg, _stream(dev))
    return args, (dxs, dxb, dwx, db, dwh, dc0, dh0), (dpre, wg_part)


def _lstm_bwd_kernel(counter, xs, wx, b, wh, h0, hs, cs, dhs, dcT, dhT,
                     forget_bias, masks, seed, keep_prob, x_bias, full):
    args, (dxs, dxb, dwx, db, dwh, dc0, dh0), _scratch = _lstm_bwd_args(
        xs, wx, b, wh, h0, hs, cs, dhs, dcT, dhT, forget_bias, masks, seed,
        keep_prob, x_bias, full)
    _launch("srt_lstm_bwd", counter.replace("_", " "), counter, *args)
    return dxs, dxb, dwx.to(wx.dtype), db, dwh.to(wh.dtype), dc0, dh0


def lstm_bwd_entries(xs, wx, b, wh, h0, hs, cs, dhs, dcT=None, dhT=None,
                     forget_bias=1.0, masks=None, dropout_seed=None,
                     keep_prob=1.0, x_bias=None, full=True):
    """The C entries behind :func:`lstm_bwd` (``full``) and
    :func:`lstm_seq_bwd` on CUDA tensors, for the A/B of the backward's
    two designs; no wrapper calls it, and it counts no launch. Returns
    ``(run, outs)``: ``run(entry, stage=0)`` launches ``"srt_lstm_bwd"``
    (the three launches), ``"srt_lstm_bwd_rowblock"`` (the row-block
    design it replaced) or, with ``stage`` 1-3, ``"srt_lstm_bwd_stage"``
    (the recompute, the loop or the weight pass alone), all on one set of
    buffers, and keeps the inputs alive (the entries take raw addresses);
    ``outs`` are ``(dxs, dxb, dwx, db, dwh, dc0, dh0)`` as the last
    launches left them (the weight gradients float32)."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("lstm_bwd_entries", xs)
    args, outs, scratch = _lstm_bwd_args(xs, wx, b, wh, h0, hs, cs, dhs,
                                         dcT, dhT, forget_bias, masks,
                                         dropout_seed, keep_prob, x_bias,
                                         full)
    lib = _build.load("fused_rnn")
    held = (scratch, xs, wx, b, wh, h0, hs, cs, dhs, dcT, dhT, masks,
            dropout_seed, x_bias)

    def run(entry, stage=0, _held=held):   # holds the scratch and inputs
        pre = (stage,) if entry == "srt_lstm_bwd_stage" else ()
        _build.check(lib, getattr(lib, entry)(*pre, *args), entry)

    return run, outs


def lstm_seq_fwd(xs, wx, b, wh, c0, h0, forget_bias=1.0, masks=None,
                 dropout_seed=None, keep_prob=1.0, residual_dtype=None):
    """Forward of :func:`fused_lstm_seq`: ``(hs, cs)`` (kernel
    ``srt_lstm_fwd``, the cooperative loop, with no ``x_bias`` and no
    final carry)."""
    if xs.device.type == "cpu":
        return lstm_seq_fwd_reference(xs, wx, b, wh, c0, h0, forget_bias,
                                      masks, dropout_seed, keep_prob,
                                      residual_dtype)
    return _lstm_fwd_kernel("fused_lstm_seq_fwd", xs, wx, b, wh, c0, h0,
                            forget_bias, masks, dropout_seed, keep_prob,
                            None, residual_dtype, False)[:2]


def lstm_seq_bwd(xs, wx, b, wh, h0, hs, cs, dhs, forget_bias=1.0,
                 masks=None, dropout_seed=None, keep_prob=1.0):
    """Backward of :func:`fused_lstm_seq`: ``(dwx, db, dwh)`` (kernel
    ``srt_lstm_bwd``: the hoisted gate recompute, the cooperative loop,
    the weight-gradient pass)."""
    if xs.device.type == "cpu":
        return lstm_seq_bwd_reference(xs, wx, b, wh, h0, hs, cs, dhs,
                                      forget_bias, masks, dropout_seed,
                                      keep_prob)
    _, _, dwx, db, dwh, _, _ = _lstm_bwd_kernel(
        "fused_lstm_seq_bwd", xs, wx, b, wh, h0, hs, cs, dhs, None, None,
        forget_bias, masks, dropout_seed, keep_prob, None, False)
    return dwx, db, dwh


def lstm_fwd(xs, wx, b, wh, c0, h0, forget_bias=1.0, masks=None,
             dropout_seed=None, keep_prob=1.0, x_bias=None,
             residual_dtype=None):
    """Forward of :func:`fused_lstm`: ``(hs, cs, cT, hT)`` (kernel
    ``srt_lstm_fwd``, the cooperative loop)."""
    if xs.device.type == "cpu":
        return lstm_fwd_reference(xs, wx, b, wh, c0, h0, forget_bias, masks,
                                  dropout_seed, keep_prob, x_bias,
                                  residual_dtype)
    return _lstm_fwd_kernel("fused_lstm_fwd", xs, wx, b, wh, c0, h0,
                            forget_bias, masks, dropout_seed, keep_prob,
                            x_bias, residual_dtype, True)


def lstm_bwd(xs, wx, b, wh, h0, hs, cs, dhs, dcT, dhT, forget_bias=1.0,
             masks=None, dropout_seed=None, keep_prob=1.0, x_bias=None):
    """Backward of :func:`fused_lstm`: ``(dxs, dxb, dwx, db, dwh, dc0,
    dh0)`` (kernel ``srt_lstm_bwd``: the hoisted gate recompute, the
    cooperative loop with ``dxs`` at its end, the weight-gradient pass
    with its row of ones for ``db``)."""
    if xs.device.type == "cpu":
        return lstm_bwd_reference(xs, wx, b, wh, h0, hs, cs, dhs, dcT, dhT,
                                  forget_bias, masks, dropout_seed,
                                  keep_prob, x_bias)
    return _lstm_bwd_kernel("fused_lstm_bwd", xs, wx, b, wh, h0, hs, cs,
                            dhs, dcT, dhT, forget_bias, masks, dropout_seed,
                            keep_prob, x_bias, True)


LN_UNITS = 16   # hidden units per slice of the LN kernels' loops


def ln_fwd_work_floats(b, h) -> int:
    """Floats of the LN forward's work scratch (``csrc/fused_rnn.cu``,
    ``LnFwdWork``): the slices' partials of the layer norms' row moments
    (10 per row and slice) and each (row, unit) pair's four gates, kept
    from one phase of a step to the next where a tile's rows pass in
    several chunks."""
    slices = -(-h // LN_UNITS)
    return (slices * 10 + 4 * h) * b


def _ln_lstm_fwd_args(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
                      h0, forget_bias, masks, seed, keep_prob, x_bias,
                      residual_dtype):
    """Check the LN-LSTM forward's inputs and allocate its outputs and
    scratch: ``(args, outs, scratch)``, the arguments of the
    ``srt_ln_lstm_fwd*`` entries, ``(hs, cs, cT, hT)`` and the scratch
    tensors (the ``[2, B, H]`` weight-dtype ``h`` exchange and the float32
    work), which the caller keeps alive while the launches use them
    (``args`` holds only their addresses)."""
    dev, t, bsz, d, h, mp, sp, wb = _kernel_common(xs, wx, wh, c0, h0, masks,
                                                   seed)
    rd = _residual(residual_dtype)
    _ln_params_check(dev, h, ln_gamma, ln_beta, lnc_gamma, lnc_beta, x_bias,
                     bsz)
    hs = torch.empty((t, bsz, h), dtype=rd, device=dev)
    cs = torch.empty_like(hs)
    cT = torch.empty((bsz, h), dtype=torch.float32, device=dev)
    hT = torch.empty_like(cT)
    hx = torch.empty((2, bsz, h), dtype=wx.dtype, device=dev)
    work = torch.empty((ln_fwd_work_floats(bsz, h),), dtype=torch.float32,
                       device=dev)
    args = (xs.data_ptr(), _ptr(x_bias), wx.data_ptr(), wh.data_ptr(),
            ln_gamma.data_ptr(), ln_beta.data_ptr(), lnc_gamma.data_ptr(),
            lnc_beta.data_ptr(), c0.data_ptr(), h0.data_ptr(), mp, sp, t,
            bsz, d, h, wb, int(rd == torch.bfloat16), *_keep_args(keep_prob),
            float(forget_bias), hs.data_ptr(), cs.data_ptr(), cT.data_ptr(),
            hT.data_ptr(), hx.data_ptr(), work.data_ptr(), _stream(dev))
    return args, (hs, cs, cT, hT), (hx, work)


def ln_lstm_fwd_entries(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
                        c0, h0, forget_bias=1.0, masks=None,
                        dropout_seed=None, keep_prob=1.0, x_bias=None,
                        residual_dtype=None):
    """The C entries behind :func:`ln_lstm_fwd` on CUDA tensors, for the
    A/B of the forward's two designs; no wrapper calls it, and it counts
    no launch. Returns ``(run, outs)``: ``run(entry)`` launches
    ``"srt_ln_lstm_fwd"`` (the cooperative loop) or
    ``"srt_ln_lstm_fwd_rowblock"`` (the row-block design it replaced) on
    one set of buffers, and keeps the inputs alive (the entries take raw
    addresses); ``outs`` are ``(hs, cs, cT, hT)`` as the last launch left
    them."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("ln_lstm_fwd_entries", xs)
    args, outs, scratch = _ln_lstm_fwd_args(
        xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0,
        forget_bias, masks, dropout_seed, keep_prob, x_bias, residual_dtype)
    lib = _build.load("fused_rnn")
    held = (scratch, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
            c0, h0, masks, dropout_seed, x_bias)

    def run(entry, _held=held):     # holds the scratch and the inputs
        _build.check(lib, getattr(lib, entry)(*args), entry)

    return run, outs


def ln_lstm_fwd(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
                h0, forget_bias=1.0, masks=None, dropout_seed=None,
                keep_prob=1.0, x_bias=None, residual_dtype=None):
    """Forward of :func:`fused_ln_lstm`: ``(hs, cs, cT, hT)`` (kernel
    ``srt_ln_lstm_fwd``, the cooperative loop with the layer norms' row
    moments exchanged between its blocks)."""
    if xs.device.type == "cpu":
        return ln_lstm_fwd_reference(xs, wx, wh, ln_gamma, ln_beta,
                                     lnc_gamma, lnc_beta, c0, h0,
                                     forget_bias, masks, dropout_seed,
                                     keep_prob, x_bias, residual_dtype)
    args, outs, _scratch = _ln_lstm_fwd_args(
        xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0,
        forget_bias, masks, dropout_seed, keep_prob, x_bias, residual_dtype)
    _launch("srt_ln_lstm_fwd", "fused_ln_lstm forward", "fused_ln_lstm_fwd",
            *args)
    return outs


def ln_bwd_work_floats(t, b, h) -> int:
    """Floats of the LN backward's work scratch (``csrc/fused_rnn.cu``,
    ``LnWork``): the slices' partials of the layer norms' row sums (10 per
    row and slice), the hoisted statistics (10 per row-step) and the
    stashed ``dy * gamma`` of every (row, unit) pair's four gates."""
    slices = -(-h // LN_UNITS)
    return (slices * 10 + t * 10 + 4 * h) * b


def _ln_lstm_bwd_args(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
                      h0, hs, cs, dhs, dcT, dhT, forget_bias, masks, seed,
                      keep_prob, x_bias):
    """Check the LN-LSTM backward's inputs and allocate its outputs and
    scratch: ``(args, outs, scratch)``, the arguments of the
    ``srt_ln_lstm_bwd*`` entries, ``(dxs, dxb, dwx, dwh, dln, dc0, dh0)``
    (the weight gradients float32, ``dln`` the ten LN-parameter rows
    ``[10H]``) and the scratch tensors, which the caller keeps alive while
    the launches use them (``args`` holds only their addresses)."""
    dev, t, bsz, d, h, mp, sp, wb = _kernel_common(xs, wx, wh, h0, h0, masks,
                                                   seed)
    rb = _residuals_check(dev, t, bsz, h, hs, cs, dhs)
    _ln_params_check(dev, h, ln_gamma, ln_beta, lnc_gamma, lnc_beta, x_bias,
                     bsz)
    _f32_check(dev, (("dcT", dcT, (bsz, h)), ("dhT", dhT, (bsz, h))))
    f32 = torch.float32
    # scratch: every step's pre-activations, overwritten by their
    # gradients (float32, unrounded; read by the weight-gradient pass),
    # each row's LN-parameter sums, the loop's work (statistics,
    # exchanges, stash) and the weight pass's partials
    dpre = torch.empty((t, bsz, 4 * h), dtype=f32, device=dev)
    part = torch.empty((bsz, 10 * h), dtype=f32, device=dev)
    work = torch.empty((ln_bwd_work_floats(t, bsz, h),), dtype=f32,
                       device=dev)
    dxs = torch.empty_like(xs)
    dxb = torch.empty_like(x_bias) if x_bias is not None else None
    dwx = torch.empty(wx.shape, dtype=f32, device=dev)
    dwh = torch.empty(wh.shape, dtype=f32, device=dev)
    dln = torch.empty((10 * h,), dtype=f32, device=dev)
    dc0 = torch.empty((bsz, h), dtype=f32, device=dev)
    dh0 = torch.empty_like(dc0)
    wg, wg_part = _wg_scratch(t, bsz, d, h, 0, wx.dtype, dev)
    args = (xs.data_ptr(), _ptr(x_bias), wx.data_ptr(), wh.data_ptr(),
            ln_gamma.data_ptr(), ln_beta.data_ptr(), lnc_gamma.data_ptr(),
            lnc_beta.data_ptr(), h0.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhs.data_ptr(), _ptr(dcT), _ptr(dhT), mp, sp, t, bsz, d, h, wb,
            rb, *_keep_args(keep_prob), float(forget_bias), dpre.data_ptr(),
            part.data_ptr(), work.data_ptr(), dxs.data_ptr(), _ptr(dxb),
            dwx.data_ptr(), dwh.data_ptr(), dln.data_ptr(), dc0.data_ptr(),
            dh0.data_ptr(), *wg, _stream(dev))
    return args, (dxs, dxb, dwx, dwh, dln, dc0, dh0), (dpre, part, work,
                                                       wg_part)


def ln_lstm_bwd_entries(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta,
                        h0, hs, cs, dhs, dcT=None, dhT=None, forget_bias=1.0,
                        masks=None, dropout_seed=None, keep_prob=1.0,
                        x_bias=None):
    """The C entries behind :func:`ln_lstm_bwd` on CUDA tensors, for the
    A/B of the backward's two designs; no wrapper calls it, and it counts
    no launch. Returns ``(run, outs)``: ``run(entry, stage=0)`` launches
    ``"srt_ln_lstm_bwd"`` (the four launches), ``"srt_ln_lstm_bwd_rowblock"``
    (the row-block design it replaced) or, with ``stage`` 1-4,
    ``"srt_ln_lstm_bwd_stage"`` (the recompute, the statistics, the loop
    with the LN parameters' row sum, or the weight pass alone), all on one
    set of buffers, and keeps the inputs alive (the entries take raw
    addresses); ``outs`` are :func:`ln_lstm_bwd`'s outputs as the last
    launches left them (the weight gradients float32)."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("ln_lstm_bwd_entries", xs)
    args, (dxs, dxb, dwx, dwh, dln, dc0, dh0), scratch = _ln_lstm_bwd_args(
        xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs, dhs,
        dcT, dhT, forget_bias, masks, dropout_seed, keep_prob, x_bias)
    lib = _build.load("fused_rnn")
    held = (scratch, xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0,
            hs, cs, dhs, dcT, dhT, masks, dropout_seed, x_bias)

    def run(entry, stage=0, _held=held):   # holds the scratch and inputs
        pre = (stage,) if entry == "srt_ln_lstm_bwd_stage" else ()
        _build.check(lib, getattr(lib, entry)(*pre, *args), entry)

    return run, (dxs, dxb, dwx, dwh, *_ln_rows(dln), dc0, dh0)


def _ln_rows(dln):
    """``dgam, dbet, dgc, dbc`` as views of the ``[10H]`` row sums."""
    h = dln.shape[0] // 10
    return (dln[:4 * h].view(4, h), dln[4 * h:8 * h].view(4, h),
            dln[8 * h:9 * h], dln[9 * h:])


def ln_lstm_bwd(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs,
                cs, dhs, dcT, dhT, forget_bias=1.0, masks=None,
                dropout_seed=None, keep_prob=1.0, x_bias=None):
    """Backward of :func:`fused_ln_lstm`: ``(dxs, dxb, dwx, dwh, dgam,
    dbet, dgc, dbc, dc0, dh0)`` (kernel ``srt_ln_lstm_bwd``: the hoisted
    gate recompute, the hoisted layer-norm statistics, the cooperative
    loop with ``dxs`` at its end and the LN-parameter row sum, the
    weight-gradient pass)."""
    if xs.device.type == "cpu":
        return ln_lstm_bwd_reference(xs, wx, wh, ln_gamma, ln_beta,
                                     lnc_gamma, lnc_beta, h0, hs, cs, dhs,
                                     dcT, dhT, forget_bias, masks,
                                     dropout_seed, keep_prob, x_bias)
    args, (dxs, dxb, dwx, dwh, dln, dc0, dh0), _scratch = _ln_lstm_bwd_args(
        xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, h0, hs, cs, dhs,
        dcT, dhT, forget_bias, masks, dropout_seed, keep_prob, x_bias)
    _launch("srt_ln_lstm_bwd", "fused_ln_lstm backward", "fused_ln_lstm_bwd",
            *args)
    return (dxs, dxb, dwx.to(wx.dtype), dwh.to(wh.dtype), *_ln_rows(dln),
            dc0, dh0)


def _hyper_common(xs, w: HyperWeights, x_bias, x_bias_hyper, masks, seed,
                  carries):
    """Validate the HyperLSTM kernels' shared operands; returns ``(dev,
    t, b, d, h, hh, e, w_bf16)``. ``carries``: ``(name, tensor, width)``
    float32 ``[B, width]`` operands (``width`` "h" or "hh")."""
    _check_bias_pair(x_bias, x_bias_hyper)
    if xs.device.type != "cuda":
        raise ValueError(f"the fused RNN kernels run on CUDA or CPU "
                         f"tensors, not {xs.device}")
    dev = xs.device
    t, b, d = xs.shape
    h, hh = w.wh.shape[0], w.whh.shape[0]
    e = w.zd_x.shape[1]
    if not (0 < h <= MAX_HIDDEN and 0 < hh <= MAX_HIDDEN):
        raise ValueError(
            f"hidden sizes {h}/{hh}: the fused HyperLSTM kernels hold one "
            f"thread per main and per auxiliary hidden unit, at most "
            f"{MAX_HIDDEN} each")
    wd = w.wx.dtype
    if wd not in WEIGHT_DTYPES:
        raise TypeError(f"wx has dtype {wd}: the fused RNN kernels take "
                        f"weights in {WEIGHT_DTYPES}")
    f32 = torch.float32
    shapes = {"wx": (d, 4 * h), "b": (4 * h,), "wh": (h, 4 * h),
              "wxh_x": (d, 4 * hh), "wxh_h": (h, 4 * hh), "bh": (4 * hh,),
              "whh": (hh, 4 * hh), "w_hz_x": (hh, 4 * e),
              "b_hz_x": (4 * e,), "w_hz_h": (hh, 4 * e), "b_hz_h": (4 * e,),
              "w_hz_b": (hh, 4 * e), "zd_x": (4, e, h), "zd_h": (4, e, h),
              "zd_b": (4, e, h), "ln_gamma": (4, h), "ln_beta": (4, h),
              "lnc_gamma": (h,), "lnc_beta": (h,)}
    for n in HyperWeights._fields:
        _require(n, getattr(w, n), dev, wd if n in HYPER_MATRICES else f32,
                 shapes[n])
    _require("xs", xs, dev, f32, (t, b, d))
    width = {"h": h, "hh": hh}
    _f32_check(dev, [(n, x, (b, width[k])) for n, x, k in carries]
               + [("x_bias", x_bias, (b, 4 * h)),
                  ("x_bias_hyper", x_bias_hyper, (b, 4 * hh))])
    if masks is not None:
        _require("masks", masks, dev, f32, (t, b, h))
    if seed is not None:
        _require("dropout_seed", seed, dev, torch.int32, ())
    return dev, t, b, d, h, hh, e, int(wd == torch.bfloat16)


def _weight_ptrs(w: HyperWeights):
    return [getattr(w, n).data_ptr() for n in HyperWeights._fields]


# The HyperLSTM forward (``csrc/fused_hyper.cu``, "Design of the
# forward"): one persistent cooperative loop over slices of units x batch
# tiles, five grid barriers a step. Its plan, like the backward's, depends
# on the shape alone (an H100's SMs and shared memory), never on the card.

HYPER_SMS = 132              # an H100's SMs: at most one block on each
HYPER_SMEM_MAX = 232_448     # an H100 block's opt-in shared memory, bytes
HYPER_THREADS = 256          # a loop's threads a block (kLoopThreads)
# (units a LayerNorm slice, split of the products), first fits: a product
# group holds units // split = 8 main units (and at most 8 auxiliary ones)
HYPER_FWD_LAYOUTS = ((16, 2), (8, 1))
HYPER_FWD_MIN_PASS = 16      # the fewest rows a products pass takes
HYPER_FWD_LN_ROWS = 2        # LayerNorm phases: rows a lane and row lane


class HyperFwdPlan(NamedTuple):
    """The forward loop's plan: ``slices`` slices of at most ``units`` main
    units for the LayerNorm phases (the auxiliary units in as many slices),
    at most ``tiles`` batch tiles in each of ``windows`` windows of rows
    (as the other persistent loops cut them); the products on groups of
    ``units // split`` main units (and their share of the auxiliary ones)
    for the rows of ``split`` tiles, ``pchunk`` rows a pass; the LayerNorm
    phases ``chunk`` rows a pass; ``smem`` bytes of shared memory a
    block."""
    units: int
    split: int
    slices: int
    tiles: int
    windows: int
    pchunk: int
    chunk: int
    smem: int


def _hf_aux4(hh, slices, split):
    """A product group's auxiliary units, rounded up to a multiple of 4."""
    n = -(-hh // (slices * split))
    return -(-n // 4) * 4


def _hf_col(k):
    """A resident weight column's floats (``hf_col``): ``k`` rounded up to
    8, and 4 more."""
    return -(-k // 8) * 8 + 4


def _row_stride(n):
    """A staged row's floats (``fwd_row_stride<float>``)."""
    return -(-n // 8) * 8 + 4


def hyper_fwd_smem(units, split, slices, nb, d, h, hh, e, pchunk,
                   chunk) -> int:
    """A forward block's shared memory for LayerNorm tiles of ``nb`` rows
    (``fused_hyper.cu`` ``hyper_fwd_smem_floats``, the same sum): the
    resident columns of its product group (``wh`` of 8 main units,
    ``wxh_h`` and ``whh`` of its auxiliary units at ``_hf_col``'s stride;
    ``wxh_x`` and ``bh``) and of its LayerNorm slice (``wx``, the ``zd``
    columns at stride ``e`` rounded up to 4, plus 4), the slices' unit
    counts, its units' LayerNorm parameters and bias (16 floats each), the
    main and auxiliary cell carries, a products pass's auxiliary sums, and
    a buffer for the most of a products pass's ``h`` and ``hh`` rows, a
    LayerNorm pass's rows of ``z`` (stride ``12e + 4``) or of the gate
    exchange, the ``w_hz`` columns of the slice's share of ``z`` with one
    ``hh`` row (padded by 16 bytes)."""
    a4 = _hf_aux4(hh, slices, split)
    ez = -(-e // 4) * 4 + 4
    zc = 8 if 12 * e % 8 == 0 else 4            # z's share: whole chunks
    zm = -(-(12 * e // zc) // slices) * zc
    buf = max(pchunk * (_row_stride(h) + _row_stride(hh)),
              chunk * max(12 * e + 4, 8 * slices), hh * (zm + 1) + 4)
    floats = ((32 + 4 * a4) * _hf_col(h) + a4 * 4 * (_hf_col(hh) + d + 1)
              + 4 * units * d + 12 * units * ez + 64 + 16 * units
              + nb * units + split * nb * a4 + 2 * pchunk * a4 * 4 + buf)
    return 4 * floats


def hyper_fwd_plan(b, d, h, hh, e, dtype=torch.float32, sms=HYPER_SMS,
                   smem_max=HYPER_SMEM_MAX) -> HyperFwdPlan:
    """The plan of the HyperLSTM forward's loop for ``B`` rows of ``D``
    inputs, ``H`` main and ``HH`` auxiliary units and embeddings ``e``:
    the first of ``HYPER_FWD_LAYOUTS`` and the fewest windows of rows
    whose blocks fit in ``smem_max`` bytes, with ``ceil(max(H, HH) /
    units)`` slices and as many batch tiles as fill the ``sms`` SMs once
    (a multiple of the split). The products take the fewest passes of
    rows that fit, evenly filled, at most as many rows as give every warp
    one task of 16 rows at float (main, auxiliary over h and over hh for
    each 16 rows: two m-tiles at bf16), and not fewer than
    ``HYPER_FWD_MIN_PASS`` where the rows allow; a LayerNorm pass the
    tile's rows, at most one task a warp. The weights sit in shared memory
    as float at either ``dtype``, so the plan is the same at both. Raises
    ``ValueError`` for a shape it cannot hold."""
    if dtype not in WEIGHT_DTYPES:
        raise TypeError(f"weight dtype {dtype}: the HyperLSTM forward takes "
                        f"{WEIGHT_DTYPES}")
    if (b < 1 or d < 1 or e < 1
            or not (0 < h <= MAX_HIDDEN and 0 < hh <= MAX_HIDDEN)):
        raise ValueError(f"HyperLSTM forward: B={b}, D={d}, H={h}, HH={hh}, "
                         f"e={e}")
    warps = HYPER_THREADS // 32
    for units, split in HYPER_FWD_LAYOUTS:
        slices = -(-max(h, hh) // units)
        fill = sms // slices // split * split
        if fill < split:
            continue
        per = 2 + 2 * (_hf_aux4(hh, slices, split) // 4)
        cap = 16 * (warps // per)
        tr = 32 // units * HYPER_FWD_LN_ROWS
        for windows in range(1, b + 1):
            lo, hi = b // windows, -(-b // windows)
            if lo < split:
                break
            tiles = min(hi, fill) // split * split
            nb = max(-(-r // (min(r, fill) // split * split))
                     for r in {lo, hi})
            enb = split * nb
            chunk = min(-(-nb // tr) * tr, warps * tr)
            for passes in range(-(-enb // cap), enb + 1):
                pchunk = -(-enb // passes)
                if pchunk < min(enb, HYPER_FWD_MIN_PASS):
                    break
                smem = hyper_fwd_smem(units, split, slices, nb, d, h, hh, e,
                                      pchunk, chunk)
                if smem <= smem_max:
                    return HyperFwdPlan(units, split, slices, tiles, windows,
                                        pchunk, chunk, smem)
    raise ValueError(f"HyperLSTM forward: B={b}, H={h}, HH={hh}, e={e} does "
                     f"not fit in {smem_max} bytes of shared memory")


def hyper_fwd_work_floats(b, h, e, slices) -> int:
    """Floats of the forward's work scratch (``fused_hyper.cu``
    ``HyperFwdWork``): ``z [B, 12e]``, the layer norms' slice partials
    ``[B, slices, 8 + 2]``, the ``hp = h @ wh`` exchange ``[B, 4H]`` and
    the stash ``[4, B, H]``."""
    return b * (12 * e + 10 * slices + 8 * h)


def _hyper_fwd_args(xs, w: HyperWeights, c0, h0, hc0, hh0, forget_bias,
                    masks, seed, keep_prob, x_bias, x_bias_hyper,
                    residual_dtype):
    """Check the HyperLSTM forward's inputs and allocate its outputs and
    scratch: ``(args, rowblock, outs, scratch)``, the arguments of
    ``srt_hyper_fwd`` and of ``srt_hyper_fwd_rowblock``, ``(hs, cs, hycs,
    hyhs, cT, hT, hcT, hhT)`` and the scratch tensors (the ``h`` and ``hh``
    exchanges ``[2, B, H + HH]`` of the weight dtype, the float32 work),
    which the caller keeps alive while the launches use them (the
    arguments hold only addresses). Raises where :func:`hyper_fwd_plan`
    cannot hold the shape."""
    dev, t, b, d, h, hh, e, wb = _hyper_common(
        xs, w, x_bias, x_bias_hyper, masks, seed,
        (("c0", c0, "h"), ("h0", h0, "h"), ("hc0", hc0, "hh"),
         ("hh0", hh0, "hh")))
    rd = _residual(residual_dtype)
    plan = hyper_fwd_plan(b, d, h, hh, e, w.wx.dtype)
    f32 = torch.float32
    hs = torch.empty((t, b, h), dtype=rd, device=dev)
    cs = torch.empty_like(hs)
    hycs = torch.empty((t, b, hh), dtype=rd, device=dev)
    hyhs = torch.empty_like(hycs)
    cT = torch.empty((b, h), dtype=f32, device=dev)
    hT = torch.empty_like(cT)
    hcT = torch.empty((b, hh), dtype=f32, device=dev)
    hhT = torch.empty_like(hcT)
    xch = torch.empty((2, b, h + hh), dtype=w.wx.dtype, device=dev)
    work = torch.empty((hyper_fwd_work_floats(b, h, e, plan.slices),),
                       dtype=f32, device=dev)
    inputs = (xs.data_ptr(), _ptr(x_bias), _ptr(x_bias_hyper),
              *_weight_ptrs(w), c0.data_ptr(), h0.data_ptr(), hc0.data_ptr(),
              hh0.data_ptr(), _ptr(masks), _ptr(seed), t, b, d, h, hh, e, wb,
              int(rd == torch.bfloat16), *_keep_args(keep_prob),
              float(forget_bias))
    outs = (hs, cs, hycs, hyhs, cT, hT, hcT, hhT)
    outputs = (*(o.data_ptr() for o in outs), _stream(dev))
    args = (*inputs, *plan, xch.data_ptr(), work.data_ptr(), *outputs)
    return args, (*inputs, *outputs), outs, (xch, work)


def hyper_lstm_fwd(xs, w: HyperWeights, c0, h0, hc0, hh0, forget_bias=1.0,
                   masks=None, dropout_seed=None, keep_prob=1.0,
                   x_bias=None, x_bias_hyper=None, residual_dtype=None):
    """Forward of :func:`fused_hyper_lstm`: ``(hs, cs, hycs, hyhs, cT, hT,
    hcT, hhT)`` (kernel ``srt_hyper_fwd``, the cooperative loop on
    :func:`hyper_fwd_plan`). A shape the plan cannot hold raises."""
    if xs.device.type == "cpu":
        return hyper_lstm_fwd_reference(
            xs, w, c0, h0, hc0, hh0, forget_bias, masks, dropout_seed,
            keep_prob, x_bias, x_bias_hyper, residual_dtype)
    args, _, outs, _scratch = _hyper_fwd_args(
        xs, w, c0, h0, hc0, hh0, forget_bias, masks, dropout_seed, keep_prob,
        x_bias, x_bias_hyper, residual_dtype)
    _launch("srt_hyper_fwd", "fused_hyper_lstm forward",
            "fused_hyper_lstm_fwd", *args, lib="fused_hyper")
    return outs


def hyper_lstm_fwd_entries(xs, w: HyperWeights, c0, h0, hc0, hh0,
                           forget_bias=1.0, masks=None, dropout_seed=None,
                           keep_prob=1.0, x_bias=None, x_bias_hyper=None,
                           residual_dtype=None):
    """The C entries behind :func:`hyper_lstm_fwd` on CUDA tensors, for the
    A/B of the forward's two designs; no wrapper calls it, and it counts
    no launch. Returns ``(run, outs)``: ``run(entry)`` launches
    ``"srt_hyper_fwd"`` (the cooperative loop) or
    ``"srt_hyper_fwd_rowblock"`` (the row-block design it replaced) on one
    set of buffers, and keeps the inputs alive (the entries take raw
    addresses); ``outs`` are :func:`hyper_lstm_fwd`'s outputs as the last
    launch left them."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("hyper_lstm_fwd_entries", xs)
    args, rowblock, outs, scratch = _hyper_fwd_args(
        xs, w, c0, h0, hc0, hh0, forget_bias, masks, dropout_seed, keep_prob,
        x_bias, x_bias_hyper, residual_dtype)
    lib = _build.load("fused_hyper")
    held = (scratch, xs, w, c0, h0, hc0, hh0, masks, dropout_seed, x_bias,
            x_bias_hyper)

    def run(entry, _held=held):     # holds the scratch and the inputs
        _build.check(lib, getattr(lib, entry)(
            *(rowblock if entry == "srt_hyper_fwd_rowblock" else args)),
            entry)

    return run, outs


# The HyperLSTM backward (``csrc/fused_hyper.cu``, "Design of the
# backward"): a hoisted recompute into streams, the LN statistics, a
# persistent cooperative loop over slices of units x batch tiles, dxs, the
# eleven matrix gradients on the split-K weight pass, the row sums. The
# loop's plan depends on the shape alone (an H100's SMs and shared memory),
# never on the card, so every sum's order, and every bit of the result, is
# the same on any card that can hold it.

HYPER_LAYOUTS = ((16, 1), (16, 2), (8, 1))   # (units, split), first fits


class HyperBwdPlan(NamedTuple):
    """The loop's plan: ``slices`` slices of at most ``units`` main units
    for the LayerNorm phases (the auxiliary units in as many slices), at
    most ``tiles`` batch tiles in each of ``windows`` windows of rows (as
    the other persistent loops cut them); the transposed products on
    groups of ``units // split`` units for the rows of ``split`` tiles
    (the same blocks, so a block's resident weight rows fit); the main
    product's columns in ``parts`` parts; ``smem`` bytes of shared memory
    a block."""
    units: int
    split: int
    slices: int
    tiles: int
    windows: int
    parts: int
    smem: int


def hyper_bwd_smem(units, split, slices, nb, h, hh, e, parts) -> int:
    """A loop block's shared memory for LN tiles of ``nb`` rows
    (``fused_hyper.cu`` ``hyper_smem_floats``, the same sum): the resident
    rows of ``wh`` and ``wxh_h`` of its ``units // split`` product units,
    of ``whh`` of its product's auxiliary units and of ``w_hz`` of its
    LN slice's, the ``zd`` columns of its LN units, a pass's rows of an
    exchange and of the ``ds`` values (which also stage ``dz`` rows), the
    pairs' ``dh`` and ``dhh``, the product's parts and auxiliary sums, the
    auxiliary pairs' ``dhc``, ``dh_pre`` sums and ``dz . w_hz``."""
    ue, se = units // split, slices * split
    ua, uae = -(-hh // slices), -(-hh // se)
    rows = HYPER_THREADS // units
    enb = split * nb
    floats = (ue * 4 * h + ue * 4 * hh + uae * 4 * hh + ua * 12 * e
              + 12 * units * e + rows * slices * 8 + rows * 12 * units
              + 2 * nb * units + parts * enb * ue + enb * ue + nb * ua * 6)
    return 4 * floats


def hyper_bwd_plan(b, h, hh, e, dtype=torch.float32, sms=HYPER_SMS,
                   smem_max=HYPER_SMEM_MAX) -> HyperBwdPlan:
    """The plan of the HyperLSTM backward's loop for ``B`` rows, ``H``
    main and ``HH`` auxiliary units and embeddings ``e``: the first of
    ``HYPER_LAYOUTS`` (units a slice, product split) and the fewest
    windows of rows whose blocks fit in ``smem_max`` bytes, with
    ``ceil(max(H, HH) / units)`` slices and as many batch tiles as fill
    the ``sms`` SMs once (a multiple of the split). The weights sit in
    shared memory as float at either ``dtype``, so the plan is the same at
    both. ``parts`` splits the main product's ``H + HH`` quads about as the
    auxiliary one's ``HH``. Raises ``ValueError`` for a shape it cannot
    hold."""
    if dtype not in WEIGHT_DTYPES:
        raise TypeError(f"weight dtype {dtype}: the HyperLSTM backward "
                        f"takes {WEIGHT_DTYPES}")
    if b < 1 or not (0 < h <= MAX_HIDDEN and 0 < hh <= MAX_HIDDEN) or e < 1:
        raise ValueError(f"HyperLSTM backward: B={b}, H={h}, HH={hh}, e={e}")
    parts = max(1, min(HYPER_THREADS // 32, -(-(h + hh) // hh)))
    for units, split in HYPER_LAYOUTS:
        slices = -(-max(h, hh) // units)
        fill = sms // slices // split * split
        free = HYPER_THREADS // units * (slices * 8 + 12 * units)
        if fill < 1 or free < 12 * e:   # (d2) stages whole dz rows in it
            continue
        for windows in range(1, b + 1):
            lo, hi = b // windows, -(-b // windows)
            if lo < split:
                break
            # every window's tiles: a multiple of the split
            fits = []
            for rows in {lo, hi} - {0}:
                tiles = min(rows, fill) // split * split
                fits.append(hyper_bwd_smem(units, split, slices,
                                           -(-rows // tiles), h, hh, e,
                                           parts))
            if (min(hi, fill) % split == 0 and min(lo, fill) % split == 0
                    and max(fits) <= smem_max):
                return HyperBwdPlan(units, split, slices, min(hi, fill),
                                    windows, parts, max(fits))
    raise ValueError(f"HyperLSTM backward: H={h}, HH={hh}, e={e} does not "
                     f"fit in {smem_max} bytes of shared memory even at one "
                     f"row")


def hyper_stream_floats(t, b, h, hh, e) -> int:
    """Floats of the backward's streams (``fused_hyper.cu``
    ``carve_streams``): ``pre, xp, hp, sx, sh [T*B, 4H]`` (their gradients
    written over them), ``hyper_pre [T*B, 4HH]`` (``dh_pre`` over it),
    ``z`` and ``dz [T*B, 12e]``, ``hyper_h [T*B, HH]``."""
    return t * b * (5 * 4 * h + 4 * hh + 2 * 12 * e + hh)


def _hyper_vec_width(h, hh, e):
    """dgam 4H | dbet 4H | dgc H | dbc H | db 4H | dbh 4HH | dbhzx 4e |
    dbhzh 4e: the per-row sums the recurrence keeps, summed over rows."""
    return 14 * h + 4 * hh + 8 * e


def hyper_work_floats(t, b, h, hh, e, slices) -> int:
    """Floats of the backward's work scratch (``hyper_work_floats`` in
    ``fused_hyper.cu``): the per-row partials ``[B, P]`` (padded to a
    multiple of 4), the LN loop's exchanges ``[B, slices, 10]``, the
    statistics ``[T*B, 10]`` and the ``dy * gamma`` stash ``[4, B, H]``,
    the ``dz`` exchange ``[B, slices, 12e]``, the ``dh`` and ``dhh``
    exchanges ``[B, H + HH]``."""
    p = _hyper_vec_width(h, hh, e)
    return (-(-b * p // 4) * 4 + b * slices * 10 + t * b * 10 + 4 * b * h
            + b * slices * 12 * e + b * (h + hh))


def hyper_products(d, h, hh, e):
    """The backward's eleven matrix gradients as split-K products
    ``(extra rows, main rows, columns, rounded to the weight dtype)``, in
    launch order: ``x^T dxp``, ``h_prev^T dhp``, ``[x; h_prev;
    hh_prev]^T dh_pre``, ``hyper_h^T dz_p`` (three), ``z_p[g]^T ds_p[g]``
    (twelve, float x float)."""
    return ([(d, 0, 4 * h, True), (0, h, 4 * h, True),
             (d, h + hh, 4 * hh, True)] + [(0, hh, 4 * e, True)] * 3
            + [(0, e, h, False)] * 12)


def hyper_wg_floats(t, b, d, h, hh, e, dtype) -> int:
    """Floats of the partials scratch the products share (one after
    another): the largest ``slices x rows x ldp`` of their plans
    (``_wg_plan`` on the kernel each takes: the tensor cores' chunk for a
    rounded product at bfloat16, else float32's)."""
    most = 0
    for dx, m, n, rnd in hyper_products(d, h, hh, e):
        kdt = dtype if rnd else torch.float32
        p = _wg_plan(t * b, dx, m, n, 0, kdt)
        most = max(most, p.slices * (dx + m) * (-(-n // 4) * 4))
    return most


def hyper_scratch_bytes(t, b, d, h, hh, e, dtype=torch.float32) -> int:
    """The float32 scratch :func:`hyper_lstm_bwd` allocates on the card:
    the streams, the work (on :func:`hyper_bwd_plan`'s slices) and the
    products' partials."""
    plan = hyper_bwd_plan(b, h, hh, e, dtype)
    return 4 * (hyper_stream_floats(t, b, h, hh, e)
                + hyper_work_floats(t, b, h, hh, e, plan.slices)
                + hyper_wg_floats(t, b, d, h, hh, e, dtype))


def hyper_recompute_reference(xs, w: HyperWeights, h0, hh0, hs, hycs, hyhs,
                              forget_bias=1.0, x_bias=None,
                              x_bias_hyper=None):
    """The plain version of the backward's stage 1: every step's forward
    up to the gate block, recomputed for all ``T * B`` row-steps at once
    from the stored residuals (``h_{t-1}`` from ``hs``, ``hh_{t-1}`` from
    ``hyhs``, ``h0``/``hh0`` rounded to their dtype at step 0; the
    auxiliary cell state from ``hycs``), in ``_HyperStep``'s sums. Returns
    a dict of ``[T, B, .]`` tensors: ``hyper_pre``, ``hyper_h`` (rounded
    to the weight dtype, as the products take it), ``z`` (``z_x | z_h |
    z_b``, ``12e``), ``xp``, ``hp``, ``sx``, ``sh``, ``pre``."""
    _check_bias_pair(x_bias, x_bias_hyper)
    t, b, d = xs.shape
    h, hh = w.wh.shape[0], w.whh.shape[0]
    wd = w.wx.dtype
    acc = _acc_dtype(w.wx)
    st = _HyperStep(w, forget_bias, None, None)
    flat = lambda v: v.reshape(t * b, -1)
    x = flat(xs)
    h_prev = flat(torch.cat([h0.to(hs.dtype)[None], hs[:-1]])).to(acc)
    hh_prev = flat(torch.cat([hh0.to(hyhs.dtype)[None], hyhs[:-1]])).to(acc)
    tile = lambda v: v.repeat(t, 1)         # a [B, .] bias per row-step
    hyper_pre = (st.mm(x, "wxh_x") + st.mm(h_prev, "wxh_h") + w.bh
                 + st.mm(hh_prev, "whh"))
    if x_bias_hyper is not None:
        hyper_pre = hyper_pre + tile(x_bias_hyper)
    hi, hg, hf, ho, new_hc = _lstm_gates(hyper_pre, flat(hycs).to(acc), None,
                                         forget_bias)
    new_hh = torch.tanh(new_hc) * ho
    xp = st.mm(x, "wx")
    if x_bias is not None:
        xp = xp + tile(x_bias)
    hp = st.mm(h_prev, "wh")
    z = [st.mm(new_hh, "w_hz_x") + w.b_hz_x, st.mm(new_hh, "w_hz_h")
         + w.b_hz_h, st.mm(new_hh, "w_hz_b")]
    sx, sh, sb = (_block_scale(zp, zd) for zp, zd in
                  zip(z, (w.zd_x, w.zd_h, w.zd_b)))
    pre = sx * xp + sh * hp + sb + w.b
    out = {"hyper_pre": hyper_pre, "hyper_h": _rnd(new_hh, wd),
           "z": torch.cat(z, dim=-1), "xp": xp, "hp": hp, "sx": sx,
           "sh": sh, "pre": pre}
    return {k: v.reshape(t, b, -1) for k, v in out.items()}


def _hyper_bwd_args(xs, w: HyperWeights, h0, hh0, hs, cs, hycs, hyhs, dhs,
                    dcT, dhT, dhcT, dhhT, forget_bias, masks, seed,
                    keep_prob, x_bias, x_bias_hyper):
    """Check the HyperLSTM backward's inputs and allocate its outputs and
    scratch: ``(args, outs, scratch)``, the arguments of
    ``srt_hyper_bwd`` and ``srt_hyper_bwd_stage`` (after the stage), the
    arguments of ``srt_hyper_bwd_rowblock`` (its stream scratch carved
    from the same buffers), ``(dxs, dxb, dxbh, dmat, dvec, dc0, dh0, dhc0,
    dhh0)`` (``dmat`` the float32 matrix gradients by name) and the
    scratch tensors, which the caller keeps alive while the launches use
    them (the arguments hold only addresses). Raises where
    :func:`hyper_bwd_plan` cannot hold the shape."""
    dev, t, b, d, h, hh, e, wb = _hyper_common(
        xs, w, x_bias, x_bias_hyper, masks, seed,
        (("h0", h0, "h"), ("hh0", hh0, "hh"), ("dcT", dcT, "h"),
         ("dhT", dhT, "h"), ("dhcT", dhcT, "hh"), ("dhhT", dhhT, "hh")))
    rb = _residuals_check(dev, t, b, h, hs, cs, dhs)
    for n, x in (("hycs", hycs), ("hyhs", hyhs)):
        _require(n, x, dev, hs.dtype, (t, b, hh))
    plan = hyper_bwd_plan(b, h, hh, e, w.wx.dtype)
    f32 = torch.float32

    def new(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    m = t * b
    streams = new(hyper_stream_floats(t, b, h, hh, e))
    work = new(hyper_work_floats(t, b, h, hh, e, plan.slices))
    wg_floats = hyper_wg_floats(t, b, d, h, hh, e, w.wx.dtype)
    wg_part = new(max(wg_floats, 4))
    dxs = torch.empty_like(xs)
    dxb = torch.empty_like(x_bias) if x_bias is not None else None
    dxbh = torch.empty_like(x_bias_hyper) if x_bias is not None else None
    dmat = {n: new(*getattr(w, n).shape)
            for n in HYPER_MATRICES + ("zd_x", "zd_h", "zd_b")}
    nvec = _hyper_vec_width(h, hh, e)
    dvec = new(nvec)
    dc0, dh0 = new(b, h), new(b, h)
    dhc0, dhh0 = new(b, hh), new(b, hh)
    inputs = (xs.data_ptr(), _ptr(x_bias), _ptr(x_bias_hyper),
              *_weight_ptrs(w), h0.data_ptr(), hh0.data_ptr(), hs.data_ptr(),
              cs.data_ptr(), hycs.data_ptr(), hyhs.data_ptr(), dhs.data_ptr(),
              dcT.data_ptr(), dhT.data_ptr(), dhcT.data_ptr(),
              dhhT.data_ptr(), _ptr(masks), _ptr(seed), t, b, d, h, hh, e,
              wb, rb, *_keep_args(keep_prob), float(forget_bias))
    outputs = (dxs.data_ptr(), _ptr(dxb), _ptr(dxbh),
               *(dmat[n].data_ptr() for n in HYPER_MATRICES),
               dmat["zd_x"].data_ptr(), dmat["zd_h"].data_ptr(),
               dmat["zd_b"].data_ptr(), dvec.data_ptr(), dc0.data_ptr(),
               dh0.data_ptr(), dhc0.data_ptr(), dhh0.data_ptr(), _stream(dev))
    args = (*inputs, *plan, streams.data_ptr(), work.data_ptr(),
            wg_part.data_ptr(), wg_floats, *outputs)
    # the row-block entry's scratch over the same buffers: dpre, dxp, dhp,
    # dsx, dsh, dhpre, zs, dzs (as [3, T*B, 4e]), hhn, part
    w4, at = 4 * h * m, streams.data_ptr()
    offs = [0, w4, 2 * w4, 3 * w4, 4 * w4, 5 * w4, 5 * w4 + 4 * hh * m,
            5 * w4 + 4 * hh * m + 12 * e * m,
            5 * w4 + 4 * hh * m + 24 * e * m]
    rowblock = (*inputs, *(at + 4 * o for o in offs), work.data_ptr(),
                *outputs)
    return args, rowblock, (dxs, dxb, dxbh, dmat, dvec, dc0, dh0, dhc0,
                            dhh0), (streams, work, wg_part)


def _hyper_grad_views(w: HyperWeights, dmat, dvec):
    """The gradients of ``w`` in its slots, as the kernels left them: the
    float32 matrix sums ``dmat``, the vectors as views of ``dvec``."""
    h, hh, e = w.wh.shape[0], w.whh.shape[0], w.zd_x.shape[1]
    dgam, dbet, dgc, dbc, db, dbh, dbzx, dbzh = torch.split(
        dvec, [4 * h, 4 * h, h, h, 4 * h, 4 * hh, 4 * e, 4 * e])
    vec = dict(b=db, bh=dbh, b_hz_x=dbzx, b_hz_h=dbzh,
               ln_gamma=dgam.view(4, h), ln_beta=dbet.view(4, h),
               lnc_gamma=dgc, lnc_beta=dbc)
    return HyperWeights(**{n: dmat[n] if n in dmat else vec[n]
                           for n in HyperWeights._fields})


def hyper_lstm_bwd(xs, w: HyperWeights, h0, hh0, hs, cs, hycs, hyhs, dhs,
                   dcT, dhT, dhcT, dhhT, forget_bias=1.0, masks=None,
                   dropout_seed=None, keep_prob=1.0, x_bias=None,
                   x_bias_hyper=None):
    """Backward of :func:`fused_hyper_lstm`: ``(dxs, dxb, dxbh, dw, dc0,
    dh0, dhc0, dhh0)`` (kernel ``srt_hyper_bwd``: the hoisted recompute,
    the LN statistics, the cooperative loop on :func:`hyper_bwd_plan`,
    dxs, the eleven matrix gradients on the split-K pass, the row sums).
    A shape the plan cannot hold raises."""
    if xs.device.type == "cpu":
        return hyper_lstm_bwd_reference(
            xs, w, h0, hh0, hs, cs, hycs, hyhs, dhs, dcT, dhT, dhcT, dhhT,
            forget_bias, masks, dropout_seed, keep_prob, x_bias,
            x_bias_hyper)
    args, _, outs, _scratch = _hyper_bwd_args(
        xs, w, h0, hh0, hs, cs, hycs, hyhs, dhs, dcT, dhT, dhcT, dhhT,
        forget_bias, masks, dropout_seed, keep_prob, x_bias, x_bias_hyper)
    _launch("srt_hyper_bwd", "fused_hyper_lstm backward",
            "fused_hyper_lstm_bwd", *args, lib="fused_hyper")
    dxs, dxb, dxbh, dmat, dvec, dc0, dh0, dhc0, dhh0 = outs
    g = _hyper_grad_views(w, dmat, dvec)
    dw = g._replace(**{n: getattr(g, n).to(w.wx.dtype)
                       for n in HYPER_MATRICES})
    return dxs, dxb, dxbh, dw, dc0, dh0, dhc0, dhh0


def hyper_lstm_bwd_entries(xs, w: HyperWeights, h0, hh0, hs, cs, hycs, hyhs,
                           dhs, dcT, dhT, dhcT, dhhT, forget_bias=1.0,
                           masks=None, dropout_seed=None, keep_prob=1.0,
                           x_bias=None, x_bias_hyper=None):
    """The C entries behind :func:`hyper_lstm_bwd` on CUDA tensors, for
    the A/B of the backward's two designs; no wrapper calls it, and it
    counts no launch. Returns ``(run, outs)``: ``run(entry, stage=0)``
    launches ``"srt_hyper_bwd"`` (the six stages), ``"srt_hyper_bwd_
    rowblock"`` (the row-block design it replaced) or, with ``stage``
    1-6, ``"srt_hyper_bwd_stage"`` (the recompute, the statistics, the
    loop, dxs, the products or the row sums alone), all on one set of
    buffers, and keeps the inputs alive (the entries take raw addresses);
    ``outs`` are :func:`hyper_lstm_bwd`'s outputs flattened as the last
    launches left them (the matrix gradients float32)."""
    from sketch_rnn_tpu_torch.ops import _build

    _entries_on_cuda("hyper_lstm_bwd_entries", xs)
    args, rowblock, outs, scratch = _hyper_bwd_args(
        xs, w, h0, hh0, hs, cs, hycs, hyhs, dhs, dcT, dhT, dhcT, dhhT,
        forget_bias, masks, dropout_seed, keep_prob, x_bias, x_bias_hyper)
    lib = _build.load("fused_hyper")
    held = (scratch, xs, w, h0, hh0, hs, cs, hycs, hyhs, dhs, dcT, dhT, dhcT,
            dhhT, masks, dropout_seed, x_bias, x_bias_hyper)

    def run(entry, stage=0, _held=held):   # holds the scratch and inputs
        if entry == "srt_hyper_bwd_rowblock":
            _build.check(lib, lib.srt_hyper_bwd_rowblock(*rowblock), entry)
            return
        pre = (stage,) if entry == "srt_hyper_bwd_stage" else ()
        _build.check(lib, getattr(lib, entry)(*pre, *args), entry)

    dxs, dxb, dxbh, dmat, dvec, dc0, dh0, dhc0, dhh0 = outs
    return run, (dxs, dxb, dxbh, *_hyper_grad_views(w, dmat, dvec), dc0,
                 dh0, dhc0, dhh0)


# -- the autograd Functions -------------------------------------------------


def _as_seed(seed, like):
    if seed is None:
        return None
    return torch.as_tensor(seed, dtype=torch.int32).reshape(()).to(
        like.device)


class _FusedLSTMSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, wx, b, wh, c0, h0, masks, seed, forget_bias,
                keep_prob, residual_dtype):
        hs, cs = lstm_seq_fwd(xs, wx, b, wh, c0, h0, forget_bias, masks,
                              seed, keep_prob, residual_dtype)
        ctx.save_for_backward(xs, wx, b, wh, c0, h0, hs, cs, masks, seed)
        ctx.forget_bias, ctx.keep_prob = forget_bias, keep_prob
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xs, wx, b, wh, c0, h0, hs, cs, masks, seed = ctx.saved_tensors
        dwx, db, dwh = lstm_seq_bwd(xs, wx, b, wh, h0, hs, cs,
                                    dhs.contiguous(), ctx.forget_bias, masks,
                                    seed, ctx.keep_prob)
        return (torch.zeros_like(xs), dwx, db, dwh, torch.zeros_like(c0),
                torch.zeros_like(h0), None, None, None, None, None)


def fused_lstm_seq(xs, wx, b, wh, c0, h0, forget_bias: float = 1.0,
                   masks: Optional[torch.Tensor] = None, dropout_seed=None,
                   keep_prob: float = 1.0, residual_dtype=None
                   ) -> torch.Tensor:
    """Sequence-only fused LSTM over ``xs [T, B, D]``: returns ``hs [T,
    B, H]`` alone, in ``residual_dtype`` (float32 when None). ``wx [D,
    4H]``, ``wh [H, 4H]`` (float32 or pre-cast bfloat16), ``b [4H]``,
    carries ``[B, H]``; gates ``(i, g, f, o)``, the forget bias added to
    ``f``. Dropout on the candidate: ``masks [T, B, H]`` or
    ``dropout_seed`` (an int32 scalar) with ``keep_prob``. Only the
    weights are differentiated: the gradients of ``xs``, ``c0`` and
    ``h0`` are zero by definition (the encoder's contract, as in the JAX
    package)."""
    _check_args(wx, wh, masks, dropout_seed, residual_dtype)
    return _FusedLSTMSeq.apply(xs, wx, b, wh, c0, h0, masks,
                               _as_seed(dropout_seed, xs), forget_bias,
                               keep_prob, residual_dtype)


class _FusedLSTM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, wx, b, wh, c0, h0, masks, seed, x_bias,
                forget_bias, keep_prob, residual_dtype):
        hs, cs, cT, hT = lstm_fwd(xs, wx, b, wh, c0, h0, forget_bias, masks,
                                  seed, keep_prob, x_bias, residual_dtype)
        ctx.save_for_backward(xs, wx, b, wh, h0, hs, cs, masks, seed,
                              x_bias)
        ctx.forget_bias, ctx.keep_prob = forget_bias, keep_prob
        return hs, cT, hT

    @staticmethod
    def backward(ctx, dhs, dcT, dhT):
        xs, wx, b, wh, h0, hs, cs, masks, seed, x_bias = ctx.saved_tensors
        dxs, dxb, dwx, db, dwh, dc0, dh0 = lstm_bwd(
            xs, wx, b, wh, h0, hs, cs, dhs.contiguous(), dcT.contiguous(),
            dhT.contiguous(), ctx.forget_bias, masks, seed, ctx.keep_prob,
            x_bias)
        return (dxs, dwx, db, dwh, dc0, dh0, None, None, dxb, None, None,
                None)


def fused_lstm(xs, wx, b, wh, c0, h0, forget_bias: float = 1.0,
               masks: Optional[torch.Tensor] = None, dropout_seed=None,
               keep_prob: float = 1.0, residual_dtype=None,
               x_bias: Optional[torch.Tensor] = None):
    """Fused LSTM over ``xs [T, B, D]`` with its final carry (the
    ``lstm`` decoder's cell): the arguments of :func:`fused_lstm_seq`,
    plus ``x_bias [B, 4H]`` added to every step's pre-activations (the
    projection of time-invariant inputs). Returns ``(hs [T, B, H], (cT,
    hT))``, ``hs`` in ``residual_dtype``, the final carry float32; every
    input is differentiated."""
    _check_args(wx, wh, masks, dropout_seed, residual_dtype)
    hs, cT, hT = _FusedLSTM.apply(xs, wx, b, wh, c0, h0, masks,
                                  _as_seed(dropout_seed, xs), x_bias,
                                  forget_bias, keep_prob, residual_dtype)
    return hs, (cT, hT)


class _FusedLNLSTM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, wx, wh, gam, bet, gc, bc, c0, h0, masks, seed,
                x_bias, forget_bias, keep_prob, residual_dtype):
        hs, cs, cT, hT = ln_lstm_fwd(xs, wx, wh, gam, bet, gc, bc, c0, h0,
                                     forget_bias, masks, seed, keep_prob,
                                     x_bias, residual_dtype)
        ctx.save_for_backward(xs, wx, wh, gam, bet, gc, bc, h0, hs, cs,
                              masks, seed, x_bias)
        ctx.forget_bias, ctx.keep_prob = forget_bias, keep_prob
        return hs, cT, hT

    @staticmethod
    def backward(ctx, dhs, dcT, dhT):
        (xs, wx, wh, gam, bet, gc, bc, h0, hs, cs, masks, seed,
         x_bias) = ctx.saved_tensors
        (dxs, dxb, dwx, dwh, dgam, dbet, dgc, dbc, dc0, dh0) = ln_lstm_bwd(
            xs, wx, wh, gam, bet, gc, bc, h0, hs, cs, dhs.contiguous(),
            dcT.contiguous(), dhT.contiguous(), ctx.forget_bias, masks,
            seed, ctx.keep_prob, x_bias)
        return (dxs, dwx, dwh, dgam, dbet, dgc, dbc, dc0, dh0, None, None,
                dxb, None, None, None)


def fused_ln_lstm(xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0,
                  h0, forget_bias: float = 1.0,
                  masks: Optional[torch.Tensor] = None, dropout_seed=None,
                  keep_prob: float = 1.0, residual_dtype=None,
                  x_bias: Optional[torch.Tensor] = None):
    """Fused LayerNorm-LSTM over ``xs [T, B, D]``: per-gate layer norm
    (``ln_gamma/ln_beta [4, H]``), the cell-state norm (``lnc_gamma /
    lnc_beta [H]``), no linear bias, the forget bias after the norm,
    dropout on the candidate. ``x_bias [B, 4H]`` is added to every
    step's pre-activations (the projection of time-invariant inputs).
    Returns ``(hs [T, B, H], (cT, hT))``, ``hs`` in ``residual_dtype``;
    every input is differentiated."""
    _check_args(wx, wh, masks, dropout_seed, residual_dtype)
    hs, cT, hT = _FusedLNLSTM.apply(
        xs, wx, wh, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0, masks,
        _as_seed(dropout_seed, xs), x_bias, forget_bias, keep_prob,
        residual_dtype)
    return hs, (cT, hT)


_NW = len(HyperWeights._fields)


class _FusedHyperLSTM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, *rest):
        w = HyperWeights(*rest[:_NW])
        (c0, h0, hc0, hh0, masks, seed, x_bias, x_bias_hyper, forget_bias,
         keep_prob, residual_dtype) = rest[_NW:]
        hs, cs, hycs, hyhs, cT, hT, hcT, hhT = hyper_lstm_fwd(
            xs, w, c0, h0, hc0, hh0, forget_bias, masks, seed, keep_prob,
            x_bias, x_bias_hyper, residual_dtype)
        ctx.save_for_backward(xs, *w, h0, hh0, hs, cs, hycs, hyhs, masks,
                              seed, x_bias, x_bias_hyper)
        ctx.forget_bias, ctx.keep_prob = forget_bias, keep_prob
        return hs, cT, hT, hcT, hhT

    @staticmethod
    def backward(ctx, dhs, dcT, dhT, dhcT, dhhT):
        xs, *saved = ctx.saved_tensors
        w = HyperWeights(*saved[:_NW])
        (h0, hh0, hs, cs, hycs, hyhs, masks, seed, x_bias,
         x_bias_hyper) = saved[_NW:]
        dxs, dxb, dxbh, dw, dc0, dh0, dhc0, dhh0 = hyper_lstm_bwd(
            xs, w, h0, hh0, hs, cs, hycs, hyhs, dhs.contiguous(),
            dcT.contiguous(), dhT.contiguous(), dhcT.contiguous(),
            dhhT.contiguous(), ctx.forget_bias, masks, seed, ctx.keep_prob,
            x_bias, x_bias_hyper)
        return (dxs, *dw, dc0, dh0, dhc0, dhh0, None, None, dxb, dxbh,
                None, None, None)


def fused_hyper_lstm(xs, wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x,
                     w_hz_h, b_hz_h, w_hz_b, zd_x, zd_h, zd_b, ln_gamma,
                     ln_beta, lnc_gamma, lnc_beta, c0, h0, hc0, hh0,
                     forget_bias: float = 1.0,
                     masks: Optional[torch.Tensor] = None,
                     dropout_seed=None, keep_prob: float = 1.0,
                     residual_dtype=None,
                     x_bias: Optional[torch.Tensor] = None,
                     x_bias_hyper: Optional[torch.Tensor] = None):
    """Fused HyperLSTM (layer-norm variant) over ``xs [T, B, D]``; the
    weights as :class:`HyperWeights` describes them, carries ``c0, h0 [B,
    H]`` and ``hc0, hh0 [B, HH]``. ``x_bias [B, 4H]`` is added to the
    input projection BEFORE the hyper scaling and ``x_bias_hyper [B,
    4HH]`` to the auxiliary LSTM's pre-activations: pass both or neither.
    Dropout (``masks [T, B, H]`` or ``dropout_seed`` with ``keep_prob``)
    masks the main candidate only. Returns ``(hs [T, B, H], ((cT, hT),
    (hcT, hhT)))``, ``hs`` in ``residual_dtype``, the final carries
    float32; every input is differentiated."""
    w = HyperWeights(wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x,
                     w_hz_h, b_hz_h, w_hz_b, zd_x, zd_h, zd_b, ln_gamma,
                     ln_beta, lnc_gamma, lnc_beta)
    _check_bias_pair(x_bias, x_bias_hyper)
    _check_args(wx, wh, masks, dropout_seed, residual_dtype)
    for n in HYPER_MATRICES:
        if getattr(w, n).dtype != wx.dtype:
            raise TypeError(f"{n} has dtype {getattr(w, n).dtype}, wx "
                            f"{wx.dtype}: the HyperLSTM's matrices share "
                            f"one of {WEIGHT_DTYPES}")
    hs, cT, hT, hcT, hhT = _FusedHyperLSTM.apply(
        xs, *w, c0, h0, hc0, hh0, masks, _as_seed(dropout_seed, xs),
        x_bias, x_bias_hyper, forget_bias, keep_prob, residual_dtype)
    return hs, ((cT, hT), (hcT, hhT))
