"""The serving kernels: one K-step decode chunk, one prefix replay.

The port of ``sketch_rnn_tpu/ops/pallas_decode.py``. Two hand-written
CUDA kernels (``csrc/decode.cu``) replace its two Pallas kernels:

- :func:`decode_chunk` replaces ``pallas_decode.decode_chunk``: the
  engine's whole K-step chunk — cell step, ``h @ out_w + out_b``, MDN
  head, inverse-CDF + Box-Muller sampler, done/cap masking with
  END_TOKEN emission — as one launch, with the carry, the previous
  stroke and t/done held in shared memory across the K steps.
- :func:`replay_chunk` replaces ``pallas_decode.replay_chunk``: the
  teacher-forced prefix replay of the endpoint encode phase, with the
  per-row ``t < seq_len`` liveness mask, returning the final carry.

Beside each kernel is its plain PyTorch version
(:func:`decode_chunk_reference`, :func:`replay_chunk_reference`), which
mirrors ``pallas_decode._cell_step`` / ``_sample_rows`` op for op. The
public functions take the plain version only for CPU tensors; for CUDA
tensors they launch the kernel or raise. The source note in
``csrc/decode.cu`` gives each kernel's bound on the H100 and what its
design does about it.

As in the JAX package, the loop-invariant input projection of the
time-invariant features (z, class embedding), ``extra @ wx[5:]``, is
computed once per call outside the kernel, and the per-step uniforms
are drawn outside it with the engine's ``fold_in(request_key, t)``
discipline (:func:`make_uniforms`).

``decode_chunk_launches`` / ``replay_chunk_launches`` count kernel
launches (never plain-version calls), so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sketch_rnn_tpu_torch.ops import linear as L
from sketch_rnn_tpu_torch.ops import mdn
from sketch_rnn_tpu_torch.utils import prng

SUPPORTED_CELLS = ("lstm", "layer_norm")

decode_chunk_launches = 0
replay_chunk_launches = 0


def reset_launch_counts() -> None:
    global decode_chunk_launches, replay_chunk_launches
    decode_chunk_launches = 0
    replay_chunk_launches = 0


def check_cell_kind(kind: str) -> None:
    """Refuse cells the decode kernels do not cover, by name."""
    if kind not in SUPPORTED_CELLS:
        raise ValueError(
            f"the CUDA decode kernels support cells {SUPPORTED_CELLS}, not "
            f"{kind!r} (the hyper cell comes with a later slice of the "
            f"PyTorch port)")


def check_compute_dtype(compute_dtype) -> None:
    if compute_dtype is not None:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype} is not served yet: bfloat16 "
            f"compute comes with a later slice of the PyTorch port (with "
            f"the training kernels); serve compute_dtype=float32")


def make_uniforms(key_data: torch.Tensor, t0: torch.Tensor, chunk: int
                  ) -> torch.Tensor:
    """Pre-draw the chunk's per-slot-step uniforms ``[K, B, 4]``.

    Step ``s`` of slot ``b`` gets ``uniform(fold_in(keys[b], t0[b] + s),
    (4,))`` — bitwise the JAX engine's draw for every live step. A done
    slot's draws are never used (its stroke is END_TOKEN and its carry
    is frozen). ``key_data [B, 2]``: threefry key words (int64 holding
    uint32, see ``utils/prng.py``)."""
    steps = t0.to(torch.int64)[None, :] + torch.arange(
        chunk, dtype=torch.int64, device=t0.device)[:, None]
    kstep = prng.fold_in(
        key_data[None].expand(chunk, *key_data.shape), steps)
    return prng.uniform(kstep, (4,))


def _hoist(cell_params, extra, x_dim: int, compute_dtype):
    """Split off the time-invariant rows of the input weight: returns the
    cell params with ``wx[:x_dim]`` and ``extra @ wx[x_dim:]`` (or None)."""
    if extra is None:
        return cell_params, None
    cp = dict(cell_params)
    wx = cp["wx"]
    cp["wx"] = wx[:x_dim]
    return cp, L.matmul(extra, wx[x_dim:], compute_dtype)


def _cell_step(cell_kind: str, cp, c, h, x, extra_xp, forget_bias,
               compute_dtype):
    """One cell step, ``pallas_decode._cell_step``'s association:
    ``pre = ((x @ wx + extra_xp) [+ b]) + h @ wh``; gates (i, g, f, o)."""
    xp = L.matmul(x, cp["wx"], compute_dtype)
    if extra_xp is not None:
        xp = xp + extra_xp
    if cell_kind == "lstm":
        xp = xp + cp["b"]
    pre = xp + L.matmul(h, cp["wh"], compute_dtype)
    gates = torch.chunk(pre, 4, dim=-1)
    if cell_kind == "layer_norm":
        gates = [L.layer_norm(g, cp["ln_gamma"][j], cp["ln_beta"][j])
                 for j, g in enumerate(gates)]
    i, g, f, o = gates
    new_c = c * torch.sigmoid(f + forget_bias) \
        + torch.sigmoid(i) * torch.tanh(g)
    out_c = new_c
    if cell_kind == "layer_norm":
        out_c = L.layer_norm(new_c, cp["lnc_gamma"], cp["lnc_beta"])
    new_h = torch.tanh(out_c) * torch.sigmoid(o)
    return new_c, new_h


def sample_mixture_rows(mp: mdn.MixtureParams, u: torch.Tensor,
                temps: torch.Tensor, greedy: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw one stroke-5 row per slot from four uniforms ``u [B, 4]``:
    inverse-CDF for the mixture component (``u[0]``) and the pen state
    (``u[1]``), Box-Muller for the offsets (``u[2:]``); temperature
    divides the logits and scales sigma by ``sqrt(tau)``. The port of
    ``serve/engine.sample_mixture_rows`` (and of
    ``pallas_decode._sample_rows``): the same formulas in the same order.

    Also returns each row's CDF margin: the distance of ``u[0]`` / ``u[1]``
    from the nearest CDF edge that decides a draw (``inf`` when greedy).
    Two implementations that round differently can draw differently
    only when that margin is at the rounding level."""
    tau = temps[:, None]
    m = mp.log_pi.shape[-1]
    if greedy:
        idx = torch.argmax(mp.log_pi, dim=-1)
        pen_idx = torch.argmax(mp.pen_logits, dim=-1)
        margin = torch.full_like(temps, float("inf"))
    else:
        cdf = torch.cumsum(mdn.softmax(mp.log_pi / tau), dim=-1)
        idx = torch.clamp_max((u[:, 0:1] > cdf).sum(dim=-1), m - 1)
        pen_cdf = torch.cumsum(mdn.softmax(mp.pen_logits / tau), dim=-1)
        pen_idx = torch.clamp_max((u[:, 1:2] > pen_cdf).sum(dim=-1), 2)
        margin = torch.cat([(u[:, 0:1] - cdf[:, :m - 1]).abs(),
                            (u[:, 1:2] - pen_cdf[:, :2]).abs()],
                           dim=-1).amin(dim=-1)

    def take(a):
        return a.gather(-1, idx[:, None])[:, 0]

    mu1, mu2 = take(mp.mu1), take(mp.mu2)
    if greedy:
        dx, dy = mu1, mu2
    else:
        s1, s2 = torch.exp(take(mp.log_s1)), torch.exp(take(mp.log_s2))
        rho = take(mp.rho)
        r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[:, 2], 1e-12)))
        theta = (2.0 * torch.pi) * u[:, 3]
        e0, e1 = r * torch.cos(theta), r * torch.sin(theta)
        sq = torch.sqrt(temps)
        dx = mu1 + s1 * sq * e0
        dy = mu2 + s2 * sq * (rho * e0
                              + torch.sqrt(1.0 - torch.square(rho)) * e1)
    pen = torch.nn.functional.one_hot(pen_idx, 3).to(torch.float32)
    return torch.cat([dx[:, None], dy[:, None], pen], dim=-1), margin


# -- plain PyTorch versions -------------------------------------------------


def decode_chunk_reference(cell_params, out_w, out_b, c0, h0, prev0,
                           extra: Optional[torch.Tensor], u, temps, t0,
                           done0, caps, end_token, *, cell_kind: str,
                           num_mixture: int, forget_bias: float = 1.0,
                           compute_dtype=None, greedy: bool = False,
                           return_margin: bool = False):
    """The plain PyTorch version of :func:`decode_chunk`, on any device.

    ``return_margin=True`` appends each row's smallest CDF margin over
    its live steps (see :func:`sample_mixture_rows`)."""
    check_cell_kind(cell_kind)
    cp, extra_xp = _hoist(cell_params, extra, prev0.shape[-1],
                          compute_dtype)
    c, h, prev, t, done = c0, h0, prev0, t0, done0
    margin = torch.full_like(temps, float("inf"))
    strokes = []
    for s in range(u.shape[0]):
        new_c, new_h = _cell_step(cell_kind, cp, c, h, prev, extra_xp,
                                  forget_bias, compute_dtype)
        raw = L.matmul(new_h, out_w, compute_dtype) + out_b
        mp = mdn.get_mixture_params(raw, num_mixture)
        stroke, m = sample_mixture_rows(mp, u[s], temps, greedy)
        live = ~done
        margin = torch.where(live, torch.minimum(margin, m), margin)
        stroke = torch.where(live[:, None], stroke, end_token[None])
        c = torch.where(live[:, None], new_c, c)
        h = torch.where(live[:, None], new_h, h)
        t = t + live.to(t.dtype)
        done = done | (stroke[:, 4] > 0.5) | (live & (t >= caps))
        prev = stroke
        strokes.append(stroke)
    out = (torch.stack(strokes), c, h, t, done)
    return out + (margin,) if return_margin else out


def replay_chunk_reference(cell_params, c0, h0, xs,
                           extra: Optional[torch.Tensor], seq_len, *,
                           cell_kind: str, forget_bias: float = 1.0,
                           compute_dtype=None):
    """The plain PyTorch version of :func:`replay_chunk`, on any device."""
    check_cell_kind(cell_kind)
    cp, extra_xp = _hoist(cell_params, extra, xs.shape[-1], compute_dtype)
    c, h = c0, h0
    for s in range(xs.shape[0]):
        new_c, new_h = _cell_step(cell_kind, cp, c, h, xs[s], extra_xp,
                                  forget_bias, compute_dtype)
        live = (s < seq_len)[:, None]
        c = torch.where(live, new_c, c)
        h = torch.where(live, new_h, h)
    return c, h


# -- the kernels --------------------------------------------------------------


def _require(name, t, dev, dtype, shape):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _cell_args(cell_kind, cp, dev, x_dim, h):
    """Validated cell-param pointers in the C entry points' order."""
    f32 = torch.float32
    _require("wx", cp["wx"], dev, f32, (x_dim, 4 * h))
    _require("wh", cp["wh"], dev, f32, (h, 4 * h))
    if cell_kind == "lstm":
        _require("b", cp["b"], dev, f32, (4 * h,))
        return [cp["wx"].data_ptr(), cp["wh"].data_ptr(),
                cp["b"].data_ptr(), None, None, None, None]
    for n, shape in (("ln_gamma", (4, h)), ("ln_beta", (4, h)),
                     ("lnc_gamma", (h,)), ("lnc_beta", (h,))):
        _require(n, cp[n], dev, f32, shape)
    return [cp["wx"].data_ptr(), cp["wh"].data_ptr(), None,
            cp["ln_gamma"].data_ptr(), cp["ln_beta"].data_ptr(),
            cp["lnc_gamma"].data_ptr(), cp["lnc_beta"].data_ptr()]


def decode_chunk(cell_params, out_w, out_b, c0, h0, prev0,
                 extra: Optional[torch.Tensor], u, temps, t0, done0, caps,
                 end_token, *, cell_kind: str, num_mixture: int,
                 forget_bias: float = 1.0, compute_dtype=None,
                 greedy: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """Run K fused decode steps (see the module docstring).

    Args (float32 unless named; B slots, K steps, H hidden, M mixtures):
      cell_params: the decoder cell's dict (``wx [5+E, 4H]``, ``wh``,
        ``b`` or the layer-norm set).
      out_w, out_b: MDN projection ``[H, 6M+3]`` / ``[6M+3]``.
      c0, h0: chunk-entry carry ``[B, H]``; prev0: previous stroke
        ``[B, 5]``.
      extra: time-invariant decoder features ``[B, E]`` or None.
      u: pre-drawn uniforms ``[K, B, 4]`` (:func:`make_uniforms`).
      temps: ``[B]``; t0 ``[B]`` int32; done0 ``[B]`` bool; caps ``[B]``
        int32; end_token: the frozen-slot stroke row ``[5]``.

    Returns ``(strokes [K, B, 5], c, h, t, done)``. CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    global decode_chunk_launches
    check_cell_kind(cell_kind)
    check_compute_dtype(compute_dtype)
    if c0.device.type == "cpu":
        return decode_chunk_reference(
            cell_params, out_w, out_b, c0, h0, prev0, extra, u, temps, t0,
            done0, caps, end_token, cell_kind=cell_kind,
            num_mixture=num_mixture, forget_bias=forget_bias,
            greedy=greedy)
    if c0.device.type != "cuda":
        raise ValueError(f"decode_chunk runs on CUDA or CPU tensors, not "
                         f"{c0.device}")
    from sketch_rnn_tpu_torch.ops import _build

    dev = c0.device
    k, b, _ = u.shape
    h = h0.shape[-1]
    p = 6 * num_mixture + 3
    cp, extra_xp = _hoist(cell_params, extra, prev0.shape[-1], None)
    f32, i32 = torch.float32, torch.int32
    args = _cell_args(cell_kind, cp, dev, prev0.shape[-1], h)
    for n, t, dt, shape in (
            ("out_w", out_w, f32, (h, p)), ("out_b", out_b, f32, (p,)),
            ("c0", c0, f32, (b, h)), ("h0", h0, f32, (b, h)),
            ("prev0", prev0, f32, (b, 5)), ("u", u, f32, (k, b, 4)),
            ("temps", temps, f32, (b,)), ("t0", t0, i32, (b,)),
            ("done0", done0, torch.bool, (b,)), ("caps", caps, i32, (b,)),
            ("end_token", end_token, f32, (5,))):
        _require(n, t, dev, dt, shape)
    if extra_xp is not None:
        _require("extra @ wx[5:]", extra_xp, dev, f32, (b, 4 * h))
    done_i = done0.to(i32)
    strokes = torch.empty((k, b, 5), dtype=f32, device=dev)
    c_out = torch.empty((b, h), dtype=f32, device=dev)
    h_out = torch.empty((b, h), dtype=f32, device=dev)
    t_out = torch.empty((b,), dtype=i32, device=dev)
    done_out = torch.empty((b,), dtype=i32, device=dev)
    lib = _build.load("decode")
    err = lib.srt_decode_chunk(
        *args, out_w.data_ptr(), out_b.data_ptr(), c0.data_ptr(),
        h0.data_ptr(), prev0.data_ptr(),
        None if extra_xp is None else extra_xp.data_ptr(), u.data_ptr(),
        temps.data_ptr(), t0.data_ptr(), done_i.data_ptr(),
        caps.data_ptr(), end_token.data_ptr(), b, k, h, num_mixture,
        int(cell_kind == "layer_norm"), int(greedy), float(forget_bias),
        strokes.data_ptr(), c_out.data_ptr(), h_out.data_ptr(),
        t_out.data_ptr(), done_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "decode_chunk")
    decode_chunk_launches += 1
    return strokes, c_out, h_out, t_out, done_out != 0


def replay_chunk(cell_params, c0, h0, xs, extra: Optional[torch.Tensor],
                 seq_len, *, cell_kind: str, forget_bias: float = 1.0,
                 compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced replay of ``xs [E, B, 5]`` from the carry ``(c0,
    h0) [B, H]``; row ``b`` advances only while ``t < seq_len[b]``
    (``[B]`` int32). Returns the final ``(c, h)``. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    global replay_chunk_launches
    check_cell_kind(cell_kind)
    check_compute_dtype(compute_dtype)
    if c0.device.type == "cpu":
        return replay_chunk_reference(
            cell_params, c0, h0, xs, extra, seq_len, cell_kind=cell_kind,
            forget_bias=forget_bias)
    if c0.device.type != "cuda":
        raise ValueError(f"replay_chunk runs on CUDA or CPU tensors, not "
                         f"{c0.device}")
    from sketch_rnn_tpu_torch.ops import _build

    dev = c0.device
    e, b, x_dim = xs.shape
    h = h0.shape[-1]
    cp, extra_xp = _hoist(cell_params, extra, x_dim, None)
    f32 = torch.float32
    args = _cell_args(cell_kind, cp, dev, x_dim, h)
    for n, t, dt, shape in (
            ("c0", c0, f32, (b, h)), ("h0", h0, f32, (b, h)),
            ("xs", xs, f32, (e, b, 5)),
            ("seq_len", seq_len, torch.int32, (b,))):
        _require(n, t, dev, dt, shape)
    if extra_xp is not None:
        _require("extra @ wx[5:]", extra_xp, dev, f32, (b, 4 * h))
    c_out = torch.empty((b, h), dtype=f32, device=dev)
    h_out = torch.empty((b, h), dtype=f32, device=dev)
    lib = _build.load("decode")
    err = lib.srt_replay_chunk(
        *args, c0.data_ptr(), h0.data_ptr(), xs.data_ptr(),
        None if extra_xp is None else extra_xp.data_ptr(),
        seq_len.data_ptr(), b, e, h, int(cell_kind == "layer_norm"),
        float(forget_bias), c_out.data_ptr(), h_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "replay_chunk")
    replay_chunk_launches += 1
    return c_out, h_out
