"""The serving kernels: one K-step decode chunk, one prefix replay.

The port of ``sketch_rnn_tpu/ops/pallas_decode.py``. Two hand-written
CUDA kernels (``csrc/decode.cu``) replace its two Pallas kernels:

- :func:`decode_chunk` replaces ``pallas_decode.decode_chunk``: the
  engine's whole K-step chunk — cell step, ``h @ out_w + out_b``, MDN
  head, inverse-CDF + Box-Muller sampler, done/cap masking with
  END_TOKEN emission — as one launch.
- :func:`replay_chunk` replaces ``pallas_decode.replay_chunk``: the
  teacher-forced prefix replay of the endpoint encode phase, with the
  per-row ``t < seq_len`` liveness mask, returning the final carry.

Both run one persistent cooperative loop (``csrc/decode.cu``, "Design"):
slices of 16 hidden units x batch tiles with their weight columns resident
in shared memory, ``h`` and the layer norms' and projection's partials
exchanged between blocks through a scratch the wrapper allocates, on the
plan of :func:`decode_plan`. :func:`decode_chunk_entries` and
:func:`replay_chunk_entries` also reach the first port's row-block design
(``srt_*_chunk_rowblock``), for the A/B; nothing on the main path does.

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

import threading
from typing import NamedTuple, Optional, Tuple

import torch

from sketch_rnn_tpu_torch.ops import linear as L
from sketch_rnn_tpu_torch.ops import mdn
from sketch_rnn_tpu_torch.utils import prng

SUPPORTED_CELLS = ("lstm", "layer_norm")

decode_chunk_launches = 0
replay_chunk_launches = 0
# the fleet's replicas launch from their own worker threads
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    global decode_chunk_launches, replay_chunk_launches
    decode_chunk_launches = 0
    replay_chunk_launches = 0


def check_cell_kind(kind: str) -> None:
    """Refuse cells the decode kernels do not cover, by name. The JAX
    package has no decode kernel for the hyper cell either: both packages
    serve it through the plain chunk program (``serve/engine.py``)."""
    if kind not in SUPPORTED_CELLS:
        raise ValueError(
            f"the CUDA decode kernels support cells {SUPPORTED_CELLS}, not "
            f"{kind!r} (the hyper cell is served by the engine's plain "
            f"chunk program, never by these kernels)")


def weight_dtype(compute_dtype) -> torch.dtype:
    """The dtype of the kernels' weight matrices at ``compute_dtype``
    (None: float32); any other compute dtype is refused by name."""
    if compute_dtype is None:
        return torch.float32
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"compute_dtype={compute_dtype}: the CUDA decode "
                        f"kernels compute in float32 or bfloat16")
    return compute_dtype


def cast_weights(cell_params, compute_dtype):
    """The decoder cell's ``wx``/``wh`` cast once to the kernels' weight
    dtype, as the engine holds them (``out_w`` goes the same way); the
    products round them to ``compute_dtype`` anyway, so the kernels see
    the same values as with float32 weights."""
    wd = weight_dtype(compute_dtype)
    cp = dict(cell_params)
    cp["wx"], cp["wh"] = cp["wx"].to(wd), cp["wh"].to(wd)
    return cp


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

# The persistent design (``csrc/decode.cu``, "Design"): one cooperative loop
# over slices of 16 hidden units x batch tiles. Its plan depends on the
# shape alone (an H100's SMs and opt-in shared memory), never on the card,
# so every sum's order, and every bit of the result, is the same on any
# card that can hold it; the C side checks it and refuses, never falls back.

SERVE_SMS = 132              # an H100's SMs: at most one block on each
SERVE_SMEM_MAX = 232_448     # an H100 block's opt-in shared memory, bytes
SLICE_UNITS = 16             # hidden units a slice (kSliceUnits)
MAX_SLICES = 32              # H <= 512 (kMaxSlices)
X_DIM = 5                    # stroke-5 inputs (kXd)
PASS_ROWS = 16               # rows a pass of the products (kPass)
POLICIES = ("decode", "replay")


class DecodePlan(NamedTuple):
    """A serving loop's plan: ``slices`` slices of at most 16 units, at most
    ``tiles`` batch tiles in each of ``windows`` windows of rows, ``smem``
    bytes of shared memory a block, and the ``scratch`` bytes the wrapper
    allocates beside the kernel (``hx``, the exchanges, the partials)."""
    slices: int
    tiles: int
    windows: int
    smem: int
    scratch: int


def _al16(n: int) -> int:
    return -(-n // 16) * 16


def _wsize(dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weight dtype {dtype}: the CUDA decode kernels take "
                        f"float32 or bfloat16 weights")
    return 2 if dtype == torch.bfloat16 else 4


def decode_smem(policy: str, wsize: int, h: int, m: int, slices: int,
                nb: int) -> int:
    """A block's shared memory for tiles of ``nb`` rows (``decode.cu``
    ``serve_smem``, the same parts in the same order): the resident wh and
    wx columns ``[H + 5][64]`` of the weight type (bf16 rows padded to 72);
    decode: the slice's ``out_w`` rows ``[16][P]`` as float; the tile's
    ``extra_xp [nb][64]``, ``b [64]``, the slices' unit counts ``[32]``, the
    pairs' ``c`` and ``h`` (decode: and the rounded new ``h``) ``[nb][16]``,
    the pre-activations ``[nb][64]``, x and liveness ``[nb][8]``, the owned
    rows' state ``[nb][2]``; decode: the sampler's raw row, ``out_b``,
    END_TOKEN and scratch; a buffer for a pass's ``h`` rows or a pass's
    rows of the gate exchange."""
    dec = policy == "decode"
    p = 6 * m + 3
    pp, mp = -(-p // 4) * 4, -(-m // 4) * 4
    rs = -(-h // 8) * 8 + 16 // wsize
    buf = max(PASS_ROWS * rs * wsize, PASS_ROWS * slices * 8 * 4)
    return (_al16((h + X_DIM) * (72 if wsize == 2 else 64) * wsize)
            + (_al16(SLICE_UNITS * p * 4) if dec else 0)
            + nb * 64 * 4 + 64 * 4 + MAX_SLICES * 4
            + nb * SLICE_UNITS * 4 * (3 if dec else 2)
            + nb * 64 * 4 + nb * 8 * 4 + _al16(nb * 2 * 4)
            + ((2 * pp + 8 + 2 * mp + 4) * 4 if dec else 0) + _al16(buf))


def serve_scratch_bytes(policy: str, wsize: int, b: int, h: int, m: int,
                        slices: int) -> int:
    """The scratch beside a serving loop (``decode.cu``
    ``serve_scratch_bytes``): ``hx [2, B, H]`` of the weight type (padded to
    16 bytes), the gate exchange ``[B, slices, 8]``; decode: the projection
    partials ``[B, slices, 6M + 3 padded to 4]`` and the stroke exchange
    ``[B, 8]``; the cell exchange ``[B, slices, 2]``; float32 past ``hx``."""
    rows = b * slices
    n = _al16(2 * b * h * wsize) + rows * 8 * 4
    if policy == "decode":
        n += rows * (-(-(6 * m + 3) // 4) * 4) * 4 + b * 8 * 4
    return n + rows * 2 * 4


def decode_plan(b: int, h: int, m: int, dtype=torch.float32,
                policy: str = "decode") -> DecodePlan:
    """The plan of ``policy``'s loop (``"decode"``: :func:`decode_chunk`,
    ``"replay"``: :func:`replay_chunk`, which ignores ``m``) for ``B`` rows,
    ``H`` hidden units, ``M`` mixtures and weights of ``dtype``: ``ceil(H /
    16)`` slices, as many batch tiles as fill the ``SERVE_SMS`` SMs once,
    and the fewest windows of rows whose blocks fit in ``SERVE_SMEM_MAX``
    bytes (windows cut as the other persistent loops cut them). Raises
    ``ValueError`` for a shape it cannot hold."""
    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r}: one of {POLICIES}")
    wsize = _wsize(dtype)
    if b < 1 or m < 1 or not 0 < h <= SLICE_UNITS * MAX_SLICES:
        raise ValueError(f"the serving loop holds B >= 1, M >= 1 and 0 < H "
                         f"<= {SLICE_UNITS * MAX_SLICES}; got B={b}, H={h}, "
                         f"M={m}")
    slices = -(-h // SLICE_UNITS)
    fill = max(1, SERVE_SMS // slices)
    for windows in range(1, b + 1):
        lo, hi = b // windows, -(-b // windows)
        smem = max(decode_smem(policy, wsize, h, m, slices,
                               -(-r // min(r, fill))) for r in {lo, hi})
        if smem <= SERVE_SMEM_MAX:
            return DecodePlan(slices, min(hi, fill), windows, smem,
                              serve_scratch_bytes(policy, wsize, b, h, m,
                                                  slices))
    raise ValueError(f"the serving loop ({policy}): H={h}, M={m} does not "
                     f"fit in {SERVE_SMEM_MAX} bytes of shared memory even at one "
                     f"row a tile")


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


def _cell_args(cell_kind, cp, dev, x_dim, h, wd):
    """Validated cell-param pointers in the C entry points' order;
    ``wx``/``wh`` must be of the weight dtype ``wd``."""
    f32 = torch.float32
    _require("wx", cp["wx"], dev, wd, (x_dim, 4 * h))
    _require("wh", cp["wh"], dev, wd, (h, 4 * h))
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


def _on_cuda(what, c0):
    if c0.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not "
                         f"{c0.device}")


def _decode_args(cell_params, out_w, out_b, c0, h0, prev0, extra, u, temps,
                 t0, done0, caps, end_token, cell_kind, num_mixture,
                 forget_bias, compute_dtype, greedy):
    """Check :func:`decode_chunk`'s inputs and allocate its outputs and
    scratch: ``(args, rowblock, outs, held)``, the arguments of
    ``srt_decode_chunk`` and of ``srt_decode_chunk_rowblock``, ``(strokes,
    c, h, t, done)`` (``done`` int32) and the tensors the launches read
    (the scratch, the hoisted ``extra @ wx[5:]``, ``done0`` as int32), which
    the caller keeps alive while the launches use them (the arguments hold
    only addresses); the loop's plan is :func:`decode_plan`'s."""
    dev = c0.device
    wd = weight_dtype(compute_dtype)
    k, b, _ = u.shape
    h = h0.shape[-1]
    p = 6 * num_mixture + 3
    cp, extra_xp = _hoist(cell_params, extra, prev0.shape[-1],
                          compute_dtype)
    f32, i32 = torch.float32, torch.int32
    cell = _cell_args(cell_kind, cp, dev, prev0.shape[-1], h, wd)
    for n, t, dt, shape in (
            ("out_w", out_w, wd, (h, p)), ("out_b", out_b, f32, (p,)),
            ("c0", c0, f32, (b, h)), ("h0", h0, f32, (b, h)),
            ("prev0", prev0, f32, (b, X_DIM)), ("u", u, f32, (k, b, 4)),
            ("temps", temps, f32, (b,)), ("t0", t0, i32, (b,)),
            ("done0", done0, torch.bool, (b,)), ("caps", caps, i32, (b,)),
            ("end_token", end_token, f32, (X_DIM,))):
        _require(n, t, dev, dt, shape)
    if extra_xp is not None:
        _require("extra @ wx[5:]", extra_xp, dev, f32, (b, 4 * h))
    plan = decode_plan(b, h, num_mixture, wd, "decode")
    done_i = done0.to(i32)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=dev)
    outs = (torch.empty((k, b, X_DIM), dtype=f32, device=dev),
            torch.empty((b, h), dtype=f32, device=dev),
            torch.empty((b, h), dtype=f32, device=dev),
            torch.empty((b,), dtype=i32, device=dev),
            torch.empty((b,), dtype=i32, device=dev))
    inputs = (*cell, out_w.data_ptr(), out_b.data_ptr(), c0.data_ptr(),
              h0.data_ptr(), prev0.data_ptr(),
              None if extra_xp is None else extra_xp.data_ptr(),
              u.data_ptr(), temps.data_ptr(), t0.data_ptr(),
              done_i.data_ptr(), caps.data_ptr(), end_token.data_ptr(), b,
              k, h, num_mixture, int(cell_kind == "layer_norm"), int(greedy),
              int(wd == torch.bfloat16), float(forget_bias))
    outputs = (*(o.data_ptr() for o in outs),
               torch.cuda.current_stream(dev).cuda_stream)
    args = (*inputs, *plan[:4], scratch.data_ptr(), *outputs)
    return args, (*inputs, *outputs), outs, (scratch, extra_xp, done_i)


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

    At ``compute_dtype=torch.bfloat16`` the kernel takes ``wx``, ``wh``
    and ``out_w`` as bfloat16 (:func:`cast_weights`) and rounds each
    product's activation operand to it, accumulating in float32.

    Returns ``(strokes [K, B, 5], c, h, t, done)``. CPU tensors take the
    plain version; CUDA tensors launch the kernel (``srt_decode_chunk``,
    the cooperative loop on :func:`decode_plan`; a shape the plan cannot
    hold raises).
    """
    global decode_chunk_launches
    check_cell_kind(cell_kind)
    weight_dtype(compute_dtype)
    if c0.device.type == "cpu":
        return decode_chunk_reference(
            cell_params, out_w, out_b, c0, h0, prev0, extra, u, temps, t0,
            done0, caps, end_token, cell_kind=cell_kind,
            num_mixture=num_mixture, forget_bias=forget_bias,
            compute_dtype=compute_dtype, greedy=greedy)
    _on_cuda("decode_chunk", c0)
    from sketch_rnn_tpu_torch.ops import _build

    args, _, outs, _held = _decode_args(
        cell_params, out_w, out_b, c0, h0, prev0, extra, u, temps, t0, done0,
        caps, end_token, cell_kind, num_mixture, forget_bias, compute_dtype,
        greedy)
    lib = _build.load("decode")
    _build.check(lib, lib.srt_decode_chunk(*args), "decode_chunk")
    with _count_lock:
        decode_chunk_launches += 1
    strokes, c_out, h_out, t_out, done_out = outs
    return strokes, c_out, h_out, t_out, done_out != 0


def decode_chunk_entries(cell_params, out_w, out_b, c0, h0, prev0,
                         extra: Optional[torch.Tensor], u, temps, t0, done0,
                         caps, end_token, *, cell_kind: str,
                         num_mixture: int, forget_bias: float = 1.0,
                         compute_dtype=None, greedy: bool = False):
    """The C entries behind :func:`decode_chunk` on CUDA tensors, for the
    A/B of its two designs; no wrapper calls it, and it counts no launch.
    Returns ``(run, outs)``: ``run(entry)`` launches ``"srt_decode_chunk"``
    (the cooperative loop) or
    ``"srt_decode_chunk_rowblock"`` (the row-block design it replaced) on
    one set of buffers, and keeps the inputs alive (the entries take raw
    addresses); ``outs`` are ``(strokes, c, h, t, done)`` (``done`` int32)
    as the last launch left them."""
    from sketch_rnn_tpu_torch.ops import _build

    check_cell_kind(cell_kind)
    _on_cuda("decode_chunk_entries", c0)
    args, rowblock, outs, held = _decode_args(
        cell_params, out_w, out_b, c0, h0, prev0, extra, u, temps, t0, done0,
        caps, end_token, cell_kind, num_mixture, forget_bias, compute_dtype,
        greedy)
    lib = _build.load("decode")
    held = (held, cell_params, out_w, out_b, c0, h0, prev0, extra, u, temps,
            t0, done0, caps, end_token)

    def run(entry, _held=held):     # holds the scratch and the inputs
        _build.check(lib, getattr(lib, entry)(
            *(rowblock if entry == "srt_decode_chunk_rowblock" else args)),
            entry)

    return run, outs


def _replay_args(cell_params, c0, h0, xs, extra, seq_len, cell_kind,
                 forget_bias, compute_dtype):
    """:func:`_decode_args` for :func:`replay_chunk`: ``(args, rowblock,
    outs, held)`` with ``outs = (c, h)``."""
    dev = c0.device
    wd = weight_dtype(compute_dtype)
    e, b, x_dim = xs.shape
    h = h0.shape[-1]
    cp, extra_xp = _hoist(cell_params, extra, x_dim, compute_dtype)
    f32 = torch.float32
    cell = _cell_args(cell_kind, cp, dev, x_dim, h, wd)
    for n, t, dt, shape in (
            ("c0", c0, f32, (b, h)), ("h0", h0, f32, (b, h)),
            ("xs", xs, f32, (e, b, X_DIM)),
            ("seq_len", seq_len, torch.int32, (b,))):
        _require(n, t, dev, dt, shape)
    if extra_xp is not None:
        _require("extra @ wx[5:]", extra_xp, dev, f32, (b, 4 * h))
    plan = decode_plan(b, h, 1, wd, "replay")
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=dev)
    outs = (torch.empty((b, h), dtype=f32, device=dev),
            torch.empty((b, h), dtype=f32, device=dev))
    inputs = (*cell, c0.data_ptr(), h0.data_ptr(), xs.data_ptr(),
              None if extra_xp is None else extra_xp.data_ptr(),
              seq_len.data_ptr(), b, e, h, int(cell_kind == "layer_norm"),
              int(wd == torch.bfloat16), float(forget_bias))
    outputs = (*(o.data_ptr() for o in outs),
               torch.cuda.current_stream(dev).cuda_stream)
    args = (*inputs, *plan[:4], scratch.data_ptr(), *outputs)
    return args, (*inputs, *outputs), outs, (scratch, extra_xp)


def replay_chunk(cell_params, c0, h0, xs, extra: Optional[torch.Tensor],
                 seq_len, *, cell_kind: str, forget_bias: float = 1.0,
                 compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced replay of ``xs [E, B, 5]`` from the carry ``(c0,
    h0) [B, H]``; row ``b`` advances only while ``t < seq_len[b]``
    (``[B]`` int32). Returns the final ``(c, h)``. ``compute_dtype`` as
    in :func:`decode_chunk`. CPU tensors take the plain version; CUDA
    tensors launch the kernel (``srt_replay_chunk``, the cooperative loop
    on :func:`decode_plan`'s replay plan)."""
    global replay_chunk_launches
    check_cell_kind(cell_kind)
    weight_dtype(compute_dtype)
    if c0.device.type == "cpu":
        return replay_chunk_reference(
            cell_params, c0, h0, xs, extra, seq_len, cell_kind=cell_kind,
            forget_bias=forget_bias, compute_dtype=compute_dtype)
    _on_cuda("replay_chunk", c0)
    from sketch_rnn_tpu_torch.ops import _build

    args, _, outs, _held = _replay_args(
        cell_params, c0, h0, xs, extra, seq_len, cell_kind, forget_bias,
        compute_dtype)
    lib = _build.load("decode")
    _build.check(lib, lib.srt_replay_chunk(*args), "replay_chunk")
    with _count_lock:
        replay_chunk_launches += 1
    return outs


def replay_chunk_entries(cell_params, c0, h0, xs,
                         extra: Optional[torch.Tensor], seq_len, *,
                         cell_kind: str, forget_bias: float = 1.0,
                         compute_dtype=None):
    """:func:`decode_chunk_entries` for :func:`replay_chunk`:
    ``run("srt_replay_chunk")`` or ``run("srt_replay_chunk_rowblock")`` on
    one set of buffers, uncounted; ``outs = (c, h)``."""
    from sketch_rnn_tpu_torch.ops import _build

    check_cell_kind(cell_kind)
    _on_cuda("replay_chunk_entries", c0)
    args, rowblock, outs, held = _replay_args(
        cell_params, c0, h0, xs, extra, seq_len, cell_kind, forget_bias,
        compute_dtype)
    lib = _build.load("decode")
    held = (held, cell_params, c0, h0, xs, extra, seq_len)

    def run(entry, _held=held):     # holds the scratch and the inputs
        _build.check(lib, getattr(lib, entry)(
            *(rowblock if entry == "srt_replay_chunk_rowblock" else args)),
            entry)

    return run, outs
