"""The batched autoregressive sampler.

The port of ``sketch_rnn_tpu/sample/sampler.py``. Per step: temperature
on the mixture and pen logits, a mixture component drawn, ``(dx, dy)``
drawn from its bivariate Gaussian with the stds scaled by
``sqrt(temperature)``, a pen state drawn; a row stops at the end-of-sketch
pen state or at its own step cap, and a finished row is frozen to the end
token while the others run on. One call draws ``B`` sketches, each step a
batched ``SketchRNN.decode_step``, so the ``lstm``, ``layer_norm`` and
``hyper`` decoders all sample.

The JAX loop is one ``lax.while_loop`` with no host synchronisation until
the end. Here the loop runs on the host and launches work on the card
without waiting for it: the draws of :data:`DONE_CHECK_EVERY` steps are
made at once, and the host reads ``done.all()`` once every that many
steps, which is the only time it waits for the card before the caller
fetches the result. A run that goes on past the step where every row
finished emits only end tokens into rows already holding them and leaves
every carry, length and done flag as it was, so the strokes and lengths
are those of a step-by-step exit (``tests/test_torch_sample.py``).

Randomness follows the JAX sampler key for key, on the port's bitwise
threefry (``utils/prng.py``): step ``t`` takes ``key, k = split(key)``,
then ``kc, kg, kp = split(k, 3)``; the component is ``categorical(kc,
log_pi / tau)``, the pen ``categorical(kp, pen_logits / tau)`` (both
bitwise JAX's draws), the offsets' noise ``normal(kg, (B, 2))`` (within
1e-6 of JAX's, ``prng.normal``). The chain of step keys is hashed on the
host with Python integers, so no key is hashed step by step on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.data import strokes as S
from sketch_rnn_tpu_torch.ops import mdn
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.device import (Staged, resolve_device,
                                               to_device, tree_to)

END_TOKEN = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0], dtype=torch.float32)
START_TOKEN = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], dtype=torch.float32)

# steps between two reads of ``done.all()``: the sampler's only waits for
# the card, at most ceil(steps / DONE_CHECK_EVERY) a call
DONE_CHECK_EVERY = 8


def step_keys(key, steps: int) -> torch.Tensor:
    """The sampler's per-step keys ``[steps, 2]`` (int64 words, on the
    CPU): ``key, k_t = split(key)`` for ``t = 0 .. steps - 1``, hashed
    with ``prng.threefry2x32`` on Python integers."""
    k0, k1 = (int(w) for w in prng.key_words(key))
    out = np.empty((steps, 2), np.int64)
    for t in range(steps):
        out[t] = prng.threefry2x32(k0, k1, 0, 1)
        k0, k1 = prng.threefry2x32(k0, k1, 0, 0)
    return torch.from_numpy(out)


def _chunk_draws(keys: torch.Tensor, batch_size: int, num_mixture: int):
    """The draws of the steps of ``keys [C, 2]``: the component's and the
    pen's Gumbel noise ``[C, B, M]`` and ``[C, B, 3]`` and the offsets'
    normals ``[C, B, 2]``, each step from ``kc, kg, kp = split(k, 3)``."""
    kc, kg, kp = prng.split(keys, 3).unbind(dim=-2)
    return (prng.gumbel(kc, (batch_size, num_mixture)),
            prng.gumbel(kp, (batch_size, 3)),
            prng.normal(kg, (batch_size, 2)))


def _draw(mp: mdn.MixtureParams, tau: torch.Tensor, greedy: bool,
          g_comp=None, g_pen=None, e=None) -> torch.Tensor:
    """One stroke-5 row per batch element from mixture parameters and
    the step's noise (``g_comp``/``g_pen``: Gumbel noise over the
    components and the pen states; ``e [B, 2]``: standard normals)."""
    if greedy:
        idx = torch.argmax(mp.log_pi, dim=-1)
        pen_idx = torch.argmax(mp.pen_logits, dim=-1)
    else:
        idx = torch.argmax(g_comp + mp.log_pi / tau, dim=-1)
        pen_idx = torch.argmax(g_pen + mp.pen_logits / tau, dim=-1)

    def take(a):
        return a.gather(-1, idx[..., None])[..., 0]

    mu1, mu2 = take(mp.mu1), take(mp.mu2)
    s1, s2 = torch.exp(take(mp.log_s1)), torch.exp(take(mp.log_s2))
    rho = take(mp.rho)
    if greedy:
        dx, dy = mu1, mu2
    else:
        sq = torch.sqrt(tau)
        dx = mu1 + s1 * sq * e[..., 0]
        dy = mu2 + s2 * sq * (rho * e[..., 0]
                              + torch.sqrt(1.0 - torch.square(rho))
                              * e[..., 1])
    # one-hot by comparison: no host round trip on the card
    pen = (pen_idx[..., None] == torch.arange(3, device=pen_idx.device)
           ).to(torch.float32)
    return torch.cat([dx[..., None], dy[..., None], pen], dim=-1)


def sample_from_mixture(mp: mdn.MixtureParams, key: torch.Tensor,
                        temperature, greedy: bool = False) -> torch.Tensor:
    """Draw one stroke-5 row per batch element from MDN parameters
    ``[B, ·]``.

    Temperature ``tau`` scales the component and pen logits by ``1/tau``
    and the Gaussian stds by ``sqrt(tau)``. ``greedy`` takes the argmax
    component, its mean, and the argmax pen state (tau ignored). ``key``
    is a threefry key (``[2]``) on the parameters' device."""
    dev = mp.log_pi.device
    tau = torch.as_tensor(temperature, dtype=torch.float32).to(dev)
    if greedy:
        return _draw(mp, tau, True)
    kc, kg, kp = prng.split(key.to(dev), 3).unbind(dim=-2)
    g_comp = prng.gumbel(kc, tuple(mp.log_pi.shape))
    g_pen = prng.gumbel(kp, tuple(mp.pen_logits.shape))
    e = prng.normal(kg, (*mp.mu1.shape[:-1], 2))
    return _draw(mp, tau, False, g_comp, g_pen, e)


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sampling sharded over a device mesh (mesh=) comes with data "
            "parallelism, ROADMAP queue 1 item 4, in a later slice of the "
            "PyTorch port")


def make_sampler(model, hps: HParams, max_len: Optional[int] = None,
                 greedy: bool = False, mesh=None, device=None):
    """Cached wrapper around :func:`_build_sampler`: one sampler per
    ``(max_len, greedy, device)`` is kept on the model instance, as the
    JAX package keeps its compiled samplers. ``mesh`` (generation sharded
    over a device mesh) is refused: it comes with data parallelism."""
    _refuse_mesh(mesh)
    dev = resolve_device(device)
    cache = getattr(model, "_sampler_cache", None)
    if cache is None:
        cache = model._sampler_cache = {}
    ckey = (int(max_len or hps.max_seq_len), bool(greedy), dev)
    if ckey not in cache:
        cache[ckey] = _build_sampler(model, hps, max_len, greedy,
                                     device=dev)
    return cache[ckey]


def _row_done(stroke: torch.Tensor, done: torch.Tensor, t: int,
              max_steps: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row done update: end-of-sketch pen state, plus the optional
    per-row step cap (a row freezes after emitting ``max_steps``
    strokes)."""
    new_done = done | (stroke[:, 4] > 0.5)
    if max_steps is not None:
        new_done = new_done | (t + 1 >= max_steps)
    return new_done


class Sampler:
    """``fn(params, key, batch_size, z=None, labels=None, temperature=1.0,
    max_steps=None) -> (strokes5 [B, max_len, 5], lengths [B])``, tensors
    on the sampler's device; see :func:`_build_sampler`. ``stats`` holds
    the last call's ``steps`` (the steps it ran) and ``host_syncs`` (its
    reads of ``done``: the times it waited for the card, at most
    ``ceil(steps / check_every)``; the caller's fetch of the result,
    ``utils/device.Staged``, is one more)."""

    def __init__(self, model, hps: HParams, t_max: int, greedy: bool,
                 device: torch.device, check_every: int):
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self.model = model
        self.hps = hps
        self.t_max = t_max
        self.greedy = greedy
        self.device = device
        self.check_every = check_every
        self.stats = {"steps": 0, "host_syncs": 0}
        # the start and end rows on the device, copied once
        self._tokens = (START_TOKEN.to(device), END_TOKEN.to(device))

    def __call__(self, params, key, batch_size: int, z=None, labels=None,
                 temperature=1.0, max_steps=None):
        model, dev, b = self.model, self.device, int(batch_size)
        cell = model.dec
        m = self.hps.num_mixture
        params = tree_to(params, dev)
        if z is not None:
            z = to_device(torch.as_tensor(z, dtype=torch.float32), dev)
        if labels is not None:
            labels = to_device(torch.as_tensor(labels), dev)
        if max_steps is not None:
            max_steps = to_device(torch.as_tensor(max_steps), dev)
        tau = torch.full((), float(temperature), dtype=torch.float32,
                         device=dev)
        keys = (None if self.greedy
                else to_device(step_keys(key, self.t_max), dev))
        start_row, end_row = self._tokens

        carry = cell.carry_leaves(
            model.decoder_initial_carry(params, z, b, device=dev))
        prev = start_row.expand(b, 5)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        length = torch.zeros((b,), dtype=torch.int32, device=dev)
        out = end_row.expand(self.t_max, b, 5).clone()
        syncs = t = 0
        while t < self.t_max:
            stop = min(t + self.check_every, self.t_max)
            if keys is not None:
                g_comp, g_pen, e = _chunk_draws(keys[t:stop], b, m)
            for s in range(stop - t):
                new_carry, raw = model.decode_step(
                    params, cell.carry_from_leaves(carry), prev, z, labels)
                mp = mdn.get_mixture_params(raw, m)
                stroke = (_draw(mp, tau, True) if keys is None else
                          _draw(mp, tau, False, g_comp[s], g_pen[s], e[s]))
                # freeze finished rows: emit end tokens, keep the old carry
                stroke = torch.where(done[:, None], end_row, stroke)
                carry = tuple(torch.where(done[:, None], old, new)
                              for new, old in zip(
                                  cell.carry_leaves(new_carry), carry))
                ended = stroke[:, 4] > 0.5
                # length counts real strokes: live steps that did not
                # draw the end-of-sketch pen state
                length = length + (~done & ~ended).to(torch.int32)
                done = _row_done(stroke, done, t + s, max_steps)
                out[t + s] = stroke
                prev = stroke
            t = stop
            if t < self.t_max:
                syncs += 1
                if bool(done.all()):
                    break
        self.stats = {"steps": t, "host_syncs": syncs}
        # sketches that never drew p3 run the full buffer
        length = torch.where(done, length,
                             torch.full_like(length, self.t_max))
        return out.transpose(0, 1), length


def _build_sampler(model, hps: HParams, max_len: Optional[int] = None,
                   greedy: bool = False, mesh=None, device=None,
                   check_every: int = DONE_CHECK_EVERY) -> Sampler:
    """Build the batched sampler.

    Returns ``fn(params, key, batch_size, z, labels, temperature,
    max_steps) -> (strokes5 [B, max_len, 5], lengths [B])``. ``z`` is
    required when the model is conditional (``[B, Nz]``) and must be None
    otherwise; ``labels`` likewise for class-conditional models.
    ``lengths`` counts rows before the end-of-sketch pen state (or
    ``max_len`` if it never fired); rows past each sketch's end are end
    tokens, so the buffer is valid stroke-5 padding.

    ``max_steps`` (optional, ``[B]`` int): per-row step cap; row ``i``
    freezes to end tokens once it has emitted ``max_steps[i]`` strokes,
    even without drawing the end-of-sketch pen state (its ``length`` is
    then ``max_steps[i]``). The loop runs until EVERY row is done.

    ``check_every``: steps between two reads of ``done.all()``; 1 exits
    at the very step the last row finishes, as the JAX loop does, and any
    value gives the same tensors.
    """
    _refuse_mesh(mesh)
    return Sampler(model, hps, int(max_len or hps.max_seq_len),
                   bool(greedy), resolve_device(device), int(check_every))


def sample(model, params, hps: HParams, key, n: int = 1,
           temperature: float = 1.0, z=None, labels=None,
           max_len: Optional[int] = None, greedy: bool = False,
           scale_factor: float = 1.0, mesh=None, device=None
           ) -> Tuple[list, np.ndarray]:
    """Draw ``n`` sketches; returns a host list of stroke-3 arrays and
    their lengths, on the card unless ``device="cpu"``.

    For conditional models with no ``z`` given, draws z ~ N(0, I) (the
    prior) with ``prng.normal``, within 1e-6 of JAX's draw. Offsets are
    multiplied back by ``scale_factor`` so the output is in data units.
    ``mesh`` is refused (:func:`make_sampler`)."""
    sampler = make_sampler(model, hps, max_len=max_len, greedy=greedy,
                           mesh=mesh, device=device)
    k = torch.from_numpy(prng.key_words(key).astype(np.int64))
    kz, ks = prng.split(k, 2).unbind(dim=-2)
    if hps.conditional and z is None:
        z = prng.normal(kz, (n, hps.z_size))
    if hps.num_classes > 0 and labels is None:
        labels = torch.zeros((n,), dtype=torch.int64)
    strokes5, lengths = Staged(sampler(params, ks, n, z, labels,
                                       temperature)).fetch()
    out = []
    for i in range(n):
        s3 = S.to_normal_strokes(strokes5[i])
        s3[:, 0:2] *= scale_factor
        out.append(s3)
    return out, lengths
