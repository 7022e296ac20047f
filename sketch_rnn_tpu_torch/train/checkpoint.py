"""Checkpoint save and restore, in the JAX package's format 1.

The port of ``sketch_rnn_tpu/train/checkpoint.py``. A checkpoint is the
whole training state (parameters, Adam's moments and counts, the step)
plus the data-normalization scale factor, which is part of the model
contract, as a pair of files:

- ``ckpt_<step:08d>.msgpack``: the state as ``flax.serialization``
  writes a JAX ``TrainState`` (``utils/msgpack.py``, byte for byte):
  ``{"params": {...}, "opt_state": {"0": {}, "1": {"0": {"count", "mu",
  "nu"}, "1": {"count"}}}, "step"}``, every map of the parameter trees
  in sorted key order, every leaf (the counts too) an ext-1 array;
- ``ckpt_<step:08d>.json``: ``{format_version, step, scale_factor,
  hps}``, ``hps`` from ``HParams.to_json``.

Each file is written to a temp file and renamed, the sidecar first, so a
crash mid-save leaves at most an orphan that :func:`latest_checkpoint`
and the pruning skip. A checkpoint of either package restores in the
other: the trees map through ``convert.train_state_to_jax`` /
``train_state_from_jax``. :func:`validate_checkpoint` rejects a bad one
with the JAX package's one-line :class:`CheckpointValidationError`,
check for check, in the same order; a msgpack that does not decode
names the port's decoder error where the JAX package names msgpack's.

The fault-injection sites of the JAX module (``ckpt.commit``,
``ckpt.torn``, ``ckpt.load.corrupt``) come with queue 1 item 7.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Tuple

import numpy as np

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.convert import (train_state_from_jax,
                                          train_state_to_jax)
from sketch_rnn_tpu_torch.train.state import TrainState
from sketch_rnn_tpu_torch.utils import msgpack
from sketch_rnn_tpu_torch.utils.faults import retry_call

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")
_ANY_CKPT_RE = re.compile(r"^ckpt_(\d+)\.(?:msgpack|json)(?:\.tmp)?$")

# Version 1: flax-msgpack TrainState + json sidecar {step, scale_factor,
# hps}; sidecars without the field are version 1.
FORMAT_VERSION = 1


def _paths(ckpt_dir: str, step: int) -> Tuple[str, str]:
    base = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    return base + ".msgpack", base + ".json"


def ckpt_id_of(step: int) -> str:
    """The checkpoint's identity, its basename: ``ckpt_00000042``."""
    return f"ckpt_{int(step):08d}"


class CheckpointValidationError(RuntimeError):
    """A checkpoint failed validation: one line naming the file and the
    first offending field (``path`` and ``reason`` carry the split)."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"cannot restore checkpoint {path}: {reason}")


def _base_of(path: str) -> str:
    for ext in (".msgpack.tmp", ".json.tmp", ".msgpack", ".json"):
        if path.endswith(ext):
            return path[:-len(ext)]
    return path


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _state_dict(layout, sort: bool = True):
    """``convert.train_state_to_jax``'s layout as flax's state dict of the
    JAX ``TrainState``; ``sort`` orders the parameter trees' keys, as a
    fetched JAX state has them."""
    params, (_, ((count, mu, nu), (sched,))), step = layout
    srt = _sorted if sort else (lambda t: t)
    return {"params": srt(params),
            "opt_state": {"0": {}, "1": {
                "0": {"count": count, "mu": _sorted(mu), "nu": _sorted(nu)},
                "1": {"count": sched}}},
            "step": step}


def _layout(sd):
    """The inverse of :func:`_state_dict`."""
    adam, sched = sd["opt_state"]["1"]["0"], sd["opt_state"]["1"]["1"]
    return (sd["params"], ((), ((adam["count"], adam["mu"], adam["nu"]),
                                (sched["count"],))), sd["step"])


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _manifest_mismatch(tmpl, got, prefix: str = "") -> Optional[str]:
    """First structural difference, in the template's order, as one line
    naming the field; None when the shape manifests agree."""
    if isinstance(tmpl, dict) or isinstance(got, dict):
        if not (isinstance(tmpl, dict) and isinstance(got, dict)):
            return (f"field {prefix or '<root>'} is "
                    f"{type(got).__name__}, template expects "
                    f"{type(tmpl).__name__}")
        missing = [k for k in tmpl if k not in got]
        if missing:
            return f"field {prefix}{missing[0]} missing from checkpoint"
        extra = [k for k in got if k not in tmpl]
        if extra:
            return f"field {prefix}{extra[0]} not in template"
        for k in tmpl:
            r = _manifest_mismatch(tmpl[k], got[k], f"{prefix}{k}/")
            if r:
                return r
        return None
    ts, gs = _shape(tmpl), _shape(got)
    if ts != gs:
        return (f"field {prefix.rstrip('/') or '<root>'} has shape "
                f"{gs}, template expects {ts}")
    return None


def _first_nonfinite(sd, prefix: str = "") -> Optional[str]:
    if isinstance(sd, dict):
        for k in sd:
            r = _first_nonfinite(sd[k], f"{prefix}{k}/")
            if r:
                return r
        return None
    a = np.asarray(sd)
    if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
        bad = int(a.size - np.isfinite(a).sum())
        return (f"field {prefix.rstrip('/') or '<root>'} has {bad} "
                f"non-finite value(s)")
    return None


def _template_manifest(target: TrainState):
    """The template's state dict with shape-only leaves (no copy from the
    card), in the template's own key order for the parameters, as the
    JAX package walks a freshly made template."""
    a = target.opt_state.adam
    return _state_dict((target.params, ((), (
        (a.count, a.mu, a.nu), (target.opt_state.schedule_count,))),
        target.step), sort=False)


def validate_checkpoint(path: str, target: TrainState, device=None
                        ) -> Tuple[TrainState, float, dict]:
    """Validate the checkpoint at ``path`` (either file of the pair) against
    ``target``'s tree and return ``(state, scale_factor, meta)``, the
    state on ``device`` (the card unless ``device="cpu"``). In order:
    both files exist, the sidecar parses and has ``scale_factor``, the
    format version is known, the msgpack decodes, the shape manifest
    matches the template, and every parameter is finite; each failure
    is one :class:`CheckpointValidationError`."""
    base = _base_of(path)
    data_path, meta_path = base + ".msgpack", base + ".json"
    if not os.path.exists(data_path):
        raise CheckpointValidationError(
            data_path, "msgpack missing (incomplete/torn save)")
    if not os.path.exists(meta_path):
        raise CheckpointValidationError(
            meta_path, "sidecar missing (incomplete/torn save)")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except ValueError as e:
        raise CheckpointValidationError(
            meta_path, f"sidecar is not valid JSON ({e})") from e
    if not isinstance(meta, dict) or "scale_factor" not in meta:
        raise CheckpointValidationError(
            meta_path, "sidecar field scale_factor missing")
    version = meta.get("format_version", 1)
    if version > FORMAT_VERSION:
        raise CheckpointValidationError(
            meta_path,
            f"format_version={version} is newer than this build's "
            f"{FORMAT_VERSION}; refusing to guess at the layout")
    with open(data_path, "rb") as f:
        raw = f.read()
    try:
        restored_sd = msgpack.unpack_state(raw)
    except Exception as e:  # noqa: BLE001 — classified into one line
        raise CheckpointValidationError(
            data_path,
            f"msgpack corrupt or truncated ({len(raw)} bytes: "
            f"{type(e).__name__}: {e})") from e
    bad = _manifest_mismatch(_template_manifest(target), restored_sd)
    if bad:
        raise CheckpointValidationError(
            data_path,
            f"{bad} — the checkpoint was saved from different hparams "
            f"than the template (compare its .json sidecar)")
    bad = _first_nonfinite(restored_sd.get("params", restored_sd))
    if bad:
        raise CheckpointValidationError(data_path, bad)
    try:
        state = train_state_from_jax(_layout(restored_sd), device=device)
    except Exception as e:  # noqa: BLE001
        raise CheckpointValidationError(
            data_path, f"{type(e).__name__}: {e}") from e
    return state, float(meta["scale_factor"]), meta


def host_bytes(host_state: TrainState) -> bytes:
    """The msgpack bytes of a state whose tensors lie on the host."""
    return msgpack.pack_state(_state_dict(train_state_to_jax(host_state)))


def write_checkpoint(ckpt_dir: str, state: TrainState, scale_factor: float,
                     hps: HParams, keep: int = 3, retries: int = 0,
                     retry_backoff_s: float = 0.05) -> str:
    """Serialize ``state`` (fetched to the host on the calling thread
    where it lies on the card) and commit it: the sidecar first, then the
    msgpack, each through a temp file and a rename, then prune to the
    ``keep`` newest complete checkpoints; returns the msgpack's path. The
    commit is idempotent, so ``retries > 0`` retries a transient I/O
    failure with the deterministic backoff of ``utils/faults.py``; a
    permanent failure re-raises."""
    data = host_bytes(state)
    step = int(state.step)

    def _commit() -> str:
        os.makedirs(ckpt_dir, exist_ok=True)
        data_path, meta_path = _paths(ckpt_dir, step)
        meta = {"format_version": FORMAT_VERSION, "step": step,
                "scale_factor": float(scale_factor),
                "hps": json.loads(hps.to_json())}
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, meta_path)
        tmp = data_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, data_path)
        _prune(ckpt_dir, keep)
        return data_path

    if retries <= 0:
        return _commit()
    return retry_call(_commit, retries, retry_backoff_s,
                      describe=f"checkpoint commit to {ckpt_dir}")


# the JAX package's two names: a synchronous save, and the commit that its
# background writer shares (``train/async_ckpt.py``); in the port both
# are the one function, so both paths write the same bytes
save_checkpoint = write_checkpoint


def _complete_steps(ckpt_dir: str) -> list:
    """Steps whose msgpack AND sidecar both exist: the one definition of
    a complete checkpoint, shared by resume and pruning."""
    return sorted(s for name in os.listdir(ckpt_dir)
                  if (m := _CKPT_RE.match(name))
                  and os.path.exists(_paths(ckpt_dir,
                                            s := int(m.group(1)))[1]))


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """Highest completely checkpointed step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, target: TrainState,
                       step: Optional[int] = None, device=None
                       ) -> Tuple[TrainState, float, dict]:
    """Restore ``(state, scale_factor, meta)`` from the latest (or the
    given) step through :func:`validate_checkpoint`; ``target`` fixes
    the tree (``make_train_state`` of the same hparams' parameters)."""
    if step is None:
        step = latest_checkpoint(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    data_path, _ = _paths(ckpt_dir, step)
    return validate_checkpoint(data_path, target, device=device)


def _prune(ckpt_dir: str, keep: int) -> None:
    """Keep the ``keep`` newest complete checkpoints; remove every other
    checkpoint file, orphans and stale ``.tmp`` files included."""
    complete = _complete_steps(ckpt_dir)
    keep_steps = set(complete[-keep:]) if keep > 0 else set(complete)
    for name in os.listdir(ckpt_dir):
        m = _ANY_CKPT_RE.match(name)
        if m and int(m.group(1)) not in keep_steps:
            try:
                os.remove(os.path.join(ckpt_dir, name))
            except OSError:
                pass

