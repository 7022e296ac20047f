"""Int8/bf16 parameter quantization for inference.

The port of ``sketch_rnn_tpu/serve/quantize.py``: the same numpy
arithmetic, so the same weights give bitwise the same arrays, error
reports and serving identities in both packages.

- **int8**: per-tensor symmetric, ``scale = max|w| / 127``, ``q =
  round(w / scale)`` clipped to ``[-127, 127]``, dequantized on load as
  ``q * scale``. The round-trip error is at most ``scale / 2`` per
  element (:func:`max_error_bound`).
- **bfloat16**: round-through-bf16 (round to nearest even, as XLA's
  convert and ``Tensor.to(torch.bfloat16)`` both do); relative error at
  most ``2^-8``. numpy has no bfloat16, so a bf16 :class:`QTensor` keeps
  its storage as a CPU ``torch.bfloat16`` tensor.

Dequant-on-load keeps every consumer unchanged: the engine and the
serving kernels see float32 weights, the quantized ones.
:func:`stamp_ckpt_id` names the serving identity
(``ckpt_00000042:int8``), so every Result says at which precision its
strokes were made. Leaves may be torch tensors (the port's parameter
trees, on any device) or numpy arrays; a dequantized tensor goes back to
its leaf's device. Scalars and integer leaves pass through untouched;
an all-zero tensor gets scale 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

QUANT_MODES = ("float32", "bfloat16", "int8")

# short serving-identity tags (ckpt_id suffixes)
_TAGS = {"int8": "int8", "bfloat16": "bf16"}


@dataclasses.dataclass
class QTensor:
    """One quantized tensor: int8 numpy storage (or a CPU bfloat16
    tensor for mode bfloat16) and the dequant scale."""

    q: Any
    scale: float           # dequant step; 1.0 for bfloat16

    def dequantize(self) -> np.ndarray:
        q = (self.q.float().numpy() if isinstance(self.q, torch.Tensor)
             else np.asarray(self.q, np.float32))
        return (q * np.float32(self.scale)).astype(np.float32)


def check_mode(mode: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(
            f"quantization mode must be one of {QUANT_MODES}, got "
            f"{mode!r}")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _quantize_leaf(w: np.ndarray, mode: str) -> QTensor:
    if mode == "bfloat16":
        return QTensor(q=torch.from_numpy(
            np.ascontiguousarray(w, np.float32)).to(torch.bfloat16),
            scale=1.0)
    amax = float(np.max(np.abs(w))) if w.size else 0.0
    scale = amax / 127.0 if amax > 0.0 else 1.0
    q = np.clip(np.rint(np.asarray(w, np.float64) / scale),
                -127, 127).astype(np.int8)
    return QTensor(q=q, scale=scale)


def _is_quantizable(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dim() >= 1 and leaf.is_floating_point()
    a = np.asarray(leaf)
    return a.ndim >= 1 and np.issubdtype(a.dtype, np.floating)


def quantize_params(params: Dict[str, Any], mode: str
                    ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Pack a param tree at ``mode`` precision.

    Returns ``(packed, report)``: ``packed`` mirrors the nested dict with
    quantizable float leaves replaced by :class:`QTensor`; ``report`` has
    one row per quantized tensor, ``{path, shape, scale, bound,
    max_err}``: the guaranteed per-element error bound and the measured
    round-trip ``max|w - dequant|``.
    """
    check_mode(mode)
    report: List[Dict[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if mode == "float32" or not _is_quantizable(node):
            return node
        w = _host(node).astype(np.float32, copy=False)
        qt = _quantize_leaf(w, mode)
        err = float(np.max(np.abs(w - qt.dequantize()))) if w.size \
            else 0.0
        bound = qt.scale / 2.0 if mode == "int8" \
            else float(np.max(np.abs(w)) * 2.0 ** -8) if w.size else 0.0
        report.append({"path": path, "shape": tuple(w.shape),
                       "scale": qt.scale, "bound": bound,
                       "max_err": err})
        return qt
    return walk(params, ""), report


def dequantize_params(packed: Dict[str, Any]) -> Dict[str, Any]:
    """Unpack a :func:`quantize_params` tree to float32 numpy arrays."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, QTensor):
            return node.dequantize()
        return node
    return walk(packed)


def quantize_for_serving(params: Dict[str, Any], mode: str
                         ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Round params through ``mode`` for serving.

    Returns ``(params', report)``: ``params'`` has the same structure,
    each quantized leaf its dequantized float32 value (a tensor on the
    leaf's device for a tensor leaf, a numpy array for an array leaf), and
    ``report`` the per-tensor error budget. ``float32`` is the identity
    with an empty report.
    """
    check_mode(mode)
    if mode == "float32":
        return params, []
    packed, report = quantize_params(params, mode)

    def walk(node, orig):
        if isinstance(node, dict):
            return {k: walk(v, orig[k]) for k, v in node.items()}
        if not isinstance(node, QTensor):
            return node
        w = node.dequantize()
        if isinstance(orig, torch.Tensor):
            return torch.from_numpy(w).to(orig.device)
        return w
    return walk(packed, params), report


def quantize_delta(base: np.ndarray, target: np.ndarray) -> QTensor:
    """Symmetric-int8 encode of ``target - base`` (the multi-tenant
    adapter pages' storage): within ``scale/2`` per element of the true
    delta; an all-zero delta encodes to ``q == 0, scale == 1``."""
    base = np.asarray(_host(base), np.float32)
    target = np.asarray(_host(target), np.float32)
    if base.shape != target.shape:
        raise ValueError(
            f"adapter delta needs congruent leaves, got base "
            f"{base.shape} vs tenant {target.shape}")
    return _quantize_leaf(np.asarray(target, np.float64)
                          - np.asarray(base, np.float64), "int8")


def apply_delta(base: np.ndarray, delta: QTensor) -> np.ndarray:
    """``base + dequant(delta)`` in float32: the inverse of
    :func:`quantize_delta` within ``scale/2`` per element."""
    return (np.asarray(_host(base), np.float32) + delta.dequantize()
            ).astype(np.float32)


def stamp_ckpt_id(ckpt_id: str, mode: str) -> str:
    """Serving identity of a quantized checkpoint: ``<id>:int8`` /
    ``<id>:bf16``; float32 (and empty ids) pass through unchanged."""
    check_mode(mode)
    if mode == "float32" or not ckpt_id:
        return ckpt_id
    return f"{ckpt_id}:{_TAGS[mode]}"


def max_error_bound(w: np.ndarray, mode: str) -> float:
    """The guaranteed per-element round-trip error bound for ``w``."""
    check_mode(mode)
    w = _host(w)
    if mode == "float32" or not w.size:
        return 0.0
    amax = float(np.max(np.abs(w)))
    if mode == "int8":
        return (amax / 127.0 if amax > 0.0 else 1.0) / 2.0
    return amax * 2.0 ** -8
