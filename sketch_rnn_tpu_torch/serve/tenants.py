"""Paged multi-tenant parameters and shared-prefix encode reuse.

The port of ``sketch_rnn_tpu/serve/tenants.py``. N fine-tunes of one
model are served by ONE fleet:

- :class:`TenantStore` keeps one shared *base* tree and, per tenant, a
  sparse *adapter page*: only the leaves that differ from the base, float
  leaves as symmetric-int8 deltas (``serve/quantize.py``'s
  ``quantize_delta``: within ``scale/2`` per element of the true delta),
  the others raw. Pages live on the host as numpy. ``materialize``
  returns the port's tree: the base leaf objects themselves where a page
  is silent (so a zero-delta tenant is the base tree, bitwise), and the
  decoded leaves as tensors on their base leaf's device. The arithmetic
  is the JAX package's numpy, so pages, scales and materialized trees
  equal the JAX package's bit for bit (``convert.py`` keeps the leaf
  names and layouts).
- :class:`PrefixReuseIndex` keys encode work by ``(tenant, prefix hash,
  edge, label)``: identical prefixes across ``complete`` / ``reconstruct``
  / ``interpolate`` requests encode once and reuse the ``(mu, carry,
  prev)`` rows. A second worker racing on a key waits for the first
  (a condition variable), so encode computes equal the distinct keys
  even across replicas.

Registration refuses trees not congruent with the base, which is what
lets a value-paged engine (``ServeEngine(param_args=True)``) page between
tenants by copying values into its resident tensors.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sketch_rnn_tpu_torch.serve.quantize import (QTensor, apply_delta,
                                                 quantize_delta)

BASE_TENANT = ""  # requests with no tenant serve the base tree


def _walk(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield ``(path, leaf)`` in insertion order, paths ``a/b/c``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def tree_nbytes(tree: Any) -> int:
    """Total leaf bytes of a param tree (tensors, arrays, scalars)."""
    return sum(int(_host(leaf).nbytes) for _, leaf in _walk(tree))


def _page_nbytes(entry: Any) -> int:
    if isinstance(entry, QTensor):
        return int(entry.q.nbytes) + 8  # int8 payload + float64 scale
    return int(np.asarray(entry).nbytes)


def _like(value: np.ndarray, base_leaf):
    """A decoded page as its base leaf's kind: a tensor on the leaf's
    device, or the numpy array."""
    if isinstance(base_leaf, torch.Tensor):
        return torch.from_numpy(np.array(value, order="C")).to(
            base_leaf.device)
    return value


class TenantStore:
    """Base param tree + sparse int8-delta adapter pages per tenant.

    ``register(tenant, params)`` diffs ``params`` against the base:
    bitwise-equal leaves are skipped, float leaves of rank >= 1 become
    :class:`QTensor` int8 deltas, the others are stored raw.
    ``materialize(tenant)`` is the tree served for the tenant (module
    docstring), and the tree a single-tenant reference must serve: a
    fine-tune differs from its page decode by up to ``scale/2`` per
    element.
    """

    def __init__(self, base_params: Dict[str, Any],
                 base_ckpt_id: str = "base"):
        if not isinstance(base_params, dict) or not base_params:
            raise ValueError("TenantStore needs a non-empty base param "
                             "tree (nested dict of arrays)")
        self.base = base_params
        self.base_ckpt_id = str(base_ckpt_id or "base")
        self._base_leaves: Dict[str, Any] = dict(_walk(base_params))
        # the base on the host, once: the diffs and the decodes read it
        self._base_host = {p: _host(leaf)
                           for p, leaf in self._base_leaves.items()}
        self.base_nbytes = sum(int(a.nbytes)
                               for a in self._base_host.values())
        # tenant -> {"pages": {path: QTensor | ndarray}, "ckpt_id",
        #            "nbytes", "report"}
        self._adapters: Dict[str, Dict[str, Any]] = {}

    def register(self, tenant: str, params: Dict[str, Any],
                 ckpt_id: str = "") -> Dict[str, Any]:
        """Encode ``params`` as a delta page against the base.

        Returns ``{tenant, pages, nbytes, report}``, the report one row
        per page (``path, shape, scale, bound, max_err``). Raises if the
        tree is not congruent with the base.
        """
        tenant = str(tenant)
        if not tenant:
            raise ValueError("tenant name must be non-empty (the empty "
                             "string names the base tree)")
        if tenant in self._adapters:
            raise ValueError(f"tenant {tenant!r} already registered")
        leaves = dict(_walk(params))
        if set(leaves) != set(self._base_leaves):
            missing = sorted(set(self._base_leaves) - set(leaves))
            extra = sorted(set(leaves) - set(self._base_leaves))
            raise ValueError(
                f"tenant {tenant!r} tree is not congruent with the "
                f"base: missing={missing[:4]} extra={extra[:4]}")
        pages: Dict[str, Any] = {}
        report: List[Dict[str, Any]] = []
        for path, b in self._base_host.items():
            t = _host(leaves[path])
            if b.shape != t.shape:
                raise ValueError(
                    f"tenant {tenant!r} leaf {path!r} shape {t.shape} "
                    f"!= base {b.shape}: adapters must be "
                    f"shape-invariant")
            if b.dtype == t.dtype and np.array_equal(
                    b, t) and not np.any(np.isnan(b)):
                continue  # bitwise the base: no page entry
            if t.ndim >= 1 and np.issubdtype(t.dtype, np.floating):
                qt = quantize_delta(b, t)
                err = float(np.max(np.abs(
                    np.asarray(t, np.float32) - apply_delta(b, qt)))
                ) if t.size else 0.0
                pages[path] = qt
                report.append({"path": path, "shape": tuple(t.shape),
                               "scale": qt.scale,
                               "bound": qt.scale / 2.0, "max_err": err})
            else:
                pages[path] = np.array(t)  # raw page (scalars, ints)
                report.append({"path": path, "shape": tuple(t.shape),
                               "scale": None, "bound": 0.0,
                               "max_err": 0.0})
        nbytes = sum(_page_nbytes(p) for p in pages.values())
        self._adapters[tenant] = {
            "pages": pages,
            "ckpt_id": str(ckpt_id or f"{self.base_ckpt_id}+{tenant}"),
            "nbytes": nbytes,
            "report": report,
        }
        return {"tenant": tenant, "pages": len(pages), "nbytes": nbytes,
                "report": report}

    @property
    def tenants(self) -> List[str]:
        return list(self._adapters)

    def __contains__(self, tenant: str) -> bool:
        return tenant == BASE_TENANT or tenant in self._adapters

    def ckpt_id_of(self, tenant: str) -> str:
        """The serving identity a tenant's Results and cache fingerprints
        carry: distinct per tenant, so the cache isolates tenants."""
        if tenant == BASE_TENANT:
            return self.base_ckpt_id
        return str(self._adapters[tenant]["ckpt_id"])

    def adapter_report(self, tenant: str) -> List[Dict[str, Any]]:
        return list(self._adapters[tenant]["report"])

    def materialize(self, tenant: str) -> Dict[str, Any]:
        """The tree served for ``tenant``: the base leaf objects where its
        page is silent, ``base + dequant(delta)`` (or the raw page) as its
        base leaf's kind where it is not."""
        if tenant == BASE_TENANT:
            return self.base
        pages = self._adapters[tenant]["pages"]

        def build(node, path=""):
            if isinstance(node, dict):
                return {k: build(v, f"{path}/{k}" if path else str(k))
                        for k, v in node.items()}
            entry = pages.get(path)
            if entry is None:
                return node
            if isinstance(entry, QTensor):
                return _like(apply_delta(self._base_host[path], entry),
                             node)
            return _like(entry, node)
        return build(self.base)

    def memory_table(self) -> Dict[str, Any]:
        """Resident bytes (one base tree + every page) against N full
        trees; ``ratio`` is their quotient."""
        n = len(self._adapters)
        adapters = {t: int(a["nbytes"])
                    for t, a in self._adapters.items()}
        resident = self.base_nbytes + sum(adapters.values())
        full = n * self.base_nbytes
        return {
            "tenants": n,
            "base_bytes": int(self.base_nbytes),
            "adapter_bytes": adapters,
            "resident_bytes": int(resident),
            "full_bytes": int(full),
            "ratio": (resident / full) if full else None,
        }


class PrefixReuseIndex:
    """Encode once per distinct ``(tenant, prefix, edge, label)``.

    ``acquire(key)`` returns the stored ``(mu, carry, prev)`` rows (a
    reuse) or claims the key for computation (a compute); a thread racing
    on a claimed key waits for ``fill`` instead of computing again, or
    with ``wait=False`` is told the key is busy. ``abandon`` releases a
    failed claim (uncounted) so a waiter can take over. Host-side numpy,
    shared by a fleet's replicas. Reuse is bitwise safe because the
    encode program's rows are independent of one another at a fixed
    geometry.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries: Dict[tuple, tuple] = {}
        self._inflight: Dict[tuple, bool] = {}
        self.computes = 0
        self.reuses = 0

    @staticmethod
    def key(tenant: str, prefix: np.ndarray, edge: int,
            label: int = 0) -> tuple:
        """The index key of a stroke prefix; its shape is hashed before
        its bytes."""
        a = np.ascontiguousarray(np.asarray(prefix, np.float32))
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(a.shape).encode("utf-8"))
        h.update(a.tobytes())
        return (str(tenant), h.hexdigest(), int(edge), int(label))

    def acquire(self, key: tuple, wait: bool = True
                ) -> Tuple[str, Optional[tuple]]:
        """``("hit", rows)`` or ``("compute", None)``; while another thread
        holds the claim on ``key``, waits, or with ``wait=False`` returns
        ``("busy", None)``."""
        with self._cond:
            while True:
                if key in self._entries:
                    self.reuses += 1
                    return "hit", self._entries[key]
                if key not in self._inflight:
                    self._inflight[key] = True
                    self.computes += 1
                    return "compute", None
                if not wait:
                    return "busy", None
                self._cond.wait()

    def fill(self, key: tuple, rows: tuple) -> None:
        with self._cond:
            self._entries[key] = rows
            self._inflight.pop(key, None)
            self._cond.notify_all()

    def note_reuses(self, n: int) -> None:
        """Count ``n`` more avoided encodes (duplicates within one burst,
        served from one compute)."""
        if n:
            with self._lock:
                self.reuses += int(n)

    def abandon(self, key: tuple) -> None:
        """Release a claim without publishing; ``computes`` counts only
        the claims that were filled."""
        with self._cond:
            if self._inflight.pop(key, None):
                self.computes -= 1
            self._cond.notify_all()

    @property
    def distinct(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"computes": self.computes, "reuses": self.reuses,
                    "distinct": len(self._entries)}
