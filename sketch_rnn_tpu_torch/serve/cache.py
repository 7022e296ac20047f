"""Deterministic content-addressed result cache (+ in-flight coalescing).

The port of ``sketch_rnn_tpu/serve/cache.py``. A request's strokes are a
pure function of its content (the engine's per-request determinism
contract) under one model namespace, so two requests with the same
content produce the same strokes and the second need not touch a card:

- **Content addressing.** :func:`request_fingerprint` hashes the
  request's content (the key's two threefry words, z, label,
  temperature, max_len; for the encoder endpoints the endpoint, the
  prefix bytes and the frame count) and the cache's ``(config_hash,
  ckpt_id)`` namespace with blake2b. Scheduling fields (uid, class, queue
  position, arrival, retry attempt) stay out. The byte stream is the JAX
  package's, so one request gives the same digest in both packages.
- **Bounded LRU.** ``max_entries`` / ``max_bytes`` bound the store;
  eviction is pure LRU over the get/put sequence, and the cache keeps
  exact counters (hits, misses, evictions, bytes, coalesced).
- **Hits are the stored Result, bitwise**, with the origin computation's
  uid and ckpt_id.
- **In-flight coalescing** lives in the fleet (``serve/fleet.py``): a
  repeat that arrives while its content is computing waits on it, and
  :meth:`ResultCache.note_coalesced` counts it.

Host-side state under one lock.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np

from sketch_rnn_tpu_torch.utils.prng import key_words


def _hash_prefix(h, arr) -> None:
    """Hash one stroke prefix with its shape as a delimiter: two prefixes
    whose bytes agree but whose row splits differ never collide."""
    a = np.asarray(arr, np.float32)
    h.update(f"<{a.shape}>".encode())
    h.update(a.tobytes())


def request_fingerprint(req, config_hash: str = "",
                        ckpt_id: str = "") -> bytes:
    """blake2b digest of the request's content and the model namespace.

    The key is hashed as its two uint32 words (``b"uint32|"`` and their
    bytes), the JAX package's ``key_data``. A plain generate request
    hashes its z (or ``b"z:none"``); an encoder-endpoint request hashes a
    tagged endpoint name, its prefix (both sketches of an interpolation,
    in order) and its frame count, never the state the planner derives
    from them. ``config_hash`` and ``ckpt_id`` namespace the keyspace.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(config_hash.encode())
    h.update(b"\x00")
    h.update(ckpt_id.encode())
    h.update(b"\x00")
    words = key_words(req.key)
    h.update(str(words.dtype).encode() + b"|")
    h.update(words.tobytes())
    endpoint = getattr(req, "endpoint", "generate") or "generate"
    prefix = getattr(req, "prefix", None)
    if endpoint == "generate" and prefix is None:
        if req.z is None:
            h.update(b"z:none")
        else:
            h.update(np.asarray(req.z, np.float32).tobytes())
    else:
        # the tag byte cannot appear where the generate stream goes on
        # (z bytes or b"z:none"), so the two keyspaces are disjoint
        h.update(b"\x01ep:" + endpoint.encode() + b"\x00")
        if endpoint == "interpolate":
            a, b = prefix
            _hash_prefix(h, a)
            _hash_prefix(h, b)
            h.update(f"|frames:{int(getattr(req, 'frames', 0) or 0)}"
                     .encode())
        else:
            _hash_prefix(h, prefix)
    h.update(f"|{int(req.label)}|{float(req.temperature)!r}|"
             f"{req.max_len}".encode())
    return h.digest()


class CacheEntry:
    """One stored completion: the strokes (an interpolation's frames too,
    counted in ``nbytes``) and the origin's uid, steps and ckpt_id."""

    __slots__ = ("strokes5", "length", "steps", "origin_uid", "nbytes",
                 "endpoint", "frames", "ckpt_id")

    def __init__(self, strokes5: np.ndarray, length: int, steps: int,
                 origin_uid: int, endpoint: str = "generate",
                 frames=None, ckpt_id: str = ""):
        self.strokes5 = strokes5
        self.length = int(length)
        self.steps = int(steps)
        self.origin_uid = int(origin_uid)
        self.nbytes = int(strokes5.nbytes) + (
            0 if frames is None else sum(int(f.nbytes) for f in frames))
        self.endpoint = endpoint or "generate"
        self.frames = frames
        # the version that computed these strokes: a hit re-serves it
        self.ckpt_id = str(ckpt_id or "")


class ResultCache:
    """Bounded-LRU content-addressed store of completed Results.

    ``max_entries`` and ``max_bytes`` both bound the store (0: unbounded
    on that axis); eviction pops the least recently used entry until
    both hold (the byte bound always keeps the newest entry). ``get``
    refreshes recency; a ``put`` of a stored fingerprint keeps the first
    entry.
    """

    def __init__(self, config_hash: str = "", ckpt_id: str = "",
                 max_entries: int = 4096, max_bytes: int = 0):
        if max_entries < 0 or max_bytes < 0:
            raise ValueError(
                f"bounds must be >= 0, got max_entries={max_entries} "
                f"max_bytes={max_bytes}")
        self.config_hash = str(config_hash or "")
        self.ckpt_id = str(ckpt_id or "")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._store: "OrderedDict[bytes, CacheEntry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.coalesced = 0

    def fingerprint(self, req, ckpt_id: Optional[str] = None) -> bytes:
        """Fingerprint under this cache's namespace; ``ckpt_id`` overrides
        the constructor's version label (the fleet passes a tenant's)."""
        return request_fingerprint(
            req, self.config_hash,
            self.ckpt_id if ckpt_id is None else ckpt_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, fp: bytes) -> Optional[CacheEntry]:
        """Lookup and LRU refresh; counts one hit or one miss."""
        with self._lock:
            entry = self._store.get(fp)
            if entry is None:
                self.misses += 1
            else:
                self._store.move_to_end(fp)
                self.hits += 1
        return entry

    def note_coalesced(self) -> None:
        """A repeat attached to an in-flight computation: no device work,
        but no stored hit either."""
        with self._lock:
            self.coalesced += 1

    def put(self, fp: bytes, result) -> None:
        """Store one completed Result (the first entry of a fingerprint
        stays), then evict least recently used entries until the bounds
        hold."""
        entry = CacheEntry(result.strokes5, result.length, result.steps,
                           result.uid,
                           endpoint=getattr(result, "endpoint",
                                            "generate"),
                           frames=getattr(result, "frames", None),
                           ckpt_id=getattr(result, "ckpt_id", ""))
        with self._lock:
            if fp in self._store:
                return
            self._store[fp] = entry
            self._bytes += entry.nbytes
            while ((self.max_entries and
                    len(self._store) > self.max_entries)
                   or (self.max_bytes and self._bytes > self.max_bytes
                       and len(self._store) > 1)):
                _, old = self._store.popitem(last=False)
                self._bytes -= old.nbytes
                self.evictions += 1

    def stats(self) -> Dict[str, Any]:
        """Exact counters. Every arrival does one :meth:`get` (lookups =
        hits + misses); a coalesced repeat missed there and then waited
        on the computation, so ``hit_rate``, the share of arrivals served
        without device work, is (hits + coalesced) / lookups."""
        with self._lock:
            lookups = self.hits + self.misses
            served = self.hits + self.coalesced
            return {
                "entries": len(self._store),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "coalesced": self.coalesced,
                "evictions": self.evictions,
                "lookups": lookups,
                "hit_rate": round(served / max(lookups, 1), 4),
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "config_hash": self.config_hash,
                "ckpt_id": self.ckpt_id,
            }

    def keys(self) -> List[bytes]:
        """LRU order, least recent first."""
        with self._lock:
            return list(self._store)

    def clear(self) -> None:
        """Drop the entries and the counters."""
        with self._lock:
            self._store.clear()
            self._bytes = 0
            self.hits = self.misses = 0
            self.evictions = self.coalesced = 0

    def __repr__(self) -> str:
        s = self.stats()
        return (f"ResultCache({s['entries']} entries, {s['bytes']}B, "
                f"hit_rate {s['hit_rate']}, ckpt={self.ckpt_id!r})")
