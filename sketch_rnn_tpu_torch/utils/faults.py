"""Bounded retries with a deterministic backoff.

The port of ``backoff_s`` and ``retry_call`` of
``sketch_rnn_tpu/utils/faults.py``, which the checkpoint commit retries a
transient I/O failure through. The fault injector and its sites
(``ckpt.commit``, ``ckpt.torn``, ``ckpt.load.corrupt`` and the rest) come
with queue 1 item 7; so does the telemetry counter a retry ticks.
"""

from __future__ import annotations

import time
from typing import Callable


def backoff_s(base_s: float, attempt: int, cap_s: float = 2.0) -> float:
    """``min(cap, base * 2**attempt)``: a pure function of the attempt."""
    if base_s <= 0:
        return 0.0
    return min(cap_s, base_s * (2.0 ** attempt))


def retry_call(fn: Callable, retries: int, backoff_base_s: float = 0.0,
               describe: str = "operation"):
    """``fn()`` with up to ``retries`` retries after an ``Exception``
    (``BaseException``s such as KeyboardInterrupt pass through), sleeping
    :func:`backoff_s` before each; the last failure re-raises."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    for attempt in range(retries + 1):
        if attempt:
            time.sleep(backoff_s(backoff_base_s, attempt - 1))
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — transient by contract
            if attempt >= retries:
                raise
            print(f"[faults] WARNING: {describe} failed "
                  f"(attempt {attempt + 1}/{retries + 1}): {e!r}; "
                  f"retrying in {backoff_s(backoff_base_s, attempt):.2f}s",
                  flush=True)
