"""Serving cost attribution.

The one piece of ``sketch_rnn_tpu/utils/telemetry.py`` the serving
engine needs; the telemetry core, spans and exporters come with a later
slice.
"""

from __future__ import annotations

from typing import List


def attribute_chunk_steps(chunk_steps: int, n_live: int) -> List[int]:
    """Deterministic integer split of one chunk's device steps over its
    live slots: every live slot gets ``chunk // n``, the first ``chunk %
    n`` slots (ascending slot order) one extra, so the shares sum to
    ``chunk_steps`` exactly in integers."""
    if n_live < 1:
        raise ValueError(f"n_live must be >= 1, got {n_live}")
    base, extra = divmod(int(chunk_steps), n_live)
    return [base + 1 if i < extra else base for i in range(n_live)]
