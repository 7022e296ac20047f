"""Padded-timestep accounting for (bucketed) batch assembly.

The port of ``sketch_rnn_tpu/utils/profiling.py``'s ``PaddingLedger``:
the same methods and the same metrics-row columns. The JAX package's
ledger also mirrors every count into its telemetry core; the port has no
telemetry core yet, so this one keeps its own counts only.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence


class PaddingLedger:
    """Padded-timestep accounting for batch assembly.

    ``DataLoader._assemble`` records every assembled batch: the pad
    length ``tb`` it was padded to, its row count and its total TRUE
    timesteps. Each training metrics row can then carry the padding-waste
    fraction and the per-bucket batch counts without a device sync.
    Batches are recorded when ASSEMBLED, which leads consumption by at
    most ``prefetch_depth`` batches: window attribution may be off by that
    lead, totals are exact.

    Thread-safe (the prefetch producer thread assembles while the loop
    reads windows). ``edges`` pre-declares the ``bucket_T<edge>_n``
    columns, so the FIRST metrics row already carries every column (a
    CSV's header is its first row's keys).

    The bucket-run scheduler also records the plan's run structure
    (:meth:`note_epoch_plan`: how many maximal same-geometry runs the epoch
    plan holds) and the dispatches it made (:meth:`record_dispatch`: how
    many micro-steps rode how many calls, from the training loop).

    :meth:`window` returns, since the last ``window()`` call:

    - ``padded_frac``: the fraction of dispatched timesteps that were
      padding (``1 - true/dispatched``; 0.0 when nothing was assembled),
    - ``bucket_T<edge>_n``: batches assembled per bucket edge,
    - ``runs_per_epoch`` / ``mean_run_len``: the most recently planned
      epoch's geometry-run count and mean batches per run (0 when no
      bucket plan exists, e.g. fixed-T runs),
    - ``dispatches_saved``: micro-steps minus calls recorded in the
      window (0 under per-batch dispatch).
    """

    def __init__(self, edges: Sequence[int] = ()):
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {int(e): 0 for e in edges}
        self._dispatched = 0   # timesteps shipped (rows * tb)
        self._true = 0         # timesteps inside true sequence lengths
        self._micro = 0        # optimizer micro-steps dispatched
        self._calls = 0        # calls carrying them
        self._epoch_runs = 0   # geometry runs in the last planned epoch
        self._epoch_batches = 0
        self._mark = (0, 0, {}, 0, 0)

    def record(self, tb: int, rows: int, true_steps: int) -> None:
        with self._lock:
            self._counts[int(tb)] = self._counts.get(int(tb), 0) + 1
            self._dispatched += int(rows) * int(tb)
            self._true += int(true_steps)

    def record_dispatch(self, micro_steps: int, dispatches: int) -> None:
        """One scheduler decision: ``micro_steps`` optimizer steps rode
        ``dispatches`` calls (a full K stack is ``(K, 1)``, a run
        remainder of r micro-batches replayed step by step ``(r, r)``)."""
        with self._lock:
            self._micro += int(micro_steps)
            self._calls += int(dispatches)

    def note_epoch_plan(self, n_runs: int, n_batches: int) -> None:
        """Record the run structure of a freshly planned bucket epoch
        (``n_runs`` maximal same-geometry runs over ``n_batches``)."""
        with self._lock:
            self._epoch_runs = int(n_runs)
            self._epoch_batches = int(n_batches)

    @staticmethod
    def _frac(dispatched: int, true: int) -> float:
        return 1.0 - true / dispatched if dispatched else 0.0

    @staticmethod
    def _run_cols(runs: int, batches: int) -> Dict[str, float]:
        return {"runs_per_epoch": runs,
                "mean_run_len": round(batches / runs, 3) if runs else 0.0}

    def window(self) -> Dict[str, float]:
        with self._lock:
            pd, pt, pc, pm, pk = self._mark
            out = {"padded_frac": round(
                self._frac(self._dispatched - pd, self._true - pt), 6)}
            for e in sorted(self._counts):
                out[f"bucket_T{e}_n"] = self._counts[e] - pc.get(e, 0)
            out.update(self._run_cols(self._epoch_runs,
                                      self._epoch_batches))
            out["dispatches_saved"] = ((self._micro - pm)
                                       - (self._calls - pk))
            self._mark = (self._dispatched, self._true, dict(self._counts),
                          self._micro, self._calls)
        return out

    def summary(self) -> Dict[str, float]:
        with self._lock:
            out = {"padded_frac": round(
                self._frac(self._dispatched, self._true), 6),
                "dispatched_timesteps": self._dispatched,
                "true_timesteps": self._true}
            for e in sorted(self._counts):
                out[f"bucket_T{e}_n"] = self._counts[e]
            out.update(self._run_cols(self._epoch_runs,
                                      self._epoch_batches))
            out["micro_steps"] = self._micro
            out["dispatches"] = self._calls
            out["dispatches_saved"] = self._micro - self._calls
        return out
