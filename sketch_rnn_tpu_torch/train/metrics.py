"""Metric files: console, CSV and JSONL, and the one-window drain.

The port of ``sketch_rnn_tpu/train/metrics.py`` and of ``check_finite``
(``sketch_rnn_tpu/utils/debug.py``). :class:`MetricsWriter` appends one
row per logged step to ``<workdir>/<name>_metrics.{csv,jsonl}``
(``train``, ``valid``, ``test``). :class:`MetricsDrain` starts a log
window's copy to the host when the window is pushed and reads it only
once the next window has been launched, then writes it and runs
``check`` (``check_finite``: training stops at most one window after a
divergent step); the loop flushes it before every save, so a committed
checkpoint's windows were all finite.

The JAX package's rows also carry the columns of its goodput ledger and
throughput meter, and its drain holds a fault site; those come with
queue 1 item 7 (``utils/profiling.py``, ``utils/faults.py``,
``utils/telemetry.py``). The padding ledger's columns are there.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch


def check_finite(scalars: Dict[str, float], step: int) -> None:
    """Raise FloatingPointError naming every non-finite metric."""
    bad = [k for k, v in scalars.items() if not np.isfinite(v)]
    if bad:
        raise FloatingPointError(
            f"non-finite metrics at step {step}: {bad} "
            f"(values {[scalars[k] for k in bad]}); "
            f"restore the previous checkpoint and lower the learning rate "
            f"or enable gradient clipping")


class MetricsWriter:
    """Append-only scalar logger; one row per logged step. With no
    ``workdir`` it writes no file and only logs to the console;
    ``console=False`` (a rank other than the primary) logs nothing
    there."""

    def __init__(self, workdir: Optional[str], name: str = "train",
                 console: bool = True):
        self.workdir = workdir
        self.name = name
        self.console = console
        self._csv_path = None
        self._jsonl_path = None
        self._fields: Optional[Sequence[str]] = None
        self._warned_drops: set = set()
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self._csv_path = os.path.join(workdir, f"{name}_metrics.csv")
            self._jsonl_path = os.path.join(workdir, f"{name}_metrics.jsonl")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": int(step), "wall_time": time.time()}
        row.update({k: (v if isinstance(v, str) else float(v))
                    for k, v in sorted(scalars.items())})
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self._csv_path:
            new = self._fields is None and not os.path.exists(self._csv_path)
            if self._fields is None:
                header = None
                if not new:
                    # resuming into an existing CSV: its header governs
                    # the columns (extra keys dropped, missing ones empty)
                    with open(self._csv_path, newline="") as f:
                        header = next(csv.reader(f), None)
                if header:
                    self._fields = header
                else:
                    # fresh, or left headerless by a crash: (re)write it
                    self._fields = list(row)
                    new = True
            dropped = set(row).difference(self._fields) - self._warned_drops
            if dropped:
                self._warned_drops |= dropped
                print(f"[metrics] WARNING: {os.path.basename(self._csv_path)} "
                      f"drops keys absent from its existing header "
                      f"(CSV resume alignment; the JSONL keeps them): "
                      f"{sorted(dropped)}", file=sys.stderr, flush=True)
            with open(self._csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields,
                                   extrasaction="ignore", restval="")
                if new:
                    w.writeheader()
                w.writerow(row)

    def log_console(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.console:
            return
        parts = " ".join(f"{k}={float(v):.4f}"
                         for k, v in sorted(scalars.items()))
        print(f"[{self.name}] step {step} {parts}", flush=True)


def scalars_from_device(metrics: Dict[str, Any]) -> Dict[str, float]:
    """A dict of 0-dim device metrics as host floats, in one copy: the
    logging path's one device-to-host synchronization."""
    names = list(metrics)
    vals = [metrics[k] for k in names]
    if vals and all(isinstance(v, torch.Tensor) for v in vals):
        vals = torch.stack([v.detach().float().reshape(())
                            for v in vals]).tolist()
    return {k: float(v) for k, v in zip(names, vals)}


class MetricsDrain:
    """One-window deferral queue between the train loop and a writer.

    ``push(step, device_metrics)`` starts this window's copy to the host
    and drains the previous one; ``flush()`` drains the tail. On the card
    the copy is queued on the training stream behind the step that made
    the metrics: one ``torch.stack``, a ``non_blocking`` copy into a pinned
    buffer and an event, as ``async_ckpt.snapshot_to_host`` does. A drain
    waits only on its own window's event, so the host reads window ``n``
    while the card runs window ``n + 1``, which the loop launched first.
    A drained row is written before ``check`` runs, so a divergence leaves
    its record. ``defer=False`` copies, writes and checks inside ``push``.
    """

    def __init__(self, writer: MetricsWriter, defer: bool = True,
                 check: Optional[Callable[[Dict[str, float], int],
                                          None]] = None):
        self.writer = writer
        self.defer = defer
        self._check = check
        self._pending: Optional[tuple] = None

    def push(self, step: int, device_metrics: Dict[str, Any],
             extras: Optional[Dict[str, float]] = None) -> None:
        """``extras``: host floats for the same row (the padding ledger's
        columns), written after the device metrics."""
        staged = (step, _stage(device_metrics), extras)
        if not self.defer:
            self._emit(*staged)
            return
        prev, self._pending = self._pending, staged
        if prev is not None:
            self._emit(*prev)

    def flush(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._emit(*prev)

    def _emit(self, step, staged, extras) -> None:
        names, host, event = staged
        if event is not None:
            event.synchronize()
        scalars = (scalars_from_device(host) if isinstance(host, dict)
                   else dict(zip(names, host.tolist())))
        if extras:
            scalars.update(extras)
        self.writer.write(step, scalars)
        self.writer.log_console(step, scalars)
        if self._check is not None:
            self._check(scalars, step)


def _stage(metrics: Dict[str, Any]) -> tuple:
    """``(names, host, event)``: a window's metrics on their way to the
    host. On the card ``host`` is a pinned float32 vector, complete once
    ``event`` has; otherwise ``host`` is the dict itself and ``event``
    None, read at the drain."""
    names = list(metrics)
    vals = [metrics[k] for k in names]
    if not (vals and all(isinstance(v, torch.Tensor) and v.is_cuda
                         for v in vals)):
        return names, metrics, None
    stacked = torch.stack([v.detach().float().reshape(()) for v in vals])
    host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return names, host, event
