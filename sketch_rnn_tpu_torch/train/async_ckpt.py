"""Checkpoints committed in the background.

The port of ``sketch_rnn_tpu/train/async_ckpt.py``: ``save()`` starts the
state's copy to the host on the loop thread and hands the rest (the wait
for the copy, the serialization, the commit through
``checkpoint.write_checkpoint``) to a writer thread, so a save does not
stall the loop; at most one save is in flight, and a writer's failure is
raised by the next ``save()`` or ``wait()``.

**The snapshot on the card.** The port's optimizer never updates a
tensor in place (``train/state.py``), so the state's tensors stay as the
step left them for as long as something holds them. ``save()`` copies
each into a pinned host buffer with ``non_blocking=True`` on the current
(training) stream, which orders the copy after the step that made them,
and records an event there; the writer waits on that event before it
reads the buffers. The writer thread keeps the device tensors
referenced until its write ends, so the caching allocator cannot hand
their memory to a later step while the copy is pending. (A ``.cpu()``
on the writer thread would run on that thread's stream and not wait for
the step.) On the CPU the snapshot is the state itself.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.train.checkpoint import write_checkpoint
from sketch_rnn_tpu_torch.train.state import (AdamState, OptState,
                                              TrainState, tree_items,
                                              tree_map)


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def snapshot_to_host(state: TrainState
                     ) -> Tuple[TrainState, Optional[torch.cuda.Event]]:
    """``(host_state, event)``: the state's copy on the host, complete
    once ``event`` (None on the CPU) has completed."""
    if tree_items(state.params)[0][1].device.type == "cpu":
        return state, None
    a = state.opt_state.adam
    host = TrainState(
        tree_map(_to_pinned, state.params),
        OptState(AdamState(a.count, tree_map(_to_pinned, a.mu),
                           tree_map(_to_pinned, a.nu)),
                 state.opt_state.schedule_count), state.step)
    event = torch.cuda.Event()
    event.record()
    return host, event


class AsyncCheckpointer:
    """One-deep background checkpoint writer for one directory, pruned to
    its 3 newest checkpoints. One thread (the loop's) calls
    ``save``/``wait``/``join``."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save(self, state: TrainState, scale_factor: float,
             hps: HParams) -> None:
        """Join the save in flight (raising its failure), start the copy of
        ``state`` to the host, and commit it on a writer thread."""
        self.wait()
        host, event = snapshot_to_host(state)
        self._thread = threading.Thread(
            target=self._write,
            args=(state, host, event, float(scale_factor), hps),
            name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight, if any; re-raise its failure."""
        self.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError(
                f"async checkpoint write to {self.ckpt_dir} failed"
            ) from exc

    def join(self) -> None:
        """Join the save in flight without raising (for ``finally``
        blocks); a failure stays stored for ``wait()``."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    @property
    def failure(self) -> Optional[BaseException]:
        """The stored writer failure, without clearing it."""
        return self._exc

    def _write(self, state: TrainState, host: TrainState,
               event: Optional[torch.cuda.Event], scale_factor: float,
               hps: HParams) -> None:
        # ``state``: the device tensors, held until the copies are read
        try:
            if event is not None:
                event.synchronize()
            write_checkpoint(
                self.ckpt_dir, host, scale_factor, hps,
                retries=hps.ckpt_retries,
                retry_backoff_s=hps.ckpt_retry_backoff_s)
        except BaseException as e:  # noqa: BLE001 — crosses the thread
            self._exc = e
