"""The input pipeline: a producer thread that assembles the next batches
and starts their transfer while the card runs the current step.

The port of ``sketch_rnn_tpu/data/prefetch.py``. :class:`Prefetcher`
runs one producer thread ahead of the consumer by a bounded queue, so
batches come in the producer's order and the loader's RNG draws the same
values as a synchronous feed: turning prefetch on or off changes no
result, only where the host's time goes. :class:`SyncFeeder` is the same
interface on the calling thread (``depth <= 0``).

:func:`prefetch_batches` builds the feeder over a loader's
``next_batch`` draws, ``stack`` of them stacked ``[K, ...]`` a ``get()``
for the K-step call, with ``transfer_dtype``:

- ``"bfloat16"``: the strokes cast on the host after stacking, into a
  copy of the batch (round to nearest even, as the JAX package's
  ml_dtypes cast; numpy has no bfloat16, so that leaf is a
  ``torch.bfloat16`` tensor). The model upcasts on entry.
- ``"int16"``: the loader quantizes the offsets back to integer data
  units by its ``scale_factor`` and adds a ``"transfer_scale"`` ``[B]``
  leaf; the model divides by it on entry, which for an integer-origin
  corpus gives the float32 batch bit for bit. A corpus whose scale is
  under 5 is refused with the JAX package's message.

``device`` says where batches go: ``None`` hands over the loader's numpy
dicts; ``"cpu"`` CPU tensors; a CUDA device, tensors on the card, copied
by the producer thread through pinned memory on a stream of its own.
``mesh`` (the JAX package's argument, ``parallel/mesh.py``): each host
batch is the global batch, and the producer hands this rank its rows of
it (``shard_batch``, before any cast or copy), on its own card. Each
batch carries an event recorded after its copies, and ``get()`` makes
the consumer's current stream wait on it and marks the tensors as used
there, so a copy never queues behind the step it overlaps and the
allocator does not hand out a tensor's memory while a step still reads
it.

Each feeder keeps ``timings``: the producer's host seconds by part
(``assemble`` is the loader's draws, the int16 quantization and the
stacking; ``cast``, ``pin``, ``copy``), the batches it made, and the
consumer's seconds waiting in ``get()`` over its ``gets`` (the JAX
package's ``assemble``/``transfer`` spans and the loop's ``feeder_wait``).

A loader with ``bucket_edges`` composes with ``stack=K`` through the
bucket-run scheduler: each ``get()`` is ``loader.next_stack(K)``, up to
K batches of one geometry run stacked ``[k, B, Tb + 1, 5]`` with ``k <=
K`` (the training loop replays a short stack step by step); the
micro-batches are the loader's ``next_batch`` stream.

The ``prefetch_queue_depth`` gauge and the ``data.batch`` fault site come
with telemetry and faults (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sketch_rnn_tpu_torch.parallel.mesh import shard_batch


def stack_batches(batches) -> Dict[str, np.ndarray]:
    """Loader dicts stacked ``[K, ...]`` on a new leading axis."""
    return {k: np.stack([np.asarray(b[k]) for b in batches])
            for k in batches[0]}


def _timings() -> Dict[str, float]:
    return {"assemble_s": 0.0, "cast_s": 0.0, "pin_s": 0.0, "copy_s": 0.0,
            "batches": 0, "wait_s": 0.0, "gets": 0}


class Prefetcher:
    """Bounded look-ahead around a ``producer() -> batch`` callable.

    - ``get()`` returns batches in exactly the order the producer yields
      them (one producer thread).
    - A producer exception is raised again by the next ``get()``.
    - ``close()`` (or leaving the context manager) stops the thread; it
      is idempotent and never blocks on a full queue.

    ``receive(item) -> batch``, when given, runs on the consumer's thread
    in ``get()`` (the card's stream handover).
    """

    _SENTINEL = object()

    def __init__(self, producer: Callable[[], Any], depth: int = 2,
                 receive: Optional[Callable[[Any], Any]] = None,
                 timings: Optional[Dict[str, float]] = None):
        if depth <= 0:
            raise ValueError(f"prefetch depth must be positive, got {depth}")
        self._producer = producer
        self._receive = receive
        self.timings = _timings() if timings is None else timings
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="batch-prefetch", daemon=True)
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._put(self._producer())
        except BaseException as e:  # noqa: BLE001 — must cross the thread
            self._exc = e
            self._put(self._SENTINEL)

    def _put(self, item: Any) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    # -- consumer side -----------------------------------------------------

    def get(self) -> Any:
        """The next batch; raises a producer failure again; blocks while
        the producer is healthy."""
        if self._stop.is_set():
            raise RuntimeError("Prefetcher is closed")
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._exc is not None and self._q.empty():
                    raise self._exc
                if not self._thread.is_alive() and self._q.empty():
                    if self._exc is not None:
                        raise self._exc
                    raise RuntimeError("prefetch thread died unexpectedly")
                continue
            if item is self._SENTINEL:
                raise self._exc  # type: ignore[misc]
            if self._receive is not None:
                item = self._receive(item)
            self.timings["wait_s"] += time.perf_counter() - t0
            self.timings["gets"] += 1
            return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


class SyncFeeder:
    """:class:`Prefetcher`'s interface on the calling thread (depth 0):
    each ``get()`` assembles and transfers one batch. The synchronous feed
    the overlapped one is measured against."""

    def __init__(self, producer: Callable[[], Any],
                 receive: Optional[Callable[[Any], Any]] = None,
                 timings: Optional[Dict[str, float]] = None):
        self._producer = producer
        self._receive = receive
        self.timings = _timings() if timings is None else timings

    def get(self) -> Any:
        t0 = time.perf_counter()
        item = self._producer()
        if self._receive is not None:
            item = self._receive(item)
        self.timings["wait_s"] += time.perf_counter() - t0
        self.timings["gets"] += 1
        return item

    def close(self) -> None:
        pass

    def __enter__(self) -> "SyncFeeder":
        return self

    def __exit__(self, *exc_info) -> None:
        pass


def _card_transfer(device: torch.device, timings: Dict[str, float]):
    """``(send, receive)`` for a CUDA ``device``: ``send(batch)`` on the
    producer's thread pins each leaf and copies it to the card on the
    producer's own stream, then records an event; ``receive`` on the
    consumer's thread makes the current stream wait on that event and
    marks every tensor as used by that stream."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    device = torch.device("cuda", index)
    state = {}

    def send(batch):
        if "stream" not in state:
            torch.cuda.set_device(device)
            state["stream"] = torch.cuda.Stream(device)
        stream = state["stream"]
        t0 = time.perf_counter()
        pinned = {k: torch.as_tensor(v).pin_memory()
                  for k, v in batch.items()}
        t1 = time.perf_counter()
        with torch.cuda.stream(stream):
            out = {k: v.to(device, non_blocking=True)
                   for k, v in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        timings["pin_s"] += t1 - t0
        timings["copy_s"] += time.perf_counter() - t1
        return out, ready

    def receive(item):
        out, ready = item
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ready)
        for v in out.values():
            v.record_stream(cur)
        return out

    return send, receive


def prefetch_batches(loader, device=None, depth: int = 2, stack: int = 1,
                     transfer_dtype: Optional[str] = None, mesh=None):
    """A feeder over ``loader.next_batch()`` (``random_batch`` when the
    loader has no such method): ``depth`` batches ahead on one producer
    thread, or a :class:`SyncFeeder` when ``depth <= 0``. ``stack=K``
    stacks K consecutive draws ``[K, ...]`` a ``get()``: the same draws,
    in the same order, as K single gets (a bucketed loader's
    ``next_stack(K)``, ``k <= K`` of them). ``transfer_dtype``,
    ``device`` and ``mesh``: the module docstring."""
    if stack < 1:
        raise ValueError(f"stack must be >= 1, got {stack}")
    if transfer_dtype not in (None, "float32", "bfloat16", "int16"):
        raise ValueError(f"transfer_dtype must be 'float32', 'bfloat16' "
                         f"or 'int16', got {transfer_dtype!r}")
    quant_scale = None
    if transfer_dtype == "int16":
        quant_scale = getattr(loader, "scale_factor", None)
        # the largest rounding error is 0.5/scale normalized units: refuse
        # a corpus where that is more than a tenth of the data's spread
        if quant_scale is None or quant_scale < 5.0:
            raise ValueError(
                f"transfer_dtype='int16' needs an integer-origin corpus: "
                f"loader scale_factor is {quant_scale!r}, so quantizing "
                f"to integer data units would round away the strokes "
                f"(max error 0.5/scale normalized units). Use 'bfloat16' "
                f"or 'float32' for float-natured corpora.")
        quant_scale = float(quant_scale)
    next_fn = getattr(loader, "next_batch", None) or loader.random_batch
    bucketed_stack = stack > 1 and bool(getattr(loader, "bucket_edges", ()))
    cast = transfer_dtype == "bfloat16"
    timings = _timings()

    def host_batch():
        t0 = time.perf_counter()
        if bucketed_stack:
            out = loader.next_stack(stack, int16_scale=quant_scale)
        elif stack == 1:
            out = dict(next_fn(int16_scale=quant_scale))
        else:
            out = stack_batches([next_fn(int16_scale=quant_scale)
                                 for _ in range(stack)])
        if mesh is not None:
            out = shard_batch(out, mesh, stacked=stack > 1)
        t1 = time.perf_counter()
        if cast:
            out["strokes"] = torch.from_numpy(
                np.asarray(out["strokes"], np.float32)).to(torch.bfloat16)
        timings["assemble_s"] += t1 - t0
        timings["cast_s"] += time.perf_counter() - t1
        timings["batches"] += 1
        return out

    receive = None
    if device is None:
        producer = host_batch
    else:
        device = torch.device(device)
        if device.type == "cuda":
            send, receive = _card_transfer(device, timings)
            producer = lambda: send(host_batch())
        else:
            producer = lambda: {k: torch.as_tensor(v).to(device)
                                for k, v in host_batch().items()}
    if depth <= 0:
        return SyncFeeder(producer, receive, timings)
    return Prefetcher(producer, depth, receive, timings)
