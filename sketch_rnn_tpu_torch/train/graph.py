"""K calls of a step body as one CUDA graph replay.

The card's answer to the JAX package's ``lax.scan``'d K-step programs
(``make_multi_train_step``, ``_jit_multi_eval``): the K-step body is
captured once into a CUDA graph (``torch.cuda.CUDAGraph``), and every
later call is one copy of its inputs into the graph's static buffers, one
``replay()`` and one copy of its outputs, with no Python between the
kernels of the K steps.

:class:`GraphedCall` wraps a function of tensors (nested dicts, lists and
tuples of them). One graph is captured per input signature (the shapes,
dtypes and structure of the inputs: one per ``(K, B, T)``):

- **The first call at a signature** copies its inputs into new static
  buffers on the card, runs the body eagerly on them on the capture
  stream (the warm-up that capturing autograd needs; its results are
  this call's results, so the call is exactly the body's K steps), then
  captures the body on the same buffers. A capture that fails raises; no
  call falls back to the eager body afterwards.
- **Every later call** copies its inputs into the static buffers (host
  tensors through pinned memory, without a host synchronization),
  replays, and returns clones of the static outputs: a replay never
  writes a tensor that a caller holds, and the caller's inputs are
  never written.

Each graph holds the memory of its own pool (``torch.cuda.graph``'s
default: no pool is shared between graphs, so graphs may replay in any
order, as a bucketed plan replays them): ``capture_bytes`` gives, per
capture, what the card's reserved memory grew by across it.

The training kernels' launch counters (``ops/cuda_fused.py``) count in
their Python wrappers, which a replay does not run: the launches a
capture records are taken back out of the counters, and every replay adds
them again, so the counters hold what the card ran. The warm-up's
launches are counted as the launches they are.

A body on a mesh (``parallel/mesh.py``) issues the data axis's
all-reduces: under an NCCL group the warm-up's eager run creates the
communicator, and the capture records the collectives on the capture
stream with the rest of the K steps, so a replay runs them too. A group
whose collectives a graph cannot capture (gloo) is refused by the step
builders before any capture (``train/step.py``).

On the CPU there is nothing to capture: callers run the body eagerly (the
plain version), and :class:`GraphedCall` refuses CPU devices.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from sketch_rnn_tpu_torch.ops import cuda_fused as CF


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """``(leaves, spec)`` of nested dicts (keys sorted), lists and tuples
    of tensors; :func:`unflatten` rebuilds the tree from ``spec``."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                ("dict", tuple(keys), tuple(s for _, s in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [flatten(t) for t in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree).__name__, len(tree), tuple(s for _, s in parts)))
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a graphed call takes tensors, not {type(tree)}")
    return [tree], None


def unflatten(spec, leaves: List[torch.Tensor]):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(keys, subs)}
        items = [build(sub) for sub in subs]
        return tuple(items) if kind == "tuple" else items

    return build(spec)


class _Captured:
    """One signature's graph, its static input buffers, its static
    outputs (and their tree) and the launches its capture recorded."""

    def __init__(self, graph, inputs, outputs, out_spec, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.out_spec = out_spec
        self.launches = launches


class GraphedCall:
    """``call(*args)``: ``body(*args)`` on the card, captured once per
    input signature and replayed (the module docstring). ``name`` names
    the body in errors; ``device`` is the CUDA device it runs on."""

    def __init__(self, body: Callable, name: str, device):
        self.body = body
        self.name = name
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"{name}: CUDA graphs run on a CUDA device, "
                             f"not {self.device}; on the CPU call the body "
                             f"eagerly")
        self._graphs: Dict[Any, _Captured] = {}
        self._stream = None
        # seconds of each capture (the warm-up excluded) and the reserved
        # memory it added (the graph's pool), in capture order
        self.capture_seconds: List[float] = []
        self.capture_bytes: List[int] = []

    @property
    def captured(self) -> int:
        """The number of graphs captured so far (one per signature)."""
        return len(self._graphs)

    def __call__(self, *args):
        leaves, spec = flatten(list(args))
        sig = (spec, tuple((tuple(x.shape), x.dtype) for x in leaves))
        cap = self._graphs.get(sig)
        if cap is None:
            return self._first_call(sig, spec, leaves)
        self._copy_in(cap.inputs, leaves)
        cap.graph.replay()
        CF.add_launch_counts(cap.launches)
        return unflatten(cap.out_spec, [o.clone() for o in cap.outputs])

    def _copy_in(self, static, leaves) -> None:
        for s, x in zip(static, leaves):
            if x.numel() == 0:
                continue
            if x.device.type == "cpu":
                x = x.pin_memory()
            s.copy_(x, non_blocking=True)

    def _first_call(self, sig, spec, leaves):
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, cur = self._stream, torch.cuda.current_stream(dev)
        static = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                  for x in leaves]
        self._copy_in(static, leaves)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out_leaves, out_spec = flatten(
                self.body(*unflatten(spec, static)))
            # an output may be a view of a static input, which the next
            # call overwrites
            out_leaves = [x.clone() for x in out_leaves]
        graph = torch.cuda.CUDAGraph()
        before = CF.launch_counts()
        side.synchronize()
        # torch.cuda.graph empties the allocator's cache as it enters:
        # empty it first, so the growth measured is the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                captured = self.body(*unflatten(spec, static))
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: capturing the body into a CUDA graph "
                f"failed ({type(e).__name__}: {e}); the card runs it as a "
                f"graph replay or not at all") from e
        finally:
            after = CF.launch_counts()
            launches = {k: after[k] - before[k] for k in after}
            CF.add_launch_counts({k: -v for k, v in launches.items()})
        self.capture_seconds.append(time.perf_counter() - t0)
        self.capture_bytes.append(torch.cuda.memory_reserved(dev) - reserved)
        cap_leaves, cap_spec = flatten(captured)
        if cap_spec != out_spec:
            raise RuntimeError(f"{self.name}: the captured body returned "
                               f"another structure than its warm-up")
        self._graphs[sig] = _Captured(graph, static, cap_leaves, cap_spec,
                                      launches)
        cur.wait_stream(side)
        for x in out_leaves:
            # made on the capture stream, read on the caller's
            x.record_stream(cur)
        return unflatten(out_spec, out_leaves)
