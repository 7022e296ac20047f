"""Where the port runs: this process's CUDA card unless the caller asks
for the CPU; and moving tensors between the host and the card without
waiting."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from sketch_rnn_tpu_torch.parallel.multihost import local_rank


def resolve_device(device=None) -> torch.device:
    """``None`` means this process's card, ``cuda:LOCAL_RANK`` (torchrun's
    local rank, 0 without it), which becomes the current device, so every
    launch and allocation of a rank lands on its own card; with no CUDA
    device that is an error, never a quiet move to the CPU. Pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels
    (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sketch_rnn_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels on the CPU")
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
        return dev
    return torch.device(device)


def tree_to(tree, device, copy: bool = False):
    """A nested dict of tensors moved to ``device``; ``copy=True`` gives
    new tensors even where a leaf is already there."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, copy) for k, v in tree.items()}
    return tree.to(device, copy=copy)


def tree_leaves(tree, path=()):
    """``(path, leaf)`` pairs of a nested dict in insertion order; a path
    is the tuple of its keys."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_leaves(v, path + (k,))]
    return [(path, tree)]


def _signature(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    a = np.asarray(leaf)
    return a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype


def congruent(resident, tree) -> bool:
    """Whether ``tree`` has the same structure, leaf shapes and leaf
    dtypes as the tensors of ``resident`` (its leaves may be tensors or
    numpy arrays)."""
    have, new = tree_leaves(resident), tree_leaves(tree)
    return ([p for p, _ in have] == [p for p, _ in new]
            and all(_signature(a) == _signature(b)
                    for (_, a), (_, b) in zip(have, new)))


def copy_values_(weights, tree, stream=None) -> None:
    """Copy ``tree``'s values into resident tensors in place.

    ``weights`` holds ``(path, tensor)`` pairs; each tensor gets the leaf
    of ``tree`` at its path, cast to the tensor's dtype (``copy_`` rounds
    as ``.to`` does), so the tensors keep their storage. A tensor listed
    under two paths is filled once. On a CUDA device the copies are
    issued on ``stream``, after the work already queued there."""
    seen = set()
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx:
        for path, dst in weights:
            if dst.data_ptr() in seen:
                continue
            seen.add(dst.data_ptr())
            src = tree
            for k in path:
                src = src[k]
            dst.copy_(torch.as_tensor(src))


def to_device(x: torch.Tensor, dev) -> torch.Tensor:
    """A host tensor on ``dev``; to the card through pinned memory,
    without waiting for the card."""
    if dev.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(dev, non_blocking=True)
    return x.to(dev)


class Staged:
    """Tensors on their way to the host: on CUDA, non-blocking copies into
    pinned memory behind an event; on the CPU, clones. ``fetch()`` waits
    once and returns them as numpy arrays."""

    def __init__(self, tensors):
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]
            self.event = None

    def fetch(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]
