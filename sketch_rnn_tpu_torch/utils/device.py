"""Where the port runs: this process's CUDA card unless the caller asks
for the CPU; and moving tensors between the host and the card without
waiting."""

from __future__ import annotations

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


def tree_to(tree, device):
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
