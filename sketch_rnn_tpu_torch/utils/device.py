"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); with no CUDA device that is an
    error, never a quiet move to the CPU. Pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sketch_rnn_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_to(tree, device):
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
