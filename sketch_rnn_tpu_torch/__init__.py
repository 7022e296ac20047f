"""sketch_rnn_tpu_torch: the PyTorch/CUDA port of sketch_rnn_tpu.

The JAX package ``sketch_rnn_tpu`` is the reference; this package is
held against it module by module and imports nothing of it (nor JAX).
Its entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the card every ported TPU kernel is a hand-written
Hopper kernel (``csrc/``), on the CPU its plain PyTorch version runs.
"""

from sketch_rnn_tpu_torch.config import HParams, get_default_hparams

__all__ = ["HParams", "get_default_hparams"]
