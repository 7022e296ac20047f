"""One process per card: joining the process group, and this process's
place in it.

The port of ``initialize``, ``process_index``, ``process_count``,
``is_primary``, ``topology`` and ``local_batch_hps`` of
``sketch_rnn_tpu/parallel/multihost.py``. Where the JAX package runs one
process per host over all of that host's devices, the port runs one
process per card: ``torchrun --nproc_per_node=N`` starts N processes,
each sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``, and :func:`initialize` joins them into
one ``torch.distributed`` group: NCCL when the process has a card, gloo
on the CPU. A port run over N ranks computes what the JAX package
computes over N hosts with one device each (``parallel/mesh.py``).

Without that environment and without arguments, :func:`initialize` does
nothing, and the process is rank 0 of a world of 1. The heartbeat, the
rendezvous barrier and ``HostDeathDetected`` (the elastic runtime's) are
not ported: they come with ``train/elastic.py``, ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from sketch_rnn_tpu_torch.config import HParams

_ENV = ("RANK", "WORLD_SIZE")


def local_rank() -> int:
    """This process's card on its machine: ``LOCAL_RANK`` (torchrun's),
    else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group; a no-op for a single-process run (no
    arguments and no ``RANK``/``WORLD_SIZE`` in the environment) and
    when the group exists already.

    ``init_method`` (``tcp://host:port``; default ``env://``, torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``), ``world_size`` and ``rank``
    default to torchrun's environment. ``backend`` defaults to NCCL when
    CUDA is available, which first makes ``cuda:LOCAL_RANK`` this
    process's device, and to gloo otherwise."""
    if dist.is_initialized():
        return
    if (init_method is None and world_size is None and rank is None
            and not all(k in os.environ for k in _ENV)):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=(int(os.environ["WORLD_SIZE"]) if world_size is None
                    else int(world_size)),
        rank=int(os.environ["RANK"]) if rank is None else int(rank))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes metrics, checkpoints and files."""
    return process_index() == 0


def topology() -> dict:
    """This process's coordinate: the JAX package's keys, with one card a
    process (``device_count`` is the world, ``local_device_count`` 1)."""
    n = process_count()
    return {"process_index": process_index(), "host_count": n,
            "device_count": n, "local_device_count": 1}


def local_batch_hps(hps: HParams, num_hosts: Optional[int] = None
                    ) -> HParams:
    """The loader's hparams of one of ``num_hosts`` stripes (default: the
    world): each assembles ``1/num_hosts`` of the global batch, and
    ``hps.batch_size`` stays the global batch everywhere else."""
    n = process_count() if num_hosts is None else int(num_hosts)
    if hps.batch_size % n != 0:
        raise ValueError(f"global batch {hps.batch_size} not divisible by "
                         f"{n} hosts")
    return hps.replace(batch_size=hps.batch_size // n)
