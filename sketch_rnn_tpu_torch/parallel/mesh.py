"""The mesh of ranks, and the data axis's sums.

The port of ``sketch_rnn_tpu/parallel/mesh.py``. The JAX package lays
its devices out as a named mesh (``hps.mesh_shape`` over
``hps.mesh_axes``), shards the batch over the ``data`` axis and runs the
step under ``shard_map``, with ``psum`` over ``data`` for the losses'
global sums and for the gradients. The port runs one process per card
(``parallel/multihost.py``), so a mesh here is this rank's place among
the ranks of the ``torch.distributed`` group: :func:`make_mesh` checks
the shape exactly as the JAX package does, lays the ranks out in
row-major order (as ``np.asarray(devices).reshape(shape)`` lays out
devices), and gives this rank its coordinates, its ``data`` index, and
the process group of the ranks that share its every other coordinate.
The data sums run over that group, so a ``("model", "data")`` mesh sums
over ``data`` only, as ``lax.psum(..., "data")`` does.

- :meth:`Mesh.psum` is the losses' global sum: an all-reduce whose
  backward passes the cotangent through unchanged, so a rank's gradient
  is its own rows' contribution to the gradient of the global loss.
- :meth:`Mesh.psum_tensors` sums the gradients over the data group in
  one all-reduce of one flat buffer a step.
- :meth:`Mesh.gather` puts the data group's rows back together in data
  order (the sampler's ``out_specs=P("data")``).

A rank's key is folded with its ``data`` index (:meth:`Mesh.fold`), as
the JAX step folds ``axis_index("data")``; on a mesh of one rank that is
``fold_in(key, 0)``. Without a process group the mesh is one rank: every
sum is the identity and no collective runs. A mesh of more ranks without
a group raises where a step is built (no quiet local sums).

The JAX package's gradient under its mesh is ``N`` times the
single-device gradient (``jax`` 0.9 on the CPU, measured at N = 1, 2, 4:
the autodiff of ``shard_map`` already sums the gradient of the
replicated parameters, and the explicit ``psum(grads)`` sums it again).
The port sums once: its gradient over N ranks is the gradient of the
global loss, which is what the JAX package's docstrings describe and
what its one-device path computes (``tests/test_torch_dp.py`` holds
both relations).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sketch_rnn_tpu_torch.config import HParams
from sketch_rnn_tpu_torch.parallel import multihost as mh

DATA_AXIS = "data"

# process groups made by new_group, by their ranks: every rank makes the
# same groups in the same order, once a process (each new_group is a new
# communicator, and the CLI and train() each make the mesh)
_GROUPS: Dict[Tuple[int, ...], Any] = {}


class _GlobalSum(torch.autograd.Function):
    """The sum over the group; backward the identity (the cotangent of a
    global sum is the cotangent of each rank's summand)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class Mesh:
    """This rank's place in a mesh of ranks (:func:`make_mesh`).

    ``shape`` maps each axis to its size in axis order, as
    ``jax.sharding.Mesh.shape``; ``devices`` is the array of ranks;
    ``coords`` this rank's index along each axis; ``data_index`` and
    ``data_size`` its index along ``data`` and that axis's size;
    ``data_ranks`` the ranks of its data group (in data order) and
    ``group`` their process group, or None without ``torch.distributed``
    (one rank)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 rank: int, group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.rank = int(rank)
        at = np.argwhere(devices == rank)[0]
        self.coords = dict(zip(self.axis_names, (int(i) for i in at)))
        if DATA_AXIS in self.shape:
            ax = self.axis_names.index(DATA_AXIS)
            line = [slice(None) if i == ax else int(c)
                    for i, c in enumerate(at)]
            self.data_ranks = tuple(int(r) for r in devices[tuple(line)])
            self.data_index = int(at[ax])
        else:
            self.data_ranks, self.data_index = (self.rank,), 0
        self.data_size = len(self.data_ranks)
        self.group = group

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"data_index={self.data_index}, "
                f"group={'yes' if self.group is not None else 'none'})")

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend (``"nccl"``, ``"gloo"``), None
        without a group."""
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: none
        run, or they run on NCCL. gloo's cannot be captured."""
        return self.backend in (None, dist.Backend.NCCL)

    def require_group(self, what: str) -> None:
        """Raise unless the data sums can run: a data axis of more than
        one rank needs the process group."""
        if DATA_AXIS not in self.shape:
            raise ValueError(f"{what}: the mesh {self.shape} has no "
                             f"{DATA_AXIS!r} axis to shard the batch over")
        if self.data_size > 1 and self.group is None:
            raise RuntimeError(
                f"{what}: a {DATA_AXIS!r} axis of {self.data_size} ranks "
                f"sums over torch.distributed, and no process group "
                f"exists; call parallel.multihost.initialize() (or launch "
                f"with torchrun) first")

    def fold(self, key: torch.Tensor) -> torch.Tensor:
        """``fold_in(key, data_index)`` (leading dimensions fold too)."""
        from sketch_rnn_tpu_torch.utils import prng

        return prng.fold_in(key, self.data_index)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The global sum of ``x`` over the data group, differentiable
        with the identity as its backward; ``x`` itself without a
        group."""
        if self.group is None:
            return x
        return _GlobalSum.apply(x, self.group)

    def psum_tensors(self, tensors: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """``tensors`` summed over the data group in one all-reduce of
        one flat float32 buffer; the same list without a group."""
        if self.group is None or not tensors:
            return tensors
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[at:at + n].view(t.shape).to(t.dtype))
            at += n
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The data group's ``x`` concatenated along dim 0 in data order
        (every rank gets the whole); ``x`` itself without a group."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.data_size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def _data_groups(devices: np.ndarray, axes: Tuple[str, ...]
                 ) -> List[Tuple[int, ...]]:
    ax = axes.index(DATA_AXIS)
    moved = np.moveaxis(devices, ax, -1).reshape(-1, devices.shape[ax])
    return [tuple(int(r) for r in row) for row in moved]


def _process_group(ranks: Tuple[int, ...], all_groups):
    """The process group of ``ranks``: the world's own when they are the
    whole world, else one made by ``new_group`` (made once a process;
    every rank makes every group, in the same order, as ``new_group``
    requires)."""
    world = dist.get_world_size()
    if len(ranks) == world and sorted(ranks) == list(range(world)):
        return dist.group.WORLD
    for rs in all_groups:
        if rs not in _GROUPS:
            _GROUPS[rs] = dist.new_group(list(rs))
    return _GROUPS[ranks]


def make_mesh(hps: Optional[HParams] = None,
              world: Optional[int] = None) -> Mesh:
    """This rank's mesh from ``hps.mesh_shape`` / ``hps.mesh_axes`` over
    ``world`` ranks (default: the process group's size, 1 without one).
    A ``-1`` entry absorbs all remaining ranks; the shape is checked as
    the JAX package checks it, with its ``ValueError``s. ``world`` other
    than the group's size raises."""
    n = mh.process_count() if world is None else int(world)
    if dist.is_initialized() and n != dist.get_world_size():
        raise ValueError(f"a mesh over {n} ranks in a process group of "
                         f"{dist.get_world_size()}")
    shape = list(hps.mesh_shape) if hps is not None else [-1]
    axes = tuple(hps.mesh_axes) if hps is not None else (DATA_AXIS,)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {shape} and mesh_axes {axes} "
                         f"must have equal length")
    if shape.count(-1) > 1:
        raise ValueError("at most one -1 in mesh_shape")
    fixed = int(np.prod([s for s in shape if s != -1])) if shape else 1
    if -1 in shape:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed mesh "
                             f"dims {fixed}")
        shape[shape.index(-1)] = n // fixed
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh_shape {shape} != device count {n}")
    devices = np.arange(n).reshape(shape)
    rank = mh.process_index()
    group = None
    if dist.is_initialized() and DATA_AXIS in axes:
        groups = _data_groups(devices, axes)
        mine = next(g for g in groups if rank in g)
        group = _process_group(mine, groups)
    return Mesh(devices, axes, rank, group)


def check_batch_divisible(batch_size: int, mesh: Mesh,
                          axis: str = DATA_AXIS) -> None:
    n = mesh.shape[axis]
    if batch_size % n != 0:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by the {axis!r} "
            f"mesh axis size {n} (global batch is split across devices)")


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis: str = DATA_AXIS,
                stacked: bool = False) -> Dict[str, Any]:
    """This rank's rows of a host batch (numpy arrays or tensors): of a
    batch of ``B`` rows, rows ``[i * B / n, (i + 1) * B / n)`` with ``i``
    the rank's index along ``axis`` and ``n`` that axis's size, as the
    JAX package's ``shard_batch`` places a host batch on the mesh.
    ``stacked=True`` takes ``[K, B, ...]`` stacks (rows on axis 1; every
    leaf must agree on K)."""
    lead = 1 if stacked else 0
    if stacked:
        ks = {np.shape(x)[0] for x in batch.values()}
        if len(ks) > 1:
            raise ValueError(
                f"stacked batch leaves disagree on the micro-step "
                f"leading axis: {sorted(ks)}")
    n = mesh.shape[axis]
    i = mesh.coords[axis]
    out = {}
    for k, v in batch.items():
        b = np.shape(v)[lead]
        if b % n != 0:
            raise ValueError(f"{k!r}: {b} rows do not split over the "
                             f"{axis!r} mesh axis size {n}")
        rows = slice(i * b // n, (i + 1) * b // n)
        out[k] = v[:, rows] if stacked else v[rows]
    return out
