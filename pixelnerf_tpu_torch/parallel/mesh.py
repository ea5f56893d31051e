"""The ranks of a multi-device run as the JAX package's device mesh.

The JAX package runs one program over a ``jax.sharding.Mesh``: a 1-D
``("rays",)`` mesh for eval, a 2-D ``("data", "rays")`` mesh for training
(the object batch over "data", each object's rays over "rays").  The port
runs one process per rank (:mod:`.launch`); a :class:`Mesh` gives each rank
its coordinates on the same shapes and the process group of each axis.

* :func:`make_ray_mesh` / :func:`make_train_mesh`: the JAX shapes and
  asserts.  In a process group the mesh covers its ranks (a smaller count is
  clamped to the group's size, as JAX clamps to its devices, and must then
  cover the whole group); outside one, ``n_devices`` ranks are described and
  ``rank`` picks the coordinates.
* :data:`BATCH_KEY_KINDS` and :func:`shard_batch`: the one table of which
  batch key is split over objects and which over rays, and this rank's
  slice of a batch by it.  An axis that does not divide is replicated.
* :class:`DataShard`: what a data-parallel rank tells the encoder (its
  share of the object batch, the mean over the data group) so that
  train-mode BatchNorm and the fusion's dropout see the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import launch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place on a device mesh.

    :param axis_names: ``("rays",)`` or ``("data", "rays")``
    :param devices_shape: ranks along each axis; rank = row-major index
    :param rank: this process's rank
    :param groups: process group of each axis holding this rank (None: the
        axis has one rank, or no process group is up)
    """

    axis_names: Tuple[str, ...]
    devices_shape: Tuple[int, ...]
    rank: int = 0
    groups: Dict[str, object] = dataclasses.field(default_factory=dict, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.devices_shape:
            n *= s
        return n

    @property
    def coords(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for name, s in reversed(list(zip(self.axis_names, self.devices_shape))):
            out[name] = r % s
            r //= s
        return {name: out[name] for name in self.axis_names}

    def group(self, axis: str):
        return self.groups.get(axis)


def _mesh_size(n_devices: Optional[int]) -> int:
    world = launch.world_size()
    if not launch.in_group():
        return n_devices if n_devices is not None and n_devices > 0 else 1
    n = world if n_devices is None or n_devices <= 0 else min(n_devices, world)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: every rank must be on it")
    return n


def _groups(axis_names, shape, rank: int) -> Dict[str, object]:
    """Every rank creates every axis group in the same order (a collective
    call); each keeps the groups that hold it."""
    if not launch.in_group() or launch.world_size() == 1:
        return {}
    import itertools

    out = {}
    for ax, name in enumerate(axis_names):
        if shape[ax] == 1:
            continue
        others = [range(s) for i, s in enumerate(shape) if i != ax]
        for fixed in itertools.product(*others):
            ranks = []
            for k in range(shape[ax]):
                idx = list(fixed)
                idx.insert(ax, k)
                r = 0
                for i, s in zip(idx, shape):
                    r = r * s + i
                ranks.append(r)
            g = torch.distributed.new_group(ranks)
            if rank in ranks:
                out[name] = g
    return out


def make_ray_mesh(n_devices: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """1-D mesh of all (or the first n) ranks, axis name "rays"."""
    n = _mesh_size(n_devices)
    r = launch.rank() if rank is None else rank
    return Mesh(("rays",), (n,), r, _groups(("rays",), (n,), r))


def make_train_mesh(n_devices: Optional[int] = None, data_parallel: Optional[int] = None,
                    rank: Optional[int] = None) -> Mesh:
    """2-D ("data", "rays") mesh.  ``data_parallel`` fixes the data axis size;
    by default the mesh is (n, 1) -- pure object-batch data parallelism."""
    n = _mesh_size(n_devices)
    if data_parallel is None:
        data_parallel = n
    assert n % data_parallel == 0, (n, data_parallel)
    shape = (data_parallel, n // data_parallel)
    r = launch.rank() if rank is None else rank
    return Mesh(("data", "rays"), shape, r, _groups(("data", "rays"), shape, r))


# Per-batch-key sharding kinds for a ("data", "rays") train mesh, the JAX
# package's table: "data" tensors carry one slice per object (axis 0 = SB);
# "rays" tensors add a per-object ray axis (axis 1 = R) split over the
# mesh's ray dimension.  prepare_ray_batch must not emit a key absent here.
BATCH_KEY_KINDS = {
    "src_images": "data",
    "src_poses": "data",
    "focal": "data",
    "c": "data",
    "rays": "rays",
    "rgb_gt": "rays",
    "mask_gt": "rays",
}


def axis_slice(n: int, mesh: Mesh, axis: str) -> slice:
    """This rank's share of ``n`` rows along a mesh axis; all of them when
    ``n`` does not divide (replication)."""
    parts = mesh.shape.get(axis, 1)
    if n % parts:
        return slice(None)
    k = n // parts
    i = mesh.coords.get(axis, 0)
    return slice(i * k, (i + 1) * k)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's slice of each tensor of one training batch over a
    ("data", "rays") mesh: the counterpart of the JAX ``batch_shardings``.
    Any axis whose size does not divide the mesh axis is replicated (e.g. a
    validation batch of one object on a data > 1 mesh)."""
    out = {}
    for k, v in batch.items():
        kind = BATCH_KEY_KINDS.get(k)
        if kind is None:
            raise KeyError(
                f"batch key {k!r} has no sharding kind; add it to "
                "parallel.mesh.BATCH_KEY_KINDS"
            )
        d = axis_slice(v.shape[0], mesh, "data")
        if kind == "data":
            out[k] = v[d]
        else:
            out[k] = v[d, axis_slice(v.shape[1], mesh, "rays")]
    return out


@dataclasses.dataclass
class DataShard:
    """A data-parallel rank's share of the encoder's batch: the ``index``-th
    of ``count`` equal shares (``count`` 1 when the batch is replicated over
    the data axis), and the data axis's process group.  Train-mode
    BatchNorm normalizes with the statistics of the whole batch
    (:meth:`mean`) and the fusion's dropout takes its rows of a mask drawn
    for the whole batch."""

    index: int = 0
    count: int = 1
    group: object = None

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data group, differentiable."""
        return launch.AllReduceSum.apply(x, self.group) / self.count


def set_data_shard(net: torch.nn.Module, shard: Optional[DataShard]) -> None:
    """Hand ``shard`` to every module of ``net`` that reads one (None: each
    rank's batch alone, the single-device behaviour)."""
    for m in net.modules():
        if hasattr(m, "data_shard"):
            m.data_shard = shard
