"""One process per rank on ``torch.distributed``: how the port runs on
several devices, where the JAX package runs one program over a device mesh.

* :func:`spawn` starts one process per id of ``--gpu_id`` (start method
  ``spawn``), rank ``k`` on ``cuda:<ids[k]>`` (or on the CPU), and returns
  rank 0's return value.  An id given twice puts two ranks on one card.
* The backend is NCCL when every rank has a card of its own, gloo when ranks
  share a card or run on the CPU (:func:`backend_for`).
* Rendezvous is a ``file://`` store in a temporary directory the launcher
  owns, so concurrent launches never contend for a port; a process that
  ``torchrun`` started (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` set)
  joins through ``env://`` instead (:func:`join_torchrun`).
* Collectives: :func:`all_reduce_mean`, :func:`all_gather_rows`,
  :func:`broadcast_params`, :func:`broadcast_object`,
  :func:`gather_objects` and :class:`AllReduceSum` (differentiable).  Each
  hands its tensors to ``torch.distributed`` as they are, on either backend:
  gloo takes CUDA tensors for all_reduce, broadcast and all_gather.  Outside
  a group, or in a group of one, each is the identity.

Rank 0 alone prints (the others' standard output goes to ``os.devnull``)
and writes files; the other ranks wait at :func:`barrier`.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def is_main() -> bool:
    return rank() == 0


def backend_for(ids: Sequence[int], device_type: str) -> str:
    """NCCL when every rank has a card of its own; gloo when ranks share a
    card (an id repeated) or run on the CPU."""
    if device_type == "cuda" and len(set(ids)) == len(ids):
        return "nccl"
    return "gloo"


def init(rank_: int, world: int, init_method: str, backend: str, quiet: bool = True) -> None:
    """Join the process group; with ``quiet`` a rank other than 0 prints
    nothing on standard output."""
    dist.init_process_group(backend, init_method=init_method, rank=rank_, world_size=world,
                            timeout=TIMEOUT)
    if quiet and rank_ != 0:
        sys.stdout = open(os.devnull, "w")


def join_torchrun(ids: Sequence[int], device_type: str) -> bool:
    """Join the group ``torchrun`` describes in the environment, when it
    describes one and this process is in no group yet.  Returns whether
    this process is now in a group."""
    if in_group():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    world = int(os.environ["WORLD_SIZE"])
    if world != len(ids):
        raise ValueError(f"torchrun started {world} ranks but --gpu_id names {len(ids)} ids")
    rank_ = int(os.environ["RANK"])
    if device_type == "cuda":
        torch.cuda.set_device(ids[rank_])
    init(rank_, world, "env://", backend_for(ids, device_type))
    return True


def shutdown() -> None:
    if in_group():
        dist.barrier()
        dist.destroy_process_group()


def barrier() -> None:
    if in_group():
        dist.barrier()


def _worker(rank_: int, fn: Callable, ids: List[int], device_type: str, init_file: str,
            backend: str, result_path: str, args: tuple) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(ids[rank_])
    init(rank_, len(ids), "file://" + init_file, backend)
    try:
        out = fn(*args)
        if rank_ == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        shutdown()


def spawn(fn: Callable, ids: Sequence[int], device: str, *args):
    """Run ``fn(*args)`` in ``len(ids)`` processes joined in one group and
    return rank 0's return value (it must pickle).  ``fn`` must be importable
    by module path.  A rank that fails stops the others and raises here.

    :param device: "cuda" (rank k on card ``ids[k]``) or "cpu"
    """
    ids = [int(i) for i in ids]
    device_type = torch.device(device).type
    tmp = tempfile.mkdtemp(prefix="pixelnerf_ranks_")
    try:
        result_path = os.path.join(tmp, "result.pkl")
        torch.multiprocessing.start_processes(
            _worker, args=(fn, ids, device_type, os.path.join(tmp, "store"),
                           backend_for(ids, device_type), result_path, tuple(args)),
            nprocs=len(ids), join=True, start_method="spawn")
        with open(result_path, "rb") as f:
            return pickle.load(f)  # written by rank 0 of this launch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _group_size(group) -> int:
    return dist.get_world_size(group) if in_group() else 1


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if _group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_mean(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The mean over ``group`` of each tensor, through one flat buffer."""
    n = _group_size(group)
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce_sum_(flat, group)
    flat = flat / n
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) joined along dim 0 in
    rank order."""
    n = _group_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    if _group_size(group) > 1:
        dist.broadcast(t, src, group=group)
    return t


def broadcast_params(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, src)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def check_replicas(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise unless every rank holds rank 0's values (bit for bit)."""
    if world_size() == 1:
        return
    for i, t in enumerate(tensors):
        ref = broadcast_(t.detach().clone(), 0)
        if not torch.equal(ref, t.detach()):
            raise RuntimeError(f"rank {rank()}: {what} differs from rank 0's (tensor {i})")


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``; the gradient is summed over the group
    too, as every rank's loss depends on every rank's ``x``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_sum_(grad.clone(), ctx.group), None
