"""The device mesh: ('data', 'space') axes over ``torch.distributed`` ranks.

Counterpart of ``tpu_diinn/parallel/mesh.py``. The JAX package lays a 2-D
``Mesh`` over its devices; here every rank is one process driving one
device, and the mesh is the ranks laid out as JAX lays out devices,
``rank = d * space + s``:

- the 'data' axis carries batch parallelism: the ranks of one space index
  ``s`` load disjoint shards of every global batch, and the gradients are
  summed over them;
- the 'space' axis shards the HR query grid (the decoder's output columns)
  and, in the halo-sharded encoder, the LR rows; the ranks of one data
  index ``d`` hold the same samples.

``maybe_init_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
joins the process group once: NCCL for a CUDA run, gloo for the CPU (the
JAX package picks gloo for its CPU collectives). Without that environment
the run is one rank and the mesh is 1 x 1, with no collective at all.

The collectives the port uses (``all_reduce_sum_``, ``broadcast_``,
``all_gather_cat``, ``exchange``) stage a CUDA tensor through the host when
the group's backend is gloo, so that several ranks may share one card
over gloo (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_init_distributed(device_type: str = "cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group described by torchrun's environment, once.

    A no-op (returning whether a group is up) when the group is already
    initialized or ``WORLD_SIZE`` is not set. ``backend`` defaults to
    NCCL for ``device_type`` "cuda" and gloo otherwise. On CUDA the rank
    takes ``cuda:LOCAL_RANK`` as its current device first."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: "
                           f"launch with torchrun or set all of {ENV}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    kwargs = {}
    if device_type == "cuda":
        local = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = local
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            **kwargs)
    return True


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (0 without torchrun's
    environment), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: the global ranks along it
    (this rank's row or column of the mesh), this rank's position among
    them, and their process group (None for a 1-rank axis)."""
    name: str
    ranks: Tuple[int, ...]
    index: int
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('data', 'space') layout of the world's ranks, as seen from
    this rank."""
    data: Axis
    space: Axis
    rank: int = 0

    def axis(self, name: str) -> Axis:
        return {"data": self.data, "space": self.space}[name]


def mesh_shape(data: int, space: int, n: int) -> Tuple[int, int]:
    """The (data, space) layout of ``n`` ranks under the JAX rules:
    ``space < 1`` is 1, ``data = -1`` is ``n // space``. Raises
    ValueError for a layout that is not exactly ``n`` ranks: a rank left
    out of the mesh would wait alone in the first collective (the JAX
    package takes the first ``data * space`` devices instead)."""
    space = max(int(space), 1)
    data = int(data)
    if data == -1:
        if n % space:
            raise ValueError(f"trainer.mesh_space={space} does not divide "
                             f"the world size {n}")
        data = n // space
    if data < 1 or data * space != n:
        raise ValueError(f"mesh data={data} x space={space} = {data * space}"
                         f" ranks, but the world has {n}: the layout must "
                         f"use every rank")
    return data, space


def make_mesh(data: int = -1, space: int = 1) -> Mesh:
    """This rank's view of a ('data', 'space') mesh over every rank of the
    process group (or of the one process without a group). Every rank
    must call it with the same arguments: it creates the axes' process
    groups, which is collective."""
    rank, n = world()
    data, space = mesh_shape(data, space, n)
    d, s = divmod(rank, space)
    rows = [tuple(dd * space + ss for dd in range(data))
            for ss in range(space)]            # one 'data' axis per s
    cols = [tuple(dd * space + ss for ss in range(space))
            for dd in range(data)]             # one 'space' axis per d
    data_group = _groups(rows)[s] if data > 1 else None
    space_group = _groups(cols)[d] if space > 1 else None
    return Mesh(data=Axis("data", rows[s], d, data_group),
                space=Axis("space", cols[d], s, space_group), rank=rank)


def _groups(rank_lists: List[Tuple[int, ...]]) -> list:
    """A process group for each list of ranks (collective: every rank
    creates every group, in the same order)."""
    return [dist.new_group(list(r)) for r in rank_lists]


# ---------------------------------------------------------------------------
# Collectives, staged through the host under gloo.
# ---------------------------------------------------------------------------

def _host_staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` in place over every rank; a no-op without a process
    group."""
    if not dist.is_initialized():
        return t
    if t.is_cuda and _host_staged(None):
        h = t.cpu()
        dist.all_reduce(h)
        t.copy_(h)
    else:
        dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """Overwrite ``t`` with rank 0's, in place."""
    if t.is_cuda and _host_staged(None):
        h = t.cpu()
        dist.broadcast(h, 0)
        t.copy_(h)
    else:
        dist.broadcast(t, 0)
    return t


def all_gather_cat(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated in axis order on
    ``dim`` (every rank's ``t`` has the same shape)."""
    if axis.size == 1:
        return t
    src = t.contiguous()
    staged = src.is_cuda and _host_staged(axis.group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group=None) -> None:
    """Point-to-point: send each (tensor, global rank) of ``sends`` and
    fill each (tensor, global rank) of ``recvs``, all posted at once and
    waited for together (so that neighbours exchanging both ways do not
    wait on each other)."""
    staged = _host_staged(group)
    sends = [((t.cpu() if staged and t.is_cuda else t.contiguous()), r)
             for t, r in sends]
    bufs = [((torch.empty(t.shape, dtype=t.dtype) if staged and t.is_cuda
              else t), t, r) for t, r in recvs]
    ops = [dist.P2POp(dist.isend, t, r, group) for t, r in sends] + \
        [dist.P2POp(dist.irecv, b, r, group) for b, _, r in bufs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for b, t, _ in bufs:
        if b is not t:
            t.copy_(b)


def barrier() -> None:
    """Wait for every rank; a no-op without a process group."""
    if dist.is_initialized():
        dist.barrier()
