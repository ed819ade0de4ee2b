"""Multi-process setup and host-sharded data over ``torch.distributed``.

Every process runs the same program. :func:`initialize` wires the processes
into one default process group; the mesh (``parallel/mesh.py``) cuts it into
the ``data`` and ``model`` groups; the collectives below carry the engine's
refill decisions, the sharded products' outputs and their gradients, the
data-parallel batches and the train step's gradient sum between them.
Single-process (no group, no torchrun-style environment) everything
degrades to the identity.

The backend is the caller's choice and is never swapped: ``nccl`` by default
for CUDA ranks, ``gloo`` for CPU ranks. Ranks that share one card must ask
for gloo (``"cpu:gloo,cuda:gloo"``), since NCCL refuses two ranks on one
device; its refusal is raised as NCCL raises it. gloo takes CUDA tensors in
``all_gather`` and ``broadcast`` itself and moves them through host memory
(PyTorch 2.11 on an H100: ``chip_smoke.py`` phase 21 gathers the serving
tick's CUDA outputs over it), so the collectives below hand every backend
the tensors as they are.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device


def in_session() -> bool:
    """Whether this process is in a process group (of any size, one rank
    included: its collectives then run on that one rank)."""
    return dist.is_available() and dist.is_initialized()


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None, *,
               device: DeviceLike = None, timeout_s: Optional[float] = None) -> torch.device:
    """Wire this process into the default process group and return its
    device. A no-op when a group exists already, or when nothing names one
    (no ``init_method``, no ``world_size`` and no ``WORLD_SIZE`` in the
    environment): then the process runs alone.

    ``device`` (default ``cuda``) picks the backend when ``backend`` is None:
    ``nccl`` for CUDA, ``gloo`` for the CPU. A CUDA device without an index
    becomes ``cuda:(LOCAL_RANK or rank) % device_count``. ``timeout_s``
    bounds every collective (the backend's default is 30 minutes): a rank
    whose peer died sees its next collective fail or stall no longer."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else
                                   os.environ.get("RANK", 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if in_session() or (init_method is None and world_size is None
                   and "WORLD_SIZE" not in os.environ):
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)
    return dev


def shutdown() -> None:
    """Leave the default process group (a no-op single-process)."""
    if in_session():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if in_session() else 1


def process_index() -> int:
    return dist.get_rank() if in_session() else 0


def is_primary() -> bool:
    return process_index() == 0


def host_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process feeds."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over {n} processes")
    per = global_batch // n
    return slice(process_index() * per, (process_index() + 1) * per)


def sync_hosts(name: str = "barrier") -> None:
    """Every process blocks here until all have reached it (``name`` is for
    the reader: the group has one barrier). A no-op outside a group."""
    if in_session():
        dist.barrier()


def _parts(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (equal in shape), in rank order."""
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return parts


class _AllGather(torch.autograd.Function):
    """``dist.all_gather`` + ``torch.cat`` whose backward hands this rank its
    own slice of the incoming gradient. Whatever reads the gathered tensor is
    computed alike on every rank of the group (a column-parallel product's
    joined outputs, a sharded weight made whole), so each rank's gradient of
    the gathered tensor is already the whole one: summing it over the group
    (what ``torch.distributed.nn.functional.all_gather`` does) would multiply
    every shard's gradient by the group's size."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.dim, ctx.width, ctx.at = dim, t.shape[dim], dist.get_rank(group)
        return torch.cat(_parts(t, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.at * ctx.width, ctx.width), None, None


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors, equal in shape, concatenated along ``dim`` in
    rank order (outside a group: ``t``). Differentiable: the gradient of this
    rank's part is its slice of the gathered tensor's gradient
    (:class:`_AllGather`)."""
    if not in_session():
        return t
    return _AllGather.apply(t, group, dim)


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the group
    (:func:`all_reduce_sum`): the input of a column-parallel product, which
    every rank holds whole but differentiates through its own columns
    only."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def sum_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t``, with its gradient summed over the group on the way back (outside
    a group: ``t``)."""
    if not in_session():
        return t
    return _SumGrad.apply(t, group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of the group's tensors, equal in shape, added in rank order
    (``((t_0 + t_1) + t_2) + ...``), so that every rank holds the same bits
    whatever the backend's reduction order (outside a group: ``t``). Not
    differentiable: it sums gradients."""
    if not in_session():
        return t
    parts = _parts(t, group)
    return sum(parts[1:], parts[0])


def global_from_host_data(host_data, group=None) -> torch.Tensor:
    """The global tensor assembled from each process's slice along dim 0
    (``host_data`` is this process's :func:`host_local_batch_slice` of it),
    on ``host_data``'s device. Single-process: the data itself."""
    return all_gather(torch.as_tensor(host_data), group=group, dim=0)


def broadcast_one_to_all(arrays: Sequence[np.ndarray]) -> tuple:
    """Rank 0's numpy arrays on every rank. Every rank passes arrays of the
    same shapes and dtypes (its own values are overwritten); they travel as
    one byte buffer in one broadcast. Outside a group: the arrays."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if not in_session():
        return tuple(arrays)
    flat = np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays])
    buf = torch.from_numpy(flat)
    if "nccl" in str(dist.get_backend()):
        buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
    dist.broadcast(buf, src=0)
    flat = buf.cpu().numpy()
    out, at = [], 0
    for a in arrays:
        out.append(flat[at:at + a.nbytes].view(a.dtype).reshape(a.shape).copy())
        at += a.nbytes
    return tuple(out)


__all__ = ["all_gather", "all_reduce_sum", "broadcast_one_to_all", "global_from_host_data",
           "host_local_batch_slice", "in_session", "initialize", "is_primary", "process_count",
           "process_index", "shutdown", "sum_grad", "sync_hosts"]
