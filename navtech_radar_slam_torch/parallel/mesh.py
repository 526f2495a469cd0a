"""The process mesh of the multi-device layer, on ``torch.distributed``.

Counterpart of ``navtech_radar_slam_tpu/parallel/mesh.py``.  JAX drives
every device of its ``jax.sharding.Mesh`` from one controller; here each
rank is a process of its own (``parallel.launch`` starts them), and a
``Mesh`` is that process's view of the group: its rank, the group's size
and the device its tensors live on.  The descriptor bank is split along
its row axis in contiguous blocks, rank r holding rows
``[r·n/d, (r+1)·n/d)`` (JAX's ``P(BANK_AXIS)``); everything else is
replicated (JAX's ``P()``).

The backend is always the caller's choice, with no fallback: ``nccl`` for
CUDA tensors, one card per rank (NCCL refuses two ranks on one card), and
``gloo`` for CPU tensors, or for CUDA tensors where the caller names it
(gloo then copies them through the host).

Every rank runs the engine's host code, so the ranks must take the same
branch at every host read that leads to a collective.  The helpers below
give the two ways the port keeps that: ``broadcast`` (rank 0's replicated
state wins where the host reads it) and ``agree_max`` (a flag every rank
reads comes out of one collective).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BANK_AXIS = "bank"

#: what each backend carries
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D process group: ``group`` (None: the default
    group), this process's ``rank``, the group's ``size``, the ``device``
    this rank's tensors live on, and the ``backend``."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str

    def block(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """The rows ``[start, stop)`` that ``rank`` (default: this rank)
        owns of an axis of length ``n`` (``n`` must divide the mesh size)."""
        return row_block(n, self.rank if rank is None else rank, self.size)

    # -- collectives ---------------------------------------------------------

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the ranks (a new tensor, on every rank)."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along a new leading axis, (size, ...)."""
        if x.dtype == torch.bool:
            return self.all_gather(x.to(torch.uint8)).to(torch.bool)
        x = x.contiguous()
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.unbind(0)), x, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (a new tensor)."""
        if x.dtype == torch.bool:
            return self.broadcast(x.to(torch.uint8), src).to(torch.bool)
        out = x.contiguous().clone()
        dist.broadcast(out, src=src, group=self.group)
        return out

    def agree_max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest of every rank's ``x`` (a flag as 0 / 1, or a step
        size), so that each rank reads the same value."""
        out = x.detach().to(torch.float32).reshape(-1).clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out.reshape(x.shape)

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """A row-blocked tensor whole: the ranks' blocks (each
        (n/size, ...)) concatenated in rank order, on every rank."""
        return self.all_gather(local).reshape((-1,) + tuple(local.shape[1:]))

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def row_block(n: int, rank: int, size: int) -> Tuple[int, int]:
    """The contiguous block ``[rank·n/size, (rank+1)·n/size)`` of an axis of
    length ``n``; ``n`` must divide ``size`` (JAX's even sharding)."""
    if n % size:
        raise ValueError(f"an axis of length {n} does not split into {size} equal blocks")
    per = n // size
    return rank * per, (rank + 1) * per


def init_distributed(backend: str, init_method: Optional[str] = None, rank: int = 0,
                     world_size: int = 1, timeout: float = 300.0, store=None) -> int:
    """Join this process to the default process group and return the world
    size.  ``backend`` is ``nccl`` (CUDA tensors, one card per rank) or
    ``gloo`` (CPU tensors, or CUDA tensors through the host); it is never
    swapped for another.  Give either ``init_method`` (``tcp://host:port``,
    ``file://path``) or a ``store``; ``timeout`` (seconds) bounds every
    collective, so a rank that diverges fails the run instead of hanging
    it."""
    if backend not in BACKENDS:
        raise ValueError(f"init_distributed: backend {backend!r}, expected one of {BACKENDS}")
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    dist.init_process_group(**kw)
    return dist.get_world_size()


def make_mesh(device: torch.device | str) -> Mesh:
    """This rank's ``Mesh`` over the default process group, with its tensors
    on ``device``.  NCCL needs a CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    dev = torch.device(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"make_mesh: the nccl backend carries CUDA tensors, not {dev}")
    return Mesh(group=None, rank=dist.get_rank(), size=dist.get_world_size(), device=dev,
                backend=backend)
