"""The port's collectives, each counted by site.

lorads_tpu places a sharded bucket on a jax Mesh and lets GSPMD insert
the collectives (``psum``, ``all_gather``) where a sum, max or
concatenation runs over a device-sharded axis.  The port runs one
process per card (SPMD, torch.distributed: NCCL on CUDA tensors, gloo on
CPU tensors) and makes each of those places explicit: a local reduction
by the caller, then one call here.

A ``Mesh`` is the placement of a bucket's shard axis: the process group,
its ranks in mesh order and this process's place among them.  With no
mesh (``None``) every function returns its input: the local reduction
was the whole reduction, as in an unplaced bucket, whose B axis holds
every shard.  With a mesh, even one of a single rank, the collective is
issued.

``CALLS`` and ``BYTES`` count the collectives and the bytes each rank
contributes by site (the caller's name for the place), as
``device.HOST_SYNCS_BY`` counts host reads.  They count at issue: a
collective captured into a CUDA graph counts once, at its capture.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

CALLS = collections.Counter()
BYTES = collections.Counter()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One shard axis over ranks: ``group`` (a torch.distributed process
    group; None is the default group), ``ranks`` (global ranks in mesh
    order), ``index`` (this process's position in ``ranks``) and the
    ``device`` its tensors lie on."""

    group: object
    ranks: tuple
    index: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


def reset() -> None:
    CALLS.clear()
    BYTES.clear()


def counts() -> dict:
    """{site: (calls, bytes)}."""
    return {k: (CALLS[k], BYTES[k]) for k in sorted(CALLS)}


def _count(site: str, t: torch.Tensor) -> None:
    CALLS[site] += 1
    BYTES[site] += t.numel() * t.element_size()


def _dist():
    import torch.distributed as dist
    return dist


def all_reduce(t: torch.Tensor, mesh, site: str,
               op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or maximum (``"max"``) of ``t`` over the
    mesh's ranks, on every rank (a new tensor); ``t`` itself without a
    mesh."""
    if mesh is None:
        return t
    dist = _dist()
    out = t.contiguous().clone()
    _count(site, out)
    dist.all_reduce(out, op=(dist.ReduceOp.SUM if op == "sum"
                             else dist.ReduceOp.MAX), group=mesh.group)
    return out


def all_gather(t: torch.Tensor, mesh, site: str) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in mesh order (equal
    shapes on every rank); ``t`` itself without a mesh."""
    if mesh is None:
        return t
    dist = _dist()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    _count(site, t)
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)
