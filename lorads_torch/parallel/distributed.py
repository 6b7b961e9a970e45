"""Process-group set-up and the solver's mesh.

Port of lorads_tpu/parallel/distributed.py.  lorads_tpu initialises
``jax.distributed`` once per host and meshes ``jax.devices()``; the
port runs one process per card and initialises torch.distributed:

* ``init_multihost()``: ``init_process_group`` with NCCL for CUDA and
  gloo for the CPU, from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), from explicit
  arguments, or from a ``store`` (a ``FileStore`` or ``HashStore``);
* ``solver_mesh(n_devices)``: the first ``n_devices`` ranks of the
  default group as a ``comm.Mesh`` (``jax.devices()[:n_devices]``).

Importing this module initialises no process group and no CUDA context;
a run without a process group needs none of it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from lorads_torch.device import resolve_device
from lorads_torch.parallel.comm import Mesh


def init_multihost(backend: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   init_method: Optional[str] = None, store=None,
                   device: str = "cuda", timeout_s: float = 600.0) -> None:
    """Initialise the default process group once per process.

    ``backend`` defaults to ``nccl`` for ``device="cuda"`` and ``gloo``
    for ``"cpu"``; ``rank`` / ``world_size`` default to torchrun's
    ``RANK`` / ``WORLD_SIZE``.  Give a ``store`` or an ``init_method``
    (``tcp://host:port``), else the group rendezvous at
    ``MASTER_ADDR:MASTER_PORT`` (torchrun's ``env://``).  On CUDA the
    process takes card ``LOCAL_RANK`` (default: its rank)."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1))
                  if world_size is None else world_size)
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)


def world() -> tuple:
    """(rank, world size) of the default group; (0, 1) without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def solver_mesh(n_devices: Optional[int] = None,
                device="cuda") -> Optional[Mesh]:
    """The mesh over the first ``n_devices`` ranks of the default group
    (all of them by default), its tensors on ``device`` (the card unless
    the caller asks for the CPU), or None without a group.  A rank
    outside the mesh holds no shard: it raises."""
    import torch.distributed as dist

    rank, size = world()
    if size == 1 and not dist.is_initialized():
        return None
    nd = size if n_devices is None else min(int(n_devices), size)
    ranks = tuple(range(nd))
    # every rank of the default group takes part in new_group
    group = None if nd == size else dist.new_group(list(ranks))
    if rank not in ranks:
        raise RuntimeError(f"rank {rank} lies outside the {nd}-rank mesh "
                           f"(n_devices={n_devices}); it holds no shard")
    return Mesh(group=group, ranks=ranks, index=rank,
                device=resolve_device(device))
