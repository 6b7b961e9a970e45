"""Sharded solves over torch.distributed ranks: dp, sp and tp.

The PyTorch/CUDA twin of examples/sharded_execution.py.  Spawns the
ranks (one process each: gloo on the CPU, NCCL on cards, one card a
rank), which join a group over a FileStore and solve three instances,
each with one layout:

  * dp -- a bucket of same-shape blocks, its blocks spread over ranks;
  * sp -- one Max-Cut cone, its union pattern cut into slot ranges;
  * tp -- one dense cone, its n x n intermediates as row slabs.

Every rank returns the whole solution; rank 0 prints.

Run:  python examples/torch/sharded_execution.py --device cpu [--ranks 2]
      (--device cuda: NCCL, needs --ranks cards)
A launch by torchrun does the same from the command line:
      python -m torch.distributed.run --nproc_per_node=2 \\
          -m lorads_torch FILE.dat-s --shard sp --device cpu
"""

import argparse
import multiprocessing
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def cases():
    from lorads_torch.io import generators
    return [
        ("dp", "4 blocks of dim 16",
         generators.random_multiblock(n_blocks=4, dim=16, m=12, seed=3)),
        ("sp", "Max-Cut n=240",
         generators.maxcut(n=240, avg_degree=4, seed=6)),
        ("tp", "one dense block of dim 16",
         generators.random_multiblock(n_blocks=1, dim=16, m=10,
                                      density=0.4, seed=7)),
    ]


def rank_main(rank: int, world: int, store: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from lorads_torch import LoradsParams
    from lorads_torch.alg.solver import LoradsSolver
    from lorads_torch.parallel import comm
    from lorads_torch.parallel.distributed import init_multihost

    torch.set_num_threads(1)
    init_multihost(store=dist.FileStore(store, world), rank=rank,
                   world_size=world, device=device)
    try:
        for mode, what, problem in cases():
            comm.reset()
            t0 = time.time()
            solver = LoradsSolver(problem, LoradsParams(
                verbose=False, shard=mode), device=device)
            res = solver.solve()
            if rank == 0:
                print(f"{mode}: {what} on {world} ranks: "
                      f"{res.status.value} pObj {res.pobj:.8e} "
                      f"({solver.shard_note}); collectives "
                      f"{sum(comm.CALLS.values())}, "
                      f"{time.time() - t0:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=rank_main,
                             args=(r, args.ranks, store, args.device))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
    if codes != [0] * args.ranks:
        print(f"rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
