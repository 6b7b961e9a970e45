"""Block-axis (dp) sharding: a bucket's blocks spread over ranks.

Port of lorads_tpu/parallel/sharded.py.  Cones couple only through the
m-vector of constraint values, a sum over blocks, so a bucket's B axis
splits over a mesh of ranks: each rank holds its blocks and their
factors, the dual and every scalar are replicated, the per-rank partial
scatters into the m-vector are summed by one all_reduce
(pattern.scatter_constr on a placed bucket), and CG runs per block with
no traffic between ranks.

* ``make_mesh(n)``: the first n ranks of the default group;
* ``shard_bucket_axis``: this rank's blocks of every bucket
  (pattern.local_bucket: lorads_tpu's layout sliced, the port's own
  fields built anew) and of the factors;
* ``sharded_solver_step``: lorads_tpu's combined step (ALM gradient and
  one Jacobi ADMM sweep over the blocks) on the placed bucket.
"""

from __future__ import annotations

import dataclasses

import torch

from lorads_torch.alg import aop
from lorads_torch.alg.cg import cg_solve
from lorads_torch.alg.state import FactorVec
from lorads_torch.ops import pattern as pat
from lorads_torch.parallel.distributed import solver_mesh


def make_mesh(n_devices: int, device="cuda"):
    """The first ``n_devices`` ranks of the default group, their tensors
    on ``device`` (the card unless the caller asks for the CPU)."""
    return solver_mesh(n_devices, device)


def local_blocks(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows [b0, b0 + B / size) of a [B, ...] tensor."""
    k = x.shape[0] // mesh.size
    return x[mesh.index * k:(mesh.index + 1) * k]


def shard_bucket_axis(mesh, pd: aop.ProblemData, *fvs: FactorVec):
    """(pd, *fvs) with every bucket's blocks and every factor's cones
    split over ``mesh`` (this rank's part; sharded.py:100-121)."""
    pd = dataclasses.replace(pd, buckets=tuple(
        pat.local_bucket(bk, mesh) for bk in pd.buckets))
    out = [pd]
    for fv in fvs:
        out.append(FactorVec(tuple(local_blocks(mesh, x).contiguous()
                                   for x in fv.cones), fv.lp))
    return tuple(out)


def sharded_solver_step(mesh, pd: aop.ProblemData, U: FactorVec,
                        V: FactorVec, dual, rho: float):
    """One combined step on the first bucket of ``pd`` with its blocks
    split over ``mesh`` (shard_bucket_axis; sharded.py:43-97; no mesh:
    unplaced): A(sym(UV^T)) scattered and
    summed over the ranks, the ALM gradient at it, then U and V each
    solved by CG (tol 1e-10, 50 iterations) for every block at once, the
    change of the constraint values summed over the ranks.  Returns
    (U_new, V_new, constr_sum, grad), the factors this rank's blocks."""
    if mesh is not None:
        pd, U, V = shard_bucket_axis(mesh, pd, U, V)
    bk = pd.buckets[0]
    rhs = pd.rhs
    rho = torch.as_tensor(rho, dtype=rhs.dtype, device=rhs.device)
    vals = pat.constr_vals(bk, pat.uvt(bk, U.cones[0], V.cones[0]))
    total = pat.scatter_constr(bk, vals)
    w = rho * (total - rhs) - dual
    grad = 2.0 * pat.w_mul(bk, pat.build_w(bk, pat.gather_w(bk, w)),
                           U.cones[0])

    def update(upd, fixed, vals_cur, total_cur):
        base = rho * (total_cur - rhs) - dual
        w_loc = pat.gather_w(bk, base) - rho * vals_cur
        M2 = pat.w_mul(bk, pat.build_w(bk, w_loc), fixed) - rho * fixed

        def op(x):
            v = pat.constr_vals(bk, pat.uvt(bk, x, fixed))
            return x + pat.w_mul(bk, pat.build_w(bk, v, include_obj=False),
                                 fixed)

        new, _ = cg_solve(op, upd, -M2 / rho, 1e-10, 50)
        new_vals = pat.constr_vals(bk, pat.uvt(bk, new, fixed))
        return (new, new_vals,
                total_cur + pat.scatter_constr(bk, new_vals - vals_cur))

    U1, vals, total = update(U.cones[0], V.cones[0], vals, total)
    V1, vals, total = update(V.cones[0], U1, vals, total)
    return U1, V1, total, grad
