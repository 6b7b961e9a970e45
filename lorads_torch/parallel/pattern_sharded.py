"""Pattern-axis (sp) sharding of one large sparse cone.

Port of lorads_tpu/parallel/pattern_sharded.py.  The cone's union
pattern is cut into D contiguous slot ranges; shard d holds its range
and exactly the constraint entries that land there (entries sorted by
slot), padded to the largest shard.  The D shards stack on the bucket's
B axis: a ``summed`` BucketData (pattern.py's glue: the factors stay
[1, n, r] and are broadcast to the shards on kernel entry, factor-shaped
outputs and constraint partials are summed over the shards).  Unplaced,
the B axis holds every shard; placed (pattern.local_bucket) a rank holds
its own and each of those sums ends in one collective (parallel/comm.py).

``make_sharded_gradient`` is lorads_tpu's shard_map building block, the
ALM gradient with its two psums made explicit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lorads_torch import device as dev
from lorads_torch.core.presolve import BlockPlan, BucketPlan
from lorads_torch.ops import pattern as pat
from lorads_torch.parallel import comm


def diag_parent_map(plan: BlockPlan):
    """The full diagonal map a [n] of a diag-identity cone (constraint i
    == diagonal entry i, lorads_tpu's parent detection,
    pattern_sharded.py:100-123), else None."""
    n = plan.dim
    er = plan.pat_rows[plan.a_pos]
    ec = plan.pat_cols[plan.a_pos]
    is_d = er == ec
    ident = (plan.m_loc == n and plan.nnz_a == n and bool(np.all(is_d))
             and bool(np.all(np.sort(plan.a_con_loc) == np.arange(n)))
             and bool(np.all(er[np.argsort(plan.a_con_loc, kind="stable")]
                             == np.arange(n))))
    if not ident:
        return None
    full = np.zeros(n)
    full[plan.a_con_loc] = plan.a_val
    return full


def build_pattern_shards(plan: BlockPlan, m_glob: int, n_devices: int,
                         dtype, summed: bool = False,
                         device="cuda") -> pat.BucketData:
    """One block's union pattern cut into ``n_devices`` contiguous slot
    ranges, as a [D]-stacked split bucket (lorads_tpu's construction,
    pattern_sharded.py:37-123; the port's own fields built from each
    shard's entries by pattern.build_bucket_data).  ``summed``: the B
    axis is a shard axis of the one cone, and a diag-identity parent
    keeps its full diagonal map (``diag_parent``, ``a_val_d_full``).
    On ``device``: the card unless the caller asks for the CPU."""
    device = dev.resolve_device(device)
    K = plan.K
    D = n_devices
    k_per = -(-K // D)
    order = np.argsort(plan.a_pos, kind="stable")
    a_pos_s = plan.a_pos[order]
    a_con_s = plan.a_con_loc[order]
    a_val_s = plan.a_val[order]
    shard_of_entry = a_pos_s // k_per
    counts = np.bincount(shard_of_entry, minlength=D)
    nnz_loc = max(int(counts.max()), 1)
    pat_rows = np.zeros((D, k_per), np.int32)
    pat_cols = np.zeros((D, k_per), np.int32)
    c_pat = np.zeros((D, k_per))
    a_pos_l = np.zeros((D, nnz_loc), np.int32)
    a_con_l = np.zeros((D, nnz_loc), np.int32)
    a_val_l = np.zeros((D, nnz_loc))
    for d in range(D):
        lo, hi = d * k_per, min((d + 1) * k_per, K)
        w = hi - lo
        pat_rows[d, :w] = plan.pat_rows[lo:hi]
        pat_cols[d, :w] = plan.pat_cols[lo:hi]
        c_pat[d, :w] = plan.c_pat[lo:hi]
        sel = shard_of_entry == d
        cnt = int(sel.sum())
        a_pos_l[d, :cnt] = a_pos_s[sel] - lo
        a_con_l[d, :cnt] = a_con_s[sel]
        a_val_l[d, :cnt] = a_val_s[sel]
        # padding entries scatter a zero value into slot 0
    bp = BucketPlan(
        dense=False, plans=[plan] * D, n=plan.dim, K=k_per, nnz_a=nnz_loc,
        m_loc=plan.m_loc, rank=plan.rank, rank_max=plan.rank_max,
        dims=np.full(D, plan.dim, np.int32), pat_rows=pat_rows,
        pat_cols=pat_cols, c_pat=c_pat, a_pos=a_pos_l, a_con_loc=a_con_l,
        a_val=a_val_l,
        a_diag_w=np.where(np.take_along_axis(pat_rows, a_pos_l, 1)
                          == np.take_along_axis(pat_cols, a_pos_l, 1),
                          1.0, 2.0),
        glob_idx=np.tile(plan.loc2glob, (D, 1)).astype(np.int32))
    bk = pat.build_bucket_data(bp, m_glob, dtype, device)
    if not summed:
        return bk
    full = diag_parent_map(plan)
    meta, arrays, shard = pat.layout_of(bk)
    shard.update(summed=True, diag_parent=full is not None, B_all=D)
    return pat.split_from_layout(
        meta, arrays, dtype, device,
        a_val_d_full=None if full is None else np.tile(full, (D, 1)),
        **shard)


def make_sharded_gradient(mesh, bk: pat.BucketData, rhs, c_nrm_inf: float):
    """The sharded ALM gradient grad = 2 (C + A^*(w)) U with the pattern
    of ``bk`` (build_pattern_shards, not summed: each shard a block)
    spread over ``mesh`` (pattern_sharded.py:126-147): this rank's shards
    (all of them without a mesh), each sum over shards local then one
    all_reduce.  Returns step(U [n, r], rhs, dual, rho) -> (total [m],
    grad [n, r], cert)."""
    loc = bk if mesh is None else dataclasses.replace(
        pat.local_bucket(bk, mesh), mesh=None)
    one = pat.bucket_slice(loc, 0)

    def step(U, rhs_, dual_, rho_):
        Ue = U[None].expand((loc.B,) + tuple(U.shape)).contiguous()
        vals = comm.all_reduce(
            torch.sum(pat.constr_vals(loc, pat.uvt(loc, Ue, Ue)), 0),
            mesh, "sp_grad.vals")                              # [m_loc]
        total = pat.scatter_constr(one, vals[None])            # [m]
        w = rho_ * (total - rhs_) - dual_
        W = pat.build_w(loc, pat.gather_w(loc, w))
        grad = 2.0 * comm.all_reduce(
            torch.sum(pat.w_mul(loc, W, Ue), 0), mesh, "sp_grad.wmul")
        cert = torch.sqrt(torch.sum(grad * grad)) / (1.0 + c_nrm_inf)
        return total, grad, cert

    return step
