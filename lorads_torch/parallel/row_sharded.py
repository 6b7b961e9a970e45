"""Factor-row (tp) sharding of one large dense cone.

Port of lorads_tpu/parallel/row_sharded.py.  Shard d owns rows
[d n_loc, (d + 1) n_loc) of every n x n intermediate -- sym(UV^T) and
W = C + A^*(w) -- and the constraint entries, in full symmetric form
(lower entries and their mirrors), whose row falls in its slab.  The
factors stay [1, n, r] on every shard.

* ``build_rowshard_bucket``: the solver's layout, a ``rowshard``
  DenseBucketData (pattern.py: uvt and build_w give [D, n_loc, n] slabs,
  w_mul the row-distributed dsymm gathered to [1, n, r], constraint
  values per-shard partials);
* ``make_row_sharded_gradient``: lorads_tpu's shard_map building block,
  the ALM gradient, written on the rowshard bucket's own operations
  (their all_reduce and all_gather, parallel/comm.py);
  ``RowShardData``, ``build_row_shards``, ``uvt_slab``,
  ``slab_constr_vals`` and ``slab_build_w`` keep lorads_tpu's names for
  the bucket and those operations.

The slab products are ``torch.matmul`` (lorads_tpu leaves them to XLA's
einsum); A(.) on a slab is kernel K4 over the entries sorted by
constraint, and the W slab kernel K4 again, one segment a slab slot,
over the entries sorted by slab slot.
"""

from __future__ import annotations

import numpy as np
import torch

from lorads_torch import device as dev
from lorads_torch.core.presolve import BlockPlan
from lorads_torch.ops import pattern as pat


def _check_int32(n_loc: int, n: int) -> None:
    # local_row * n + col is int32 on the device: refuse rather than
    # wrap (row_sharded.py:72-76)
    if n_loc * n >= 2 ** 31:
        raise ValueError(
            f"row-slab linear indices overflow int32 (n_loc*n = "
            f"{n_loc * n:.3g}); use more devices so n/D * n < 2^31")


def _full_sym_entries(plan: BlockPlan):
    """Constraint entries in full symmetric form (row_sharded.py:44-54)."""
    er = plan.pat_rows[plan.a_pos]
    ec = plan.pat_cols[plan.a_pos]
    off = er != ec
    return (np.concatenate([er, ec[off]]), np.concatenate([ec, er[off]]),
            np.concatenate([plan.a_val, plan.a_val[off]]),
            np.concatenate([plan.a_con_loc, plan.a_con_loc[off]]))


def _c_slabs(plan: BlockPlan, D: int, n_loc: int) -> np.ndarray:
    """The full-symmetric C as [D, n_loc, n] row slabs."""
    n = plan.dim
    coff = plan.pat_rows != plan.pat_cols
    c_r = np.concatenate([plan.pat_rows, plan.pat_cols[coff]])
    c_c = np.concatenate([plan.pat_cols, plan.pat_rows[coff]])
    c_v = np.concatenate([plan.c_pat, plan.c_pat[coff]])
    c_slab = np.zeros((D, n_loc, n))
    np.add.at(c_slab, (c_r // n_loc, c_r % n_loc, c_c), c_v)
    return c_slab


def build_rowshard_bucket(plan: BlockPlan, m_glob: int, n_devices: int,
                          dtype, device="cuda") -> pat.DenseBucketData:
    """The row-slab (tp) bucket of one dense cone (row_sharded.py:57-
    136): lorads_tpu's fields -- entries per shard in constraint order
    (``a_lin`` = local_row * n + col, pad constraint m_loc, value 0),
    ``c_full`` the C slabs -- and the port's sorted copies built from
    each shard's own entries (pattern.dense_from_layout), on ``device``
    (the card unless the caller asks for the CPU)."""
    device = dev.resolve_device(device)
    n, D = plan.dim, n_devices
    n_loc = -(-n // D)
    _check_int32(n_loc, n)
    rows, cols, vals, cons = _full_sym_entries(plan)
    shard_of = rows // n_loc
    nnz_loc = max(int(np.bincount(shard_of, minlength=D).max()), 1)
    a_lin = np.zeros((D, nnz_loc), np.int64)
    a_con = np.full((D, nnz_loc), plan.m_loc, np.int64)
    a_val = np.zeros((D, nnz_loc))
    for d in range(D):
        sel = shard_of == d
        cnt = int(sel.sum())
        lin = (rows[sel] - d * n_loc).astype(np.int64) * n + cols[sel]
        o = np.argsort(cons[sel], kind="stable")
        a_lin[d, :cnt] = lin[o]
        a_con[d, :cnt] = cons[sel][o]
        a_val[d, :cnt] = vals[sel][o]
    zi = np.zeros((D, 1), np.int64)
    z1 = np.zeros((D, 1))
    meta = dict(n=n, B=D, K=n_loc * n, m_loc=plan.m_loc, m_glob=m_glob,
                nnz_a=nnz_loc, glob_ident=False, a_single_dense=False,
                nnz_dd=0)
    arrays = dict(glob_idx=np.tile(plan.loc2glob, (D, 1)),
                  c_full=_c_slabs(plan, D, n_loc), a_lin=a_lin,
                  a_lin_t=zi, a_con_loc=a_con, a_val=a_val,
                  a_val_mirror=z1, a_val_inner=a_val)
    return pat.dense_from_layout(meta, arrays, dtype, device,
                                 rowshard=True, n_loc=n_loc, B_all=D)


# lorads_tpu's RowShardData is the rowshard bucket itself: the port keeps
# one representation of the tp layout, the one the solver runs
RowShardData = pat.DenseBucketData


def build_row_shards(plan: BlockPlan, m_glob: int, n_devices: int, dtype,
                     device="cuda") -> RowShardData:
    """One block's rows cut into ``n_devices`` contiguous slabs
    (row_sharded.py:163-219): the rowshard bucket."""
    return build_rowshard_bucket(plan, m_glob, n_devices, dtype, device)


def uvt_slab(bk: RowShardData, U, V) -> torch.Tensor:
    """This rank's row slabs of sym(UV^T) [B, n_loc, n] (row_sharded.py:
    226-243), the row-sharded dsyr2k."""
    return pat.uvt(bk, U, V)


def slab_constr_vals(bk: RowShardData, slabs) -> torch.Tensor:
    """Each slab's partial <A_i, X> -> [B, m_loc] (row_sharded.py:
    246-251): kernel K4 over its constraint-sorted entries."""
    return pat.constr_vals(bk, slabs)


def slab_build_w(bk: RowShardData, w_loc, include_obj: bool = True):
    """The slabs of W = [C +] sum_i w_i A_i [B, n_loc, n]
    (row_sharded.py:254-262): kernel K4, one segment a slab slot, over
    the slot-sorted entries, C as its base."""
    return pat.build_w(bk, w_loc, include_obj)


def make_row_sharded_gradient(mesh, bk: RowShardData, c_nrm_inf: float):
    """The row-sharded ALM gradient of one dense cone
    (row_sharded.py:265-307): total = A(sym(UU^T)), w = rho (total - b)
    - dual, grad = 2 (C + A^*(w)) U, cert = ||grad|| / (1 + ||C||_inf),
    on this rank's slabs of ``bk`` (all of them without a mesh): the
    constraint partials summed by scatter_constr's all_reduce, the
    disjoint row slabs of grad gathered by w_mul's all_gather.  Returns
    step(U [n, r], rhs, dual, rho) -> (total [m], grad [n, r], cert)."""
    loc = bk if mesh is None else pat.local_bucket(bk, mesh)

    def step(U, rhs_, dual_, rho_):
        U = U[None]
        total = pat.scatter_constr(loc, slab_constr_vals(
            loc, uvt_slab(loc, U, U)))
        w = rho_ * (total - rhs_) - dual_
        grad = 2.0 * pat.w_mul(loc, slab_build_w(
            loc, pat.gather_w(loc, w)), U)[0]
        cert = torch.sqrt(torch.sum(grad * grad)) / (1.0 + c_nrm_inf)
        return total, grad, cert

    return step
