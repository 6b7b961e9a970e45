"""Pattern kernels for the split, diag-identity bucket (the Max-Cut shape).

Port of the split / diag-identity subset of lorads_tpu/ops/pattern.py.
A Max-Cut block presolves into ONE sparse bucket whose pattern is split
into its diagonal (dense [B, n] vectors) and its strictly-lower entries,
and whose constraints are the diagonal identities A_i = a_i e_i e_i^T
(``diag_ident``).  A(.) and A^*(.) are then elementwise, and the sparse
work is C @ X (``cmul``, kernel K2) and the off-pattern values of
sym(U V^T) (``uvt``, kernel K3); K1 (``comp_segment_sum``) is the
segment-sum primitive, fused inside K2 on this path.

Any other bucket (dense, split but not diag-identity, B > 1, constraint
slots that are not the global ones) raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lorads_torch.core.presolve import BucketPlan
from lorads_torch.ops import kernels


def comp_segment_sum(data: torch.Tensor, bounds: torch.Tensor):
    """Sorted segment sum of ``data`` [B, N(, r)] over ``bounds``
    [B, S+1] (pattern.py:138-170) -> [B, S(, r)]: kernel K1."""
    return kernels.segment_sum(data, bounds)


def single_segment_sum(data: torch.Tensor, bounds: torch.Tensor):
    """Segment sum when every segment holds at most one entry
    (pattern.py:220-233).  K1 sums a one-entry segment exactly, so this
    is the same kernel."""
    return kernels.segment_sum(data, bounds)


@dataclasses.dataclass(frozen=True)
class BucketData:
    """Device tensors of one split, diag-identity bucket ([B, ...], B=1).

    Field names and layouts are those of lorads_tpu's BucketData."""

    n: int
    B: int
    K: int
    m_loc: int
    m_glob: int
    Ko: int
    Ks: int
    has_off: bool
    glob_ident: bool
    glob_idx: torch.Tensor      # int32 [B, m_loc]
    c_diag: torch.Tensor        # [B, n]
    a_val_d: torch.Tensor       # [B, n] (constraint i == diagonal entry i)
    off_rows: torch.Tensor      # int32 [B, Ko] strictly-lower rows
    off_cols: torch.Tensor      # int32 [B, Ko]
    c_off: torch.Tensor         # [B, Ko]
    c_off2: torch.Tensor        # [B, Ko] = 2 * c_off
    sym_rows_rs: torch.Tensor   # int32 [B, Ks] full-symmetric, row-sorted
    sym_cols_rs: torch.Tensor   # int32 [B, Ks]
    c_sym_rs: torch.Tensor      # [B, Ks]
    bnd_sym_rows: torch.Tensor  # int32 [B, n+1]
    split: bool = True
    diag_ident: bool = True
    dense: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return self.c_diag.dtype


# the arrays a BucketData is made of (names shared with lorads_tpu)
INT_FIELDS = ("glob_idx", "off_rows", "off_cols", "sym_rows_rs",
              "sym_cols_rs", "bnd_sym_rows")
FLOAT_FIELDS = ("c_diag", "a_val_d", "c_off", "c_off2", "c_sym_rs")


def bucket_from_arrays(meta: dict, arrays: dict, dtype,
                       device) -> BucketData:
    """BucketData from numpy arrays (``arrays``) and the scalar layout
    (``meta``: n, B, K, m_loc, m_glob, Ko, Ks, has_off, glob_ident)."""
    t = {k: torch.as_tensor(np.array(arrays[k], dtype=np.int32),
                            device=device)
         for k in INT_FIELDS}
    t.update({k: torch.as_tensor(np.array(arrays[k], dtype=np.float64),
                                 device=device).to(dtype).contiguous()
              for k in FLOAT_FIELDS})
    return BucketData(**meta, **t)


def _bounds_np(ids: np.ndarray, S: int) -> np.ndarray:
    """bnd[b, j] = first position in the sorted ids[b] with value >= j."""
    out = np.zeros((ids.shape[0], S + 1), np.int32)
    r = np.arange(S + 1)
    for b in range(ids.shape[0]):
        out[b] = np.searchsorted(ids[b], r)
    return out


def build_bucket_data(bp: BucketPlan, m_glob: int, dtype,
                      device) -> BucketData:
    """Host construction of the split, diag-identity fields of one
    bucket, in lorads_tpu's layout (pattern.py:578-766, 909-930)."""
    if bp.dense:
        raise NotImplementedError(
            "dense-mode buckets not yet ported to lorads_torch")
    if bp.B != 1:
        raise NotImplementedError(
            "buckets of B > 1 blocks not yet ported to lorads_torch")
    n = bp.n
    pr = bp.pat_rows[0].astype(np.int64)
    pc = bp.pat_cols[0].astype(np.int64)
    cp = bp.c_pat[0]
    is_d = pr == pc
    off_idx = np.nonzero(~is_d)[0]
    c_diag = np.zeros((1, n))
    np.add.at(c_diag[0], pr[is_d], cp[is_d])
    orow, ocol, oval = pr[off_idx], pc[off_idx], cp[off_idx]

    ap = bp.a_pos[0].astype(np.int64)
    ac = bp.a_con_loc[0].astype(np.int64)
    ed = is_d[ap]
    con_d, row_d, val_d = ac[ed], pr[ap[ed]], bp.a_val[0][ed]
    od = np.argsort(con_d, kind="stable")
    con_d, row_d, val_d = con_d[od], row_d[od], val_d[od]
    p = bp.plans[0]
    ident = (p.dim == n and p.m_loc == n and con_d.size == n
             and int((~ed).sum()) == 0
             and bool(np.all(con_d == np.arange(n)))
             and bool(np.all(row_d == np.arange(n))))
    if not ident:
        raise NotImplementedError(
            "split buckets whose constraints are not diagonal identities "
            "not yet ported to lorads_torch")
    glob_ident = (bp.m_loc == m_glob
                  and bool(np.array_equal(bp.glob_idx[0],
                                          np.arange(m_glob))))
    if not glob_ident:
        raise NotImplementedError(
            "buckets whose constraint slots are not the global ones not "
            "yet ported to lorads_torch")

    Ko = max(orow.size, 1)
    pad = lambda x, L, dt: np.concatenate(
        [x, np.zeros(L - x.size, dt)])[None]
    off_rows = pad(orow, Ko, np.int64)
    off_cols = pad(ocol, Ko, np.int64)
    c_off = pad(oval, Ko, np.float64)

    # full-symmetric entries (lower + mirror) sorted by row; padding
    # carries (row 0, col 0, value 0) and joins row 0's segment
    Ks = max(2 * orow.size, 1)
    sr = np.concatenate([orow, ocol])
    sc = np.concatenate([ocol, orow])
    sv = np.concatenate([oval, oval])
    o_rs = np.argsort(sr, kind="stable")
    sym_rows = pad(sr[o_rs], Ks, np.int64)[0]
    sym_cols = pad(sc[o_rs], Ks, np.int64)[0]
    sym_vals = pad(sv[o_rs], Ks, np.float64)[0]
    row_sorted = np.argsort(sym_rows, kind="stable")
    sym_rows = sym_rows[row_sorted][None]
    sym_cols = sym_cols[row_sorted][None]
    sym_vals = sym_vals[row_sorted][None]

    meta = dict(n=n, B=1, K=bp.K, m_loc=bp.m_loc, m_glob=m_glob, Ko=Ko,
                Ks=Ks, has_off=bool(orow.size), glob_ident=glob_ident)
    arrays = dict(
        glob_idx=bp.glob_idx, c_diag=c_diag, a_val_d=val_d[None],
        off_rows=off_rows, off_cols=off_cols, c_off=c_off,
        c_off2=2.0 * c_off, sym_rows_rs=sym_rows, sym_cols_rs=sym_cols,
        c_sym_rs=sym_vals, bnd_sym_rows=_bounds_np(sym_rows, n))
    return bucket_from_arrays(meta, arrays, dtype, device)


def cast_floats(bk: BucketData, dtype) -> BucketData:
    """The bucket with every float tensor cast to ``dtype`` (the f32 view
    the Lanczos certificate sweeps on)."""
    return dataclasses.replace(
        bk, **{k: getattr(bk, k).to(dtype) for k in FLOAT_FIELDS})


def scale_bucket(bk: BucketData, s: float) -> BucketData:
    """The bucket with its objective data scaled by s (reopt)."""
    return dataclasses.replace(
        bk, c_diag=bk.c_diag * s, c_off=bk.c_off * s, c_off2=bk.c_off2 * s,
        c_sym_rs=bk.c_sym_rs * s)


# ---------------------------------------------------------------------------
# Kernels.  Factors are [B, n, r].
# ---------------------------------------------------------------------------

def uvt(bk: BucketData, U: torch.Tensor, V: torch.Tensor):
    """sym(UV^T) on the split pattern: (diag [B, n], off [B, Ko]) --
    kernel K3 (pattern.py:1085-1092)."""
    return kernels.uvt_split(U.contiguous(), V.contiguous(), bk.off_rows,
                             bk.off_cols)


def constr_vals(bk: BucketData, uvt_val) -> torch.Tensor:
    """A(sym(UV^T)) -> [B, m_loc]; constraint i is diagonal entry i."""
    d, _ = uvt_val
    return bk.a_val_d * d


def obj_inner(bk: BucketData, uvt_val) -> torch.Tensor:
    """<C, sym(UV^T)> per block -> [B]."""
    d, o = uvt_val
    out = torch.sum(bk.c_diag * d, dim=1)
    if bk.has_off:
        out = out + torch.sum(bk.c_off2 * o, dim=1)
    return out


def scatter_constr(bk: BucketData, vals: torch.Tensor) -> torch.Tensor:
    """Local constraint values -> the global m-vector (identity map)."""
    return vals[0]


def gather_w(bk: BucketData, w: torch.Tensor) -> torch.Tensor:
    """The global m-vector at this bucket's constraint slots."""
    return w[None]


def build_w(bk: BucketData, w_loc: torch.Tensor, include_obj: bool = True):
    """W = [C +] sum_i w_i A_i on the split pattern: (W_d [B, n],
    W_o [B, Ko]).  The constraints touch only the diagonal, so W's off
    part is C's.  (lorads_tpu also returns a column-order mirror of W_o
    for its sorted TPU scatters; nothing here reads it.)"""
    W_d = bk.a_val_d * w_loc
    W_o = torch.zeros((w_loc.shape[0], bk.Ko), dtype=w_loc.dtype,
                      device=w_loc.device)
    if include_obj:
        return bk.c_diag + W_d, bk.c_off + W_o
    return W_d, W_o


def densify_w(bk: BucketData, W) -> torch.Tensor:
    """A build_w output as full symmetric [B, n, n] matrices
    (certificate-time only, for the exact-eigh branch)."""
    W_d, W_o = W
    out = torch.diag_embed(W_d)
    if bk.has_off:
        rows, cols = bk.off_rows.long(), bk.off_cols.long()
        for b in range(out.shape[0]):
            # pad slots carry zero values, so their additions are no-ops
            out[b].index_put_((rows[b], cols[b]), W_o[b], accumulate=True)
            out[b].index_put_((cols[b], rows[b]), W_o[b], accumulate=True)
    return out


def cmul(bk: BucketData, X: torch.Tensor,
         include_diag: bool = True) -> torch.Tensor:
    """C @ X [B, n, r] over the full-symmetric row-sorted entry list --
    kernel K2 (pattern.py:1509-1550).  The fused kernel never writes the
    [Ks, r] product, so the TPU version's entry chunking is gone."""
    return kernels.cmul_csr(X.contiguous(),
                            bk.c_diag if include_diag else None,
                            bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
