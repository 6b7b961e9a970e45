"""Pattern kernels for single-block buckets: split sparse and dense.

Port of the split and dense subsets of lorads_tpu/ops/pattern.py.  A
sparse block
presolves into ONE bucket whose pattern is split into its diagonal
(dense [B, n] vectors) and its strictly-lower entries ("off slots").
Constraints sit on any diagonal or off slots; their entries are kept in
lorads_tpu's layout (``a_con_d``/``a_row_d``/``a_val_d`` on the
diagonal, ``a_con_o``/``a_pos_o``/``a_val_o`` on the off slots, and
their slot- and row-sorted copies ``a_*_s``).  Two shapes:

* diag-identity (``diag_ident``, Max-Cut): A_i = a_i e_i e_i^T, so A(.)
  and A^*(.) are elementwise and the sparse work is C @ X (``cmul``,
  kernel K2) and the off values of sym(U V^T) (``uvt``, K3);
* general (matrix completion, ...): A(.) and A^*(.) are gathers and
  segment sums (``constr_vals``, ``build_w``: K4), W @ X reads W's off
  values through the entry list (``w_mul``: K5), the line search's pair
  SDDMM is K3p (``uvt_pair``), and the ADMM CG operator's
  A^*(A(.)) is K6 (``a_adj_a``) when every off constraint owns a slot.

Layout decisions of the port (fields lorads_tpu has and this module does
not build):

* no column-order mirror of the off pattern (``off_col_perm``,
  ``off_cols_sp``, ``off_rows_cp``, ``c_off_cp``, ``a2_off_cp``,
  ``a_*_co_s``) and no row-sorted off copy (``off_row_perm``,
  ``off_rows_s``, ``off_cols_rp``).  They exist because unsorted TPU
  scatters run at random-access latency.  Instead every split bucket
  carries the full-symmetric row-sorted entry list (``sym_rows_rs``,
  ``sym_cols_rs``, ``bnd_sym_rows``, with ``c_sym_rs``) and, port-only,
  ``sym_slot_rs``: the off slot each entry reads, so W @ X is one pass;
* no gathered-row caches (``gather_cache`` gives None): the cached
  forms compute from the factors directly, which a fused SDDMM reads
  from L2;
* a constraint-sorted copy of the off constraint entries with CSR
  bounds (``a_con_o_cs``, ``a_pos_o_cs``, ``a_val_o_cs``,
  ``bnd_a_con_o_cs``) that always exists (lorads_tpu has bounds only
  when ``a_con_o`` happens to be sorted).  The diagonal entries are
  constraint-sorted by construction (``a_con_d``, ``bnd_a_con_d``).

A dense block (Lovász theta: C = -J) presolves into one DenseBucketData
holding lorads_tpu's dense fields: the full symmetric C (``c_full``),
the constraint entries at their lower and mirrored flat slots
(``a_lin``, ``a_lin_t``) with values ``a_val`` / ``a_val_mirror`` /
``a_val_inner``, and, when every constraint is single-entry or
diagonal-only (``a_single_dense``), the static plane ``a2_full`` of
A^*(A(.)) and the diagonal-only entries ``dd_*``.  Products of the
factors are ``torch.matmul`` (lorads_tpu leaves them to XLA); A(.) and
C + A^*(w) are kernel K4 over port-only CSR layouts, and A^*(A(.)) of
the CG operator is kernel K7a (``a_adj_a_dense``).  Port-only layout:

* (i) the constraint entries sorted by constraint (``a_lin_cs``,
  ``a_val_inner_cs``, CSR bounds ``bnd_a_con_cs`` over m_loc): A(.) is
  K4 over the flat [B, n^2] view of sym(UV^T);
* (ii) the lower and mirrored entries sorted by flat slot
  (``a_con2_s``, ``a_val2_s``, bounds ``bnd_a_lin2`` over the n^2
  slots; lorads_tpu's ``a_lin2_perm`` / ``bnd_a_lin2``): build_w is K4
  with one segment per slot and ``c_full`` as its base;
* (iii) the ``dd_*`` entries sorted by constraint (``dd_row_cs``,
  ``dd_val_cs``, ``bnd_dd_con``) and by row (``dd_con_rs``,
  ``dd_val_rs``, ``bnd_dd_row``).

Every sorted list leaves out the entries whose value is 0 (padding and
the diagonal's zeroed mirrors) and any constraint id >= m_loc, so K4
never reads outside x.  lorads_tpu's two-plane f32 scatter of f64 W
(``a_lin2_exact``) is not ported: it exists because TPU f64 is emulated.

B > 1 and constraint slots that are not the global ones raise
NotImplementedError.
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
    """Device tensors of one split bucket ([B, ...], B=1).

    Field names and layouts are those of lorads_tpu's BucketData, plus
    the port-only fields named in the module docstring."""

    n: int
    B: int
    K: int
    m_loc: int
    m_glob: int
    Ko: int
    Ks: int
    nnz_d: int
    nnz_o: int
    has_off: bool
    has_diag_a: bool
    has_off_a: bool
    a_off_unique: bool
    glob_ident: bool
    diag_ident: bool
    glob_idx: torch.Tensor      # int32 [B, m_loc]
    c_diag: torch.Tensor        # [B, n]
    off_rows: torch.Tensor      # int32 [B, Ko] strictly-lower rows
    off_cols: torch.Tensor      # int32 [B, Ko]
    c_off: torch.Tensor         # [B, Ko]
    c_off2: torch.Tensor        # [B, Ko] = 2 * c_off
    # diagonal constraint entries, sorted by constraint (diag_ident:
    # constraint i == diagonal entry i, so a_val_d is [B, n])
    a_con_d: torch.Tensor       # int32 [B, nnz_d]
    a_row_d: torch.Tensor       # int32 [B, nnz_d]
    a_val_d: torch.Tensor       # [B, nnz_d]
    bnd_a_con_d: torch.Tensor   # int32 [B, m_loc+1]
    # ... and sorted by row (build_w's W_d)
    a_row_d_s: torch.Tensor     # int32 [B, nnz_d]
    a_con_d_s: torch.Tensor     # int32 [B, nnz_d]
    a_val_d_s: torch.Tensor     # [B, nnz_d]
    bnd_a_row_d_s: torch.Tensor  # int32 [B, n+1]
    # off constraint entries (raw values; <A, X> doubles them)
    a_con_o: torch.Tensor       # int32 [B, nnz_o]
    a_pos_o: torch.Tensor       # int32 [B, nnz_o] off slot
    a_val_o: torch.Tensor       # [B, nnz_o]
    # ... sorted by slot (build_w's W_o)
    a_pos_o_s: torch.Tensor     # int32 [B, nnz_o]
    a_con_o_s: torch.Tensor     # int32 [B, nnz_o]
    a_val_o_s: torch.Tensor     # [B, nnz_o]
    bnd_a_pos_o_s: torch.Tensor  # int32 [B, Ko+1]
    a2_off: torch.Tensor        # [B, Ko] sum of 2 a^2 per slot
    # full-symmetric entries (lower + mirror), row-sorted
    sym_rows_rs: torch.Tensor   # int32 [B, Ks]
    sym_cols_rs: torch.Tensor   # int32 [B, Ks]
    c_sym_rs: torch.Tensor      # [B, Ks]
    bnd_sym_rows: torch.Tensor  # int32 [B, n+1]
    # port-only: the off slot of each sym entry (-1: padding) and the
    # constraint-sorted off constraint entries
    sym_slot_rs: torch.Tensor   # int32 [B, Ks]
    a_con_o_cs: torch.Tensor    # int32 [B, nnz_o]
    a_pos_o_cs: torch.Tensor    # int32 [B, nnz_o]
    a_val_o_cs: torch.Tensor    # [B, nnz_o]
    bnd_a_con_o_cs: torch.Tensor  # int32 [B, m_loc+1]
    split: bool = True
    dense: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return self.c_diag.dtype


# the arrays a BucketData is made of.  INT_FIELDS and FLOAT_FIELDS are
# shared with lorads_tpu's BucketData for every split bucket; SYM_*
# exist in lorads_tpu for diag-identity buckets only; PORT_* are the
# port's own.
INT_FIELDS = ("glob_idx", "off_rows", "off_cols", "a_con_d", "a_row_d",
              "bnd_a_con_d", "a_row_d_s", "a_con_d_s", "bnd_a_row_d_s",
              "a_con_o", "a_pos_o", "a_pos_o_s", "a_con_o_s",
              "bnd_a_pos_o_s")
FLOAT_FIELDS = ("c_diag", "a_val_d", "c_off", "c_off2", "a_val_d_s",
                "a_val_o", "a_val_o_s", "a2_off")
SYM_INT_FIELDS = ("sym_rows_rs", "sym_cols_rs", "bnd_sym_rows")
SYM_FLOAT_FIELDS = ("c_sym_rs",)
PORT_INT_FIELDS = ("sym_slot_rs", "a_con_o_cs", "a_pos_o_cs",
                   "bnd_a_con_o_cs")
PORT_FLOAT_FIELDS = ("a_val_o_cs",)
ALL_INT_FIELDS = INT_FIELDS + SYM_INT_FIELDS + PORT_INT_FIELDS
ALL_FLOAT_FIELDS = FLOAT_FIELDS + SYM_FLOAT_FIELDS + PORT_FLOAT_FIELDS
# the scalar layout (meta) of a BucketData
META_FIELDS = ("n", "B", "K", "m_loc", "m_glob", "Ko", "Ks", "nnz_d",
               "nnz_o", "has_off", "has_diag_a", "has_off_a",
               "a_off_unique", "glob_ident", "diag_ident")


def bucket_from_arrays(meta: dict, arrays: dict, dtype,
                       device) -> BucketData:
    """BucketData from numpy arrays (``arrays``) and the scalar layout
    (``meta``: META_FIELDS)."""
    t = {k: torch.as_tensor(np.array(arrays[k], dtype=np.int32),
                            device=device)
         for k in ALL_INT_FIELDS}
    t.update({k: torch.as_tensor(np.array(arrays[k], dtype=np.float64),
                                 device=device).to(dtype).contiguous()
              for k in ALL_FLOAT_FIELDS})
    return BucketData(**meta, **t)


def _bounds_np(ids: np.ndarray, S: int) -> np.ndarray:
    """bnd[b, j] = first position in the sorted ids[b] with value >= j."""
    out = np.zeros((ids.shape[0], S + 1), np.int32)
    r = np.arange(S + 1)
    for b in range(ids.shape[0]):
        out[b] = np.searchsorted(ids[b], r)
    return out


def _pad(x, L, fill=0):
    """[1, L] copy of the 1-D ``x`` padded with ``fill``."""
    out = np.full((1, L), fill, dtype=np.asarray(x).dtype)
    out[0, :x.size] = x
    return out


def port_fields(n: int, m_loc: int, off_rows, off_cols, c_off, a_con_o,
                a_pos_o, a_val_o) -> dict:
    """The port's host-built arrays of a B = 1 split bucket, from its
    lorads_tpu-layout off pattern ([1, Ko] off_rows/off_cols/c_off) and
    off constraint entries ([1, nnz_o] a_con_o/a_pos_o/a_val_o): the
    full-symmetric row-sorted entry list with each entry's off slot,
    and the constraint-sorted off constraint entries with CSR bounds.
    Padding slots (value 0) are left out of the entry list; its own
    padding carries (row 0, col 0, value 0, slot -1)."""
    k = int(np.count_nonzero(off_rows[0] != off_cols[0]))
    orow = off_rows[0, :k].astype(np.int64)
    ocol = off_cols[0, :k].astype(np.int64)
    oval = np.asarray(c_off[0, :k], np.float64)
    Ks = max(2 * k, 1)
    sr = np.concatenate([orow, ocol])
    sc = np.concatenate([ocol, orow])
    sv = np.concatenate([oval, oval])
    ss = np.concatenate([np.arange(k), np.arange(k)])
    o_rs = np.argsort(sr, kind="stable")
    sym_rows = _pad(sr[o_rs], Ks)
    sym_cols = _pad(sc[o_rs], Ks)
    sym_vals = _pad(sv[o_rs], Ks)
    sym_slot = _pad(ss[o_rs], Ks, fill=-1)
    # padding (row 0) sorts to the front of row 0's segment
    rs = np.argsort(sym_rows[0], kind="stable")
    sym_rows, sym_cols = sym_rows[:, rs], sym_cols[:, rs]
    sym_vals, sym_slot = sym_vals[:, rs], sym_slot[:, rs]
    oc = np.argsort(a_con_o[0], kind="stable")
    con_cs = np.asarray(a_con_o)[:, oc]
    return dict(
        Ks=Ks, sym_rows_rs=sym_rows, sym_cols_rs=sym_cols,
        c_sym_rs=sym_vals, bnd_sym_rows=_bounds_np(sym_rows, n),
        sym_slot_rs=sym_slot, a_con_o_cs=con_cs,
        a_pos_o_cs=np.asarray(a_pos_o)[:, oc],
        a_val_o_cs=np.asarray(a_val_o)[:, oc],
        bnd_a_con_o_cs=_bounds_np(con_cs, m_loc))


@dataclasses.dataclass(frozen=True)
class DenseBucketData:
    """Device tensors of one dense bucket ([B, ...], B=1).

    Field names and layouts are those of lorads_tpu's dense BucketData,
    plus the port-only sorted copies named in the module docstring.
    The a2_full / dd_* fields exist only when a_single_dense."""

    n: int
    B: int
    K: int
    m_loc: int
    m_glob: int
    nnz_a: int
    glob_ident: bool
    a_single_dense: bool
    nnz_dd: int
    glob_idx: torch.Tensor      # int32 [B, m_loc]
    c_full: torch.Tensor        # [B, n, n] full symmetric C
    a_lin: torch.Tensor         # int32 [B, nnz_a] row * n + col
    a_lin_t: torch.Tensor       # int32 [B, nnz_a] col * n + row
    a_con_loc: torch.Tensor     # int32 [B, nnz_a]
    a_val: torch.Tensor         # [B, nnz_a]
    a_val_mirror: torch.Tensor  # [B, nnz_a] 0 on the diagonal
    a_val_inner: torch.Tensor   # [B, nnz_a] x2 off the diagonal
    # port-only (i): A(.) layout
    a_lin_cs: torch.Tensor      # int32 [B, N1]
    a_val_inner_cs: torch.Tensor  # [B, N1]
    bnd_a_con_cs: torch.Tensor  # int32 [B, m_loc+1]
    # port-only (ii): A^*(w) layout
    a_con2_s: torch.Tensor      # int32 [B, N2]
    a_val2_s: torch.Tensor      # [B, N2]
    bnd_a_lin2: torch.Tensor    # int32 [B, n*n+1]
    # single-entry / diagonal-only constraints (a_single_dense)
    a2_full: torch.Tensor = None  # [B, n, n] static plane of A^*(A(.))
    dd_con: torch.Tensor = None   # int32 [B, max(nnz_dd, 1)]
    dd_row: torch.Tensor = None   # int32 [B, max(nnz_dd, 1)]
    dd_val: torch.Tensor = None   # [B, max(nnz_dd, 1)]
    # port-only (iii): the dd entries by constraint and by row
    dd_row_cs: torch.Tensor = None
    dd_val_cs: torch.Tensor = None
    bnd_dd_con: torch.Tensor = None  # int32 [B, m_loc+1]
    dd_con_rs: torch.Tensor = None
    dd_val_rs: torch.Tensor = None
    bnd_dd_row: torch.Tensor = None  # int32 [B, n+1]
    split: bool = False
    dense: bool = True
    diag_ident: bool = False
    a_off_unique: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return self.c_full.dtype


# the arrays of a DenseBucketData shared with lorads_tpu (the DD_*
# ones only when a_single_dense), its scalar layout, and its integer
# fields
DENSE_FIELDS = ("glob_idx", "c_full", "a_lin", "a_lin_t", "a_con_loc",
                "a_val", "a_val_mirror", "a_val_inner")
DENSE_DD_FIELDS = ("a2_full", "dd_con", "dd_row", "dd_val")
DENSE_META_FIELDS = ("n", "B", "K", "m_loc", "m_glob", "nnz_a",
                     "glob_ident", "a_single_dense", "nnz_dd")
_DENSE_INT_FIELDS = frozenset((
    "glob_idx", "a_lin", "a_lin_t", "a_con_loc", "a_lin_cs",
    "bnd_a_con_cs", "a_con2_s", "bnd_a_lin2", "dd_con", "dd_row",
    "dd_row_cs", "bnd_dd_con", "dd_con_rs", "bnd_dd_row"))


def _csr(key, idx, val, S: int):
    """The entries (key, idx, val) of [1, N] arrays whose value is
    nonzero and whose key lies in [0, S), stably sorted by key ->
    ([1, L] idx, [1, L] val, [1, S+1] bounds), L = max(count, 1); the
    padding entry, if any, lies past the last bound."""
    key, idx, val = (np.asarray(a).reshape(-1) for a in (key, idx, val))
    keep = (val != 0) & (key >= 0) & (key < S)
    o = np.argsort(key[keep], kind="stable")
    key, idx, val = key[keep][o], idx[keep][o], val[keep][o]
    L = max(key.size, 1)
    return (_pad(idx.astype(np.int64), L), _pad(val.astype(np.float64), L),
            _bounds_np(key[None], S))


def dense_port_fields(n: int, m_loc: int, a_lin, a_lin_t, a_con_loc,
                      a_val, a_val_mirror, a_val_inner, dd_con=None,
                      dd_row=None, dd_val=None) -> dict:
    """The port's host-built sorted copies (i)-(iii) of a B = 1 dense
    bucket from its lorads_tpu-layout [1, nnz_a] entry arrays (and the
    dd entries when a_single_dense).  Entries of constraint id >= m_loc
    are left out (their value is taken as 0)."""
    con = np.asarray(a_con_loc)
    ok = con < m_loc
    out = {}
    out["a_lin_cs"], out["a_val_inner_cs"], out["bnd_a_con_cs"] = _csr(
        con, a_lin, np.where(ok, a_val_inner, 0.0), m_loc)
    out["a_con2_s"], out["a_val2_s"], out["bnd_a_lin2"] = _csr(
        np.concatenate([a_lin, a_lin_t], axis=1),
        np.concatenate([con, con], axis=1),
        np.where(np.concatenate([ok, ok], axis=1),
                 np.concatenate([a_val, a_val_mirror], axis=1), 0.0), n * n)
    if dd_con is not None:
        out["dd_row_cs"], out["dd_val_cs"], out["bnd_dd_con"] = _csr(
            dd_con, dd_row, dd_val, m_loc)
        out["dd_con_rs"], out["dd_val_rs"], out["bnd_dd_row"] = _csr(
            dd_row, dd_con, np.where(np.asarray(dd_con) < m_loc, dd_val,
                                     0.0), n)
    return out


def dense_bucket_from_arrays(meta: dict, arrays: dict, dtype,
                             device) -> DenseBucketData:
    """DenseBucketData from numpy arrays (None stays None) and the scalar
    layout (``meta``: DENSE_META_FIELDS)."""
    t = {}
    for k, a in arrays.items():
        if a is None:
            t[k] = None
        elif k in _DENSE_INT_FIELDS:
            t[k] = torch.as_tensor(np.array(a, dtype=np.int32),
                                   device=device)
        else:
            t[k] = torch.as_tensor(np.array(a, dtype=np.float64),
                                   device=device).to(dtype).contiguous()
    return DenseBucketData(**meta, **t)


def build_dense_bucket_data(bp: BucketPlan, m_glob: int, dtype,
                            device) -> DenseBucketData:
    """Host construction of a B = 1 dense bucket in lorads_tpu's layout
    (pattern.py:826-908), plus the port's sorted copies
    (dense_port_fields)."""
    n = bp.n
    if n * n >= 2 ** 31:
        raise ValueError(f"dense bucket n={n}: n^2 slots overflow int32")
    rows = bp.pat_rows.astype(np.int64)
    cols = bp.pat_cols.astype(np.int64)
    ap = bp.a_pos.astype(np.int64)
    a_rows = np.take_along_axis(rows, ap, axis=1)
    a_cols = np.take_along_axis(cols, ap, axis=1)
    is_diag = rows == cols
    a_val_inner = bp.a_val * np.where(a_rows == a_cols, 1.0, 2.0)
    a_val_mirror = np.where(a_rows == a_cols, 0.0, bp.a_val)
    c_full = np.zeros((1, n, n))
    np.add.at(c_full[0], (rows[0], cols[0]), bp.c_pat[0])
    np.add.at(c_full[0], (cols[0], rows[0]),
              np.where(is_diag[0], 0.0, bp.c_pat[0]))

    # every (real) constraint single-entry or diagonal-only
    # (pattern.py:855-893)
    real = bp.a_val[0] != 0.0
    con = bp.a_con_loc[0][real].astype(np.int64)
    r_, c_, v_ = a_rows[0][real], a_cols[0][real], bp.a_val[0][real]
    d_ = r_ == c_
    all_diag = np.ones(bp.m_loc, bool)
    np.logical_and.at(all_diag, con, d_)
    cnts = np.bincount(con, minlength=bp.m_loc)
    single_ok = bool(np.all(all_diag[con] | (cnts[con] == 1)))
    dsel = all_diag[con]
    nnz_dd = int(np.count_nonzero(dsel))
    meta = dict(n=n, B=1, K=bp.K, m_loc=bp.m_loc, m_glob=m_glob,
                nnz_a=bp.nnz_a, glob_ident=True, a_single_dense=single_ok,
                nnz_dd=nnz_dd)
    arrays = dict(glob_idx=bp.glob_idx, c_full=c_full,
                  a_lin=a_rows * n + a_cols, a_lin_t=a_cols * n + a_rows,
                  a_con_loc=bp.a_con_loc, a_val=bp.a_val,
                  a_val_mirror=a_val_mirror, a_val_inner=a_val_inner)
    if single_ok:
        osel = ~dsel
        w2 = np.where(d_[osel], 1.0, 2.0) * v_[osel] ** 2
        a2_full = np.zeros((1, n, n))
        np.add.at(a2_full[0], (r_[osel], c_[osel]), w2)
        np.add.at(a2_full[0], (c_[osel], r_[osel]),
                  np.where(d_[osel], 0.0, w2))
        L = max(nnz_dd, 1)
        arrays.update(a2_full=a2_full, dd_con=_pad(con[dsel], L),
                      dd_row=_pad(r_[dsel], L),
                      dd_val=_pad(v_[dsel].astype(np.float64), L))
    port = dense_port_fields(
        n, bp.m_loc, arrays["a_lin"], arrays["a_lin_t"], bp.a_con_loc,
        bp.a_val, a_val_mirror, a_val_inner,
        *(arrays[k] for k in ("dd_con", "dd_row", "dd_val"))
        if single_ok else ())
    arrays.update(port)
    return dense_bucket_from_arrays(meta, arrays, dtype, device)


def build_bucket_data(bp: BucketPlan, m_glob: int, dtype, device):
    """Host construction of one bucket: dense buckets in
    build_dense_bucket_data, split ones here in lorads_tpu's layout
    (pattern.py:578-766, 909-930) plus the port's own fields
    (port_fields)."""
    if bp.B != 1:
        raise NotImplementedError(
            "buckets of B > 1 blocks not yet ported to lorads_torch")
    glob_ident = (bp.m_loc == m_glob
                  and bool(np.array_equal(bp.glob_idx[0],
                                          np.arange(m_glob))))
    if not glob_ident:
        raise NotImplementedError(
            "buckets whose constraint slots are not the global ones not "
            "yet ported to lorads_torch")
    if bp.dense:
        return build_dense_bucket_data(bp, m_glob, dtype, device)
    n = bp.n
    pr = bp.pat_rows[0].astype(np.int64)
    pc = bp.pat_cols[0].astype(np.int64)
    cp = bp.c_pat[0]
    is_d = pr == pc
    off_idx = np.nonzero(~is_d)[0]
    off_of = np.zeros(pr.size, np.int64)
    off_of[off_idx] = np.arange(off_idx.size)
    c_diag = np.zeros((1, n))
    np.add.at(c_diag[0], pr[is_d], cp[is_d])
    orow, ocol, oval = pr[off_idx], pc[off_idx], cp[off_idx]

    ap = bp.a_pos[0].astype(np.int64)
    ac = bp.a_con_loc[0].astype(np.int64)
    av = bp.a_val[0]
    ed = is_d[ap]
    con_d, row_d, val_d = ac[ed], pr[ap[ed]], av[ed]
    # diagonal entries ordered by constraint slot
    od = np.argsort(con_d, kind="stable")
    con_d, row_d, val_d = con_d[od], row_d[od], val_d[od]
    eo = ~ed
    con_o, pos_o, val_o = ac[eo], off_of[ap[eo]], av[eo]
    p = bp.plans[0]
    # "identity" demands pure diagonal-entry constraints (pattern.py:620)
    ident = (p.dim == n and p.m_loc == n and con_d.size == n
             and con_o.size == 0
             and bool(np.all(con_d == np.arange(n)))
             and bool(np.all(row_d == np.arange(n))))

    Ko = max(orow.size, 1)
    nnz_d = max(con_d.size, 1)
    nnz_o = max(con_o.size, 1)
    off_rows, off_cols = _pad(orow, Ko), _pad(ocol, Ko)
    c_off = _pad(oval.astype(np.float64), Ko)
    a_con_d, a_row_d = _pad(con_d, nnz_d), _pad(row_d, nnz_d)
    a_val_d = _pad(val_d.astype(np.float64), nnz_d)
    a_con_o, a_pos_o = _pad(con_o, nnz_o), _pad(pos_o, nnz_o)
    a_val_o = _pad(val_o.astype(np.float64), nnz_o)
    po = np.argsort(a_pos_o[0], kind="stable")
    rd = np.argsort(a_row_d[0], kind="stable")

    # A^*(A(.)) is slot-diagonal on the off pattern when every off entry
    # owns a distinct slot and a distinct constraint, disjoint from the
    # diagonal constraints (pattern.py:671-683)
    off_unique = (np.unique(pos_o).size == pos_o.size
                  and np.unique(con_o).size == con_o.size
                  and not np.intersect1d(con_o, con_d).size)
    a2_off = np.zeros((1, Ko))
    np.add.at(a2_off[0], pos_o, 2.0 * val_o ** 2)

    meta = dict(n=n, B=1, K=bp.K, m_loc=bp.m_loc, m_glob=m_glob, Ko=Ko,
                nnz_d=nnz_d, nnz_o=nnz_o, has_off=bool(orow.size),
                has_diag_a=bool(con_d.size), has_off_a=bool(con_o.size),
                a_off_unique=bool(off_unique and con_o.size),
                glob_ident=glob_ident, diag_ident=bool(ident))
    arrays = dict(
        glob_idx=bp.glob_idx, c_diag=c_diag, off_rows=off_rows,
        off_cols=off_cols, c_off=c_off, c_off2=2.0 * c_off,
        a_con_d=a_con_d, a_row_d=a_row_d, a_val_d=a_val_d,
        bnd_a_con_d=_bounds_np(a_con_d, bp.m_loc),
        a_row_d_s=a_row_d[:, rd], a_con_d_s=a_con_d[:, rd],
        a_val_d_s=a_val_d[:, rd],
        bnd_a_row_d_s=_bounds_np(a_row_d[:, rd], n),
        a_con_o=a_con_o, a_pos_o=a_pos_o, a_val_o=a_val_o,
        a_pos_o_s=a_pos_o[:, po], a_con_o_s=a_con_o[:, po],
        a_val_o_s=a_val_o[:, po],
        bnd_a_pos_o_s=_bounds_np(a_pos_o[:, po], Ko), a2_off=a2_off)
    port = port_fields(n, bp.m_loc, off_rows, off_cols, c_off, a_con_o,
                       a_pos_o, a_val_o)
    meta["Ks"] = port.pop("Ks")
    arrays.update(port)
    return bucket_from_arrays(meta, arrays, dtype, device)


def cast_floats(bk, dtype):
    """The bucket with every float tensor cast to ``dtype`` (the f32 view
    the Lanczos certificate and the mixed-precision CG sweep on)."""
    fields = (k.name for k in dataclasses.fields(bk))
    return dataclasses.replace(bk, **{
        k: getattr(bk, k).to(dtype) for k in fields
        if isinstance(getattr(bk, k), torch.Tensor)
        and getattr(bk, k).is_floating_point()})


def scale_bucket(bk, s: float):
    """The bucket with its objective data scaled by s (reopt;
    lorads_tpu/alg/aop.py:68-79)."""
    if bk.dense:
        return dataclasses.replace(bk, c_full=bk.c_full * s)
    return dataclasses.replace(
        bk, c_diag=bk.c_diag * s, c_off=bk.c_off * s, c_off2=bk.c_off2 * s,
        c_sym_rs=bk.c_sym_rs * s)


def cone_total(bk: BucketData, vals: torch.Tensor) -> torch.Tensor:
    """Per-cone constraint values: the identity (the port has no
    sharded buckets)."""
    return vals


# ---------------------------------------------------------------------------
# Kernels.  Factors are [B, n, r].
# ---------------------------------------------------------------------------

def _sym_product(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """sym(UV^T) = (UV^T + VU^T) / 2 as full [B, n, n] matrices: one
    torch.matmul (TF32 is off, device.py), as lorads_tpu leaves the
    dense product to XLA at full precision (pattern.py:1078-1084)."""
    P = torch.matmul(U, V.transpose(1, 2))
    return 0.5 * (P + P.transpose(1, 2))


def uvt(bk, U: torch.Tensor, V: torch.Tensor):
    """sym(UV^T): full [B, n, n] on dense buckets, else on the split
    pattern (diag [B, n], off [B, Ko]) -- kernel K3
    (pattern.py:1085-1092)."""
    if bk.dense:
        return _sym_product(U, V)
    return kernels.uvt_split(U.contiguous(), V.contiguous(), bk.off_rows,
                             bk.off_cols)


def uvt_pair(bk, R: torch.Tensor, D: torch.Tensor):
    """(sym(RD^T), sym(DD^T)) for the ALM line search: two dense
    products on dense buckets (pattern.py:1108-1109), else the pattern
    values in one pass -- kernel K3p (pattern.py:1110-1119)."""
    if bk.dense:
        return _sym_product(R, D), _sym_product(D, D)
    rd_d, rd_o, dd_d, dd_o = kernels.uvt_pair_split(
        R.contiguous(), D.contiguous(), bk.off_rows, bk.off_cols)
    return (rd_d, rd_o), (dd_d, dd_o)


def constr_vals(bk, uvt_val) -> torch.Tensor:
    """A(sym(UV^T)) -> [B, m_loc] (pattern.py:1146-1173): on dense
    buckets kernel K4 over the flat [B, n^2] view at the
    constraint-sorted entries (layout (i)); elementwise for
    diag-identity buckets; else K4 over the diagonal entries and over
    the off entries (whose <A, X> weight is 2 a)."""
    if bk.dense:
        B = uvt_val.shape[0]
        return kernels.gather_segsum(
            uvt_val.reshape(B, bk.n * bk.n).contiguous(), bk.a_lin_cs,
            bk.a_val_inner_cs, bk.bnd_a_con_cs)
    d, o = uvt_val
    if bk.diag_ident:
        return bk.a_val_d * d            # constraint i == diag entry i
    vals = None
    if bk.has_diag_a:
        vals = kernels.gather_segsum(d, bk.a_row_d, bk.a_val_d,
                                     bk.bnd_a_con_d)
    if bk.has_off_a:
        vals = kernels.gather_segsum(o, bk.a_pos_o_cs, bk.a_val_o_cs,
                                     bk.bnd_a_con_o_cs, base=vals,
                                     alpha=2.0)
    if vals is None:
        vals = torch.zeros((d.shape[0], bk.m_loc), dtype=d.dtype,
                           device=d.device)
    return vals


def obj_inner(bk, uvt_val) -> torch.Tensor:
    """<C, sym(UV^T)> per block -> [B]."""
    if bk.dense:
        return torch.sum(bk.c_full * uvt_val, dim=(1, 2))
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


def build_w(bk, w_loc: torch.Tensor, include_obj: bool = True):
    """W = [C +] sum_i w_i A_i.  Dense buckets: full [B, n, n], kernel
    K4 with one segment per flat slot over the slot-sorted entries and
    their mirrors (layout (ii)), C riding in as K4's base
    (pattern.py:1250-1274).  Split buckets: (W_d [B, n], W_o [B, Ko])
    (pattern.py:1275-1304); general ones sum each diagonal row and
    each off slot over its constraint entries with K4, the objective
    as K4's base.  (lorads_tpu also returns a column-order mirror of
    W_o; the port has none.)"""
    if bk.dense:
        B, n = w_loc.shape[0], bk.n
        base = bk.c_full.reshape(B, n * n) if include_obj else None
        return kernels.gather_segsum(w_loc, bk.a_con2_s, bk.a_val2_s,
                                     bk.bnd_a_lin2,
                                     base=base).reshape(B, n, n)
    z = lambda L: torch.zeros((w_loc.shape[0], L),  # noqa: E731
                              dtype=w_loc.dtype, device=w_loc.device)
    if bk.diag_ident:
        W_d = bk.a_val_d * w_loc         # row i == constraint i
        if include_obj:
            return bk.c_diag + W_d, bk.c_off + z(bk.Ko)
        return W_d, z(bk.Ko)
    if bk.has_diag_a:
        W_d = kernels.gather_segsum(
            w_loc, bk.a_con_d_s, bk.a_val_d_s, bk.bnd_a_row_d_s,
            base=bk.c_diag if include_obj else None)
    else:
        W_d = bk.c_diag + z(bk.n) if include_obj else z(bk.n)
    if bk.has_off_a:
        W_o = kernels.gather_segsum(
            w_loc, bk.a_con_o_s, bk.a_val_o_s, bk.bnd_a_pos_o_s,
            base=bk.c_off if include_obj else None)
    else:
        W_o = bk.c_off + z(bk.Ko) if include_obj else z(bk.Ko)
    return W_d, W_o


def w_mul(bk, W, X: torch.Tensor) -> torch.Tensor:
    """W @ X [B, n, r] for a build_w output: torch.matmul on dense
    buckets (pattern.py:1326-1329), else kernel K5
    (pattern.py:1330-1347): one pass over the full-symmetric row-sorted
    entry list, each entry reading its W_o slot."""
    if bk.dense:
        return torch.matmul(W, X)
    W_d, W_o = W
    return kernels.wmul_csr(X.contiguous(), W_d.contiguous(),
                            W_o.contiguous(), bk.sym_slot_rs,
                            bk.sym_cols_rs, bk.bnd_sym_rows)


def densify_w(bk, W) -> torch.Tensor:
    """A split build_w output as full symmetric [B, n, n] matrices
    (certificate-time only, for the exact-eigh branch); dense buckets'
    W is already full."""
    if bk.dense:
        raise ValueError("densify_w is for sparse-mode buckets")
    W_d, W_o = W
    out = torch.diag_embed(W_d)
    if bk.has_off:
        rows, cols = bk.off_rows.long(), bk.off_cols.long()
        for b in range(out.shape[0]):
            # pad slots carry zero values, so their additions are no-ops
            out[b].index_put_((rows[b], cols[b]), W_o[b], accumulate=True)
            out[b].index_put_((cols[b], rows[b]), W_o[b], accumulate=True)
    return out


def a_adj_a(bk: BucketData, X: torch.Tensor, F: torch.Tensor):
    """W = A^*(A(sym(X F^T))) for buckets whose off constraint entries
    own distinct slots (bk.a_off_unique; pattern.py:1476-1506, which
    takes sym(X F^T) from uvt_half_cached): the off plane is the static
    scale a2_off of sym(X F^T)_o, one launch of kernel K6 from (X, F);
    diagonal constraints compose through constraint space with two K4
    launches.  Returns (W_d, W_o)."""
    d, W_o = kernels.adj_a_offdiag(X.contiguous(), F.contiguous(),
                                   bk.off_rows, bk.off_cols, bk.a2_off,
                                   want_diag=bk.has_diag_a)
    if not bk.has_diag_a:
        return torch.zeros((X.shape[0], bk.n), dtype=X.dtype,
                           device=X.device), W_o
    vals = kernels.gather_segsum(d, bk.a_row_d, bk.a_val_d, bk.bnd_a_con_d)
    W_d = kernels.gather_segsum(vals, bk.a_con_d_s, bk.a_val_d_s,
                                bk.bnd_a_row_d_s)
    return W_d, W_o


def a_adj_a_dense(bk: DenseBucketData, X_full: torch.Tensor):
    """W = A^*(A(X)) [B, n, n] for dense buckets whose constraints are
    each single-entry or diagonal-only (bk.a_single_dense;
    pattern.py:1458-1473), X_full = sym(x F^T): the single-entry part
    is the static plane a2_full .* X, the diagonal-only constraints
    (theta's trace) compose through constraint space with two K4 sums
    over layout (iii), and kernel K7a writes a2_full .* X + diag(W_d)
    in one pass."""
    W_d = None
    if bk.nnz_dd:
        d = torch.diagonal(X_full, dim1=1, dim2=2).contiguous()
        vals = kernels.gather_segsum(d, bk.dd_row_cs, bk.dd_val_cs,
                                     bk.bnd_dd_con)
        W_d = kernels.gather_segsum(vals, bk.dd_con_rs, bk.dd_val_rs,
                                    bk.bnd_dd_row)
    return kernels.adj_a_dense(X_full.contiguous(), bk.a2_full, W_d)


def cmul(bk: BucketData, X: torch.Tensor,
         include_diag: bool = True) -> torch.Tensor:
    """C @ X [B, n, r] over the full-symmetric row-sorted entry list --
    kernel K2 (pattern.py:1509-1550).  The fused kernel never writes the
    [Ks, r] product, so the TPU version's entry chunking is gone."""
    return kernels.cmul_csr(X.contiguous(),
                            bk.c_diag if include_diag else None,
                            bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)


# ---------------------------------------------------------------------------
# The cached forms.  lorads_tpu keeps gathered pattern rows of the ALM
# and ADMM factors (X[off_rows], X[off_cols], a column-order mirror) and
# advances them by tau * D, because its scatters at unsorted ids are
# slow.  The port's fused SDDMM kernels read the rows from L2, so there
# is no cache: the names stay and every form computes from the factors.
# ---------------------------------------------------------------------------

def gather_cache(bk: BucketData, X: torch.Tensor):
    """No gathered-row cache (see above)."""
    return None


def uvt_from_cache(bk: BucketData, R: torch.Tensor, cache):
    """sym(RR^T) pattern values (pattern.py:1417-1422)."""
    return uvt(bk, R, R)


def uvt_pair_cached(bk: BucketData, R: torch.Tensor, D: torch.Tensor,
                    cache):
    """uvt_pair and D's (absent) cache (pattern.py:1425-1440)."""
    return uvt_pair(bk, R, D), None


def uvt_half_cached(bk: BucketData, X: torch.Tensor, F: torch.Tensor,
                    fcache):
    """sym(X F^T) pattern values (pattern.py:1443-1455)."""
    return uvt(bk, X, F)


def w_mul_cached(bk: BucketData, W, X: torch.Tensor, cache):
    """w_mul (pattern.py:1553-1573)."""
    return w_mul(bk, W, X)
