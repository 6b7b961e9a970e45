"""The LP (nonnegative-orthant) block.

Port of lorads_tpu/ops/lp.py.  The LP block is a diagonal PSD block
factored rank-1 per column, x_j = u_j * v_j (reference
lorads_lp_conic.c:172-217).  Its two sums are kernel K4 over the LP's own
sorted entry lists:

* ``constr_vals``: A_lp(uv) -> [m], the entries sorted by constraint
  (``a_col_cs``, ``a_val_cs``, CSR bounds ``bnd_con``);
* ``adjoint_cols``: base + alpha * a_j^T w for every column -> [n_cols],
  the entries sorted by column (``a_con_ls``, ``a_val_ls``, bounds
  ``bnd_col``); ``base`` and ``alpha`` give c + A^T w (the ALM gradient)
  and c - A^T lambda (the certificate) in the same launch.

The padded per-column layout ``pc_con`` / ``pc_val`` [n_cols,
max_nnz_col] (padding ids equal m, values 0) feeds the Gauss-Seidel
column sweep (kernel K8c, ``kernels.lp_gs_sweep``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lorads_torch.core.problem import LPBlockData
from lorads_torch.ops import kernels


@dataclasses.dataclass(frozen=True)
class LPData:
    """Device tensors of the LP block (lorads_tpu's LPData layout)."""

    n_cols: int
    m_glob: int
    nnz: int
    max_nnz_col: int
    obj: torch.Tensor         # [n_cols]
    a_con: torch.Tensor       # int32 [nnz]
    a_col: torch.Tensor       # int32 [nnz]
    a_val: torch.Tensor       # [nnz]
    col_nrm2sq: torch.Tensor  # [n_cols] ||a_j||^2 (lorads_lp_conic.c:106-107)
    a_val_cs: torch.Tensor    # [nnz] by constraint
    a_col_cs: torch.Tensor    # int32 [nnz]
    bnd_con: torch.Tensor     # int32 [m+1]
    a_val_ls: torch.Tensor    # [nnz] by column
    a_con_ls: torch.Tensor    # int32 [nnz]
    bnd_col: torch.Tensor     # int32 [n_cols+1]
    pc_con: torch.Tensor      # int32 [n_cols, max_nnz_col], padding m
    pc_val: torch.Tensor      # [n_cols, max_nnz_col], padding 0


# the integer and float arrays of an LPData
LP_INT_FIELDS = ("a_con", "a_col", "a_col_cs", "bnd_con", "a_con_ls",
                 "bnd_col", "pc_con")
LP_FLOAT_FIELDS = ("obj", "a_val", "col_nrm2sq", "a_val_cs", "a_val_ls",
                   "pc_val")


def lp_arrays(lp: LPBlockData) -> dict:
    """The LP block's host arrays in lorads_tpu's layout
    (lorads_tpu/ops/lp.py:56-96)."""
    con = np.asarray(lp.a_con)
    col = np.asarray(lp.a_col)
    val = np.asarray(lp.a_val, np.float64)
    cp = np.argsort(con, kind="stable")
    ls = np.argsort(col, kind="stable")
    counts = np.bincount(col, minlength=lp.n_cols)
    max_nnz_col = max(int(counts.max()) if counts.size else 0, 1)
    pc_con = np.full((lp.n_cols, max_nnz_col), lp.m, np.int32)
    pc_val = np.zeros((lp.n_cols, max_nnz_col))
    # column j's entries in their input order
    pos = np.arange(ls.size) - np.searchsorted(col[ls], col[ls])
    pc_con[col[ls], pos] = con[ls]
    pc_val[col[ls], pos] = val[ls]
    return dict(
        n_cols=lp.n_cols, m_glob=lp.m, nnz=int(val.size),
        max_nnz_col=max_nnz_col, obj=np.asarray(lp.obj, np.float64),
        a_con=con, a_col=col, a_val=val, col_nrm2sq=lp.col_nrm2_square(),
        a_val_cs=val[cp], a_col_cs=col[cp],
        bnd_con=np.searchsorted(con[cp], np.arange(lp.m + 1)),
        a_val_ls=val[ls], a_con_ls=con[ls],
        bnd_col=np.searchsorted(col[ls], np.arange(lp.n_cols + 1)),
        pc_con=pc_con, pc_val=pc_val)


def lp_from_arrays(arrays: dict, dtype, device) -> LPData:
    """LPData from host arrays (lp_arrays' keys)."""
    t = {k: torch.as_tensor(np.array(arrays[k], dtype=np.int32),
                            device=device) for k in LP_INT_FIELDS}
    t.update({k: torch.as_tensor(np.array(arrays[k], dtype=np.float64),
                                 device=device).to(dtype).contiguous()
              for k in LP_FLOAT_FIELDS})
    meta = {k: int(arrays[k]) for k in ("n_cols", "m_glob", "nnz",
                                        "max_nnz_col")}
    return LPData(**meta, **t)


def build_lp_data(lp: LPBlockData, dtype, device) -> LPData:
    return lp_from_arrays(lp_arrays(lp), dtype, device)


def scale_lp(lpd: LPData, s: float) -> LPData:
    """The LP block with its objective scaled by s (reopt)."""
    return dataclasses.replace(lpd, obj=lpd.obj * s)


def constr_vals(lpd: LPData, uv: torch.Tensor) -> torch.Tensor:
    """A_lp(diag(uv)) -> global [m] (lp_cone_AUV): kernel K4 over the
    constraint-sorted entries."""
    return kernels.gather_segsum(uv[None], lpd.a_col_cs[None],
                                 lpd.a_val_cs[None], lpd.bnd_con[None])[0]


def obj_inner(lpd: LPData, uv: torch.Tensor) -> torch.Tensor:
    """<c, uv> (lp_cone_objAUV, lorads_lp_conic.c:193-202)."""
    return torch.dot(lpd.obj, uv)


def adjoint_cols(lpd: LPData, w: torch.Tensor, base=None,
                 alpha: float = 1.0) -> torch.Tensor:
    """base + alpha * a_j^T w for every column j -> [n_cols]
    (lp_cone_Wsum per column, lorads_lp_conic.c:211-213): kernel K4 over
    the column-sorted entries."""
    return kernels.gather_segsum(
        w[None], lpd.a_con_ls[None], lpd.a_val_ls[None], lpd.bnd_col[None],
        base=None if base is None else base[None], alpha=alpha)[0]
