"""Host-side canonical problem containers (NumPy only — no JAX here).

The reference keeps conic data behind pointer vtables
(src_semi/data/def_lorads_sdp_conic.h:53-97 and
def_lorads_sdp_data.h:30-56).  The TPU rebuild replaces that with plain
arrays + static metadata: each SDP block stores its objective C and its
constraint matrices A_i as flat lower-triangular COO triplets; all
layout decisions (dense vs. pattern-sparse kernels) are made once at
presolve time and baked into compiled functions.

Conventions
-----------
* All matrices are symmetric, represented by their lower triangle
  (row >= col).
* The problem is  min <C,X>  s.t.  <A_i, X> = b_i,  X PSD,
  plus optionally an LP block:  sum_j c_j x_j  with  a_ij x_j  terms,
  x >= 0 elementwise (diagonal rank-1 factorization x = u.*v in ADMM,
  reference lorads_lp_conic.c:172-217).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SDPBlockData:
    """One PSD block: objective + m constraint slices in lower-tri COO."""

    dim: int
    m: int
    # objective C (already negated from the SDPA F0 on read)
    obj_row: np.ndarray  # int32 [nnzC], row >= col
    obj_col: np.ndarray
    obj_val: np.ndarray  # float64
    # constraints, flattened over all i: A[a_con[k]][a_row[k],a_col[k]] = a_val[k]
    a_con: np.ndarray    # int32 [nnzA], values in [0, m)
    a_row: np.ndarray
    a_col: np.ndarray
    a_val: np.ndarray

    # ---- convenience ----
    @property
    def nnz_obj(self) -> int:
        return int(self.obj_val.size)

    @property
    def nnz_constr(self) -> int:
        return int(self.a_val.size)

    def constr_nnz_rows(self) -> np.ndarray:
        """Indices of constraints with at least one nonzero in this block.

        Reference: csp_nnz_cols count + rowIdx map
        (lorads_sdp_conic.c:191-223).
        """
        return np.unique(self.a_con)

    def dense_obj(self) -> np.ndarray:
        """Materialize C as a dense symmetric matrix (test oracle)."""
        C = np.zeros((self.dim, self.dim))
        C[self.obj_row, self.obj_col] = self.obj_val
        C = C + C.T - np.diag(np.diag(C))
        return C

    def dense_constr(self, i: int) -> np.ndarray:
        """Materialize A_i as a dense symmetric matrix (test oracle)."""
        A = np.zeros((self.dim, self.dim))
        sel = self.a_con == i
        np.add.at(A, (self.a_row[sel], self.a_col[sel]), self.a_val[sel])
        A = A + A.T - np.diag(np.diag(A))
        return A

    # Norms of the objective count symmetric (off-diag doubled) entries,
    # matching dataMatSparse/Dense nrm1 / nrm2Square / nrmInf
    # (src_semi/data/lorads_sdp_data.c:148-272).
    def obj_nrm1(self) -> float:
        w = np.where(self.obj_row == self.obj_col, 1.0, 2.0)
        return float(np.sum(w * np.abs(self.obj_val)))

    def obj_nrm2_square(self) -> float:
        w = np.where(self.obj_row == self.obj_col, 1.0, 2.0)
        return float(np.sum(w * self.obj_val**2))

    def obj_nrm_inf(self) -> float:
        if self.obj_val.size == 0:
            return 0.0
        return float(np.max(np.abs(self.obj_val)))


@dataclasses.dataclass
class LPBlockData:
    """The (single, optional) LP block: columns of A plus objective c."""

    n_cols: int
    m: int
    obj: np.ndarray      # float64 [n_cols], negated F0 diagonal
    a_con: np.ndarray    # int32 [nnz]
    a_col: np.ndarray    # int32 [nnz]
    a_val: np.ndarray    # float64 [nnz]

    def col_nrm2_square(self) -> np.ndarray:
        """Cached ||a_col||^2 per column for the closed-form ADMM update.

        Reference: lorads_lp_conic.c:106-107.
        """
        out = np.zeros(self.n_cols)
        np.add.at(out, self.a_col, self.a_val**2)
        return out

    def dense_matrix(self) -> np.ndarray:
        """[m, n_cols] dense A_lp (test oracle)."""
        A = np.zeros((self.m, self.n_cols))
        np.add.at(A, (self.a_con, self.a_col), self.a_val)
        return A

    def obj_nrm1(self) -> float:
        return float(np.sum(np.abs(self.obj)))

    def obj_nrm_inf(self) -> float:
        return float(np.max(np.abs(self.obj))) if self.obj.size else 0.0


@dataclasses.dataclass
class SDPProblem:
    """A full standard-form SDP instance (host side)."""

    m: int
    rhs: np.ndarray                   # float64 [m]
    blocks: List[SDPBlockData]
    lp: Optional[LPBlockData] = None

    @property
    def n_sdp_blocks(self) -> int:
        return len(self.blocks)

    @property
    def n_lp_cols(self) -> int:
        return self.lp.n_cols if self.lp is not None else 0

    @property
    def sum_block_dims(self) -> int:
        return sum(b.dim for b in self.blocks)

    # --- norms used for DIMACS scaling; cal_sdp_const
    #     (src_semi/data/lorads_solver.c:1054-1073) ---
    def obj_nrm1(self) -> float:
        t = sum(b.obj_nrm1() for b in self.blocks)
        if self.lp is not None:
            t += self.lp.obj_nrm1()
        return t

    def obj_nrm2(self) -> float:
        t = sum(b.obj_nrm2_square() for b in self.blocks)
        if self.lp is not None:
            # reference uses nrm1^2 here (a quirk of lp_cone_obj_nrm2Square,
            # lorads_lp_conic.c:128-133); reproduced for parity.
            t += self.lp.obj_nrm1() ** 2
        return float(np.sqrt(t))

    def obj_nrm_inf(self) -> float:
        t = max((b.obj_nrm_inf() for b in self.blocks), default=0.0)
        if self.lp is not None:
            t = max(t, self.lp.obj_nrm_inf())
        return t

    def rhs_nrm1(self) -> float:
        return float(np.sum(np.abs(self.rhs)))

    def rhs_nrm2(self) -> float:
        return float(np.linalg.norm(self.rhs))

    def rhs_nrm_inf(self) -> float:
        return float(np.max(np.abs(self.rhs))) if self.m else 0.0


def merge_problems(problems: List["SDPProblem"]) -> "SDPProblem":
    """Merge independent instances into one block-diagonal problem.

    Constraint slots are offset per instance, so the instances stay
    fully decoupled; same-shape blocks across instances land in the
    same presolve bucket and the whole batch is solved as ONE
    vectorized [B, n, r] program — batched instance solving is a
    TPU capability with no reference counterpart (the reference
    solves one instance per process).  Use ``split_objectives`` (or
    ``LoradsSolver.x_blocks``) to read per-instance results back.
    """
    m = sum(p.m for p in problems)
    m_off = 0
    blocks: List[SDPBlockData] = []
    lp_parts = []
    rhs = []
    for p in problems:
        for b in p.blocks:
            blocks.append(SDPBlockData(
                dim=b.dim, m=m,
                obj_row=b.obj_row, obj_col=b.obj_col, obj_val=b.obj_val,
                a_con=b.a_con + m_off, a_row=b.a_row, a_col=b.a_col,
                a_val=b.a_val))
        if p.lp is not None:
            lp_parts.append((m_off, p.lp))
        rhs.append(p.rhs)
        m_off += p.m
    lp = None
    if lp_parts:
        col_off = 0
        obj, a_con, a_col, a_val = [], [], [], []
        for off, part in lp_parts:
            obj.append(part.obj)
            a_con.append(part.a_con + off)
            a_col.append(part.a_col + col_off)
            a_val.append(part.a_val)
            col_off += part.n_cols
        lp = LPBlockData(
            n_cols=col_off, m=m,
            obj=np.concatenate(obj),
            a_con=np.concatenate(a_con).astype(np.int32),
            a_col=np.concatenate(a_col).astype(np.int32),
            a_val=np.concatenate(a_val))
    return SDPProblem(m=m, rhs=np.concatenate(rhs), blocks=blocks,
                      lp=lp)


def split_objectives(problems: List["SDPProblem"], x_blocks,
                     lp_vals=None) -> List[float]:
    """Per-instance objectives of a merged-batch solution.

    ``x_blocks``: dense primal blocks of the MERGED problem in merged
    block order (LoradsSolver.x_blocks output); ``lp_vals``: merged LP
    column values (or None)."""
    if lp_vals is None and any(p.lp is not None for p in problems):
        raise ValueError("an instance has an LP block: pass the merged "
                         "lp_vals (LoradsSolver.x_blocks()[1])")
    out = []
    bi = 0
    ci = 0
    for p in problems:
        obj = 0.0
        for b in p.blocks:
            obj += float(np.sum(b.dense_obj() * x_blocks[bi]))
            bi += 1
        if p.lp is not None:
            obj += float(np.dot(p.lp.obj,
                                lp_vals[ci:ci + p.lp.n_cols]))
            ci += p.lp.n_cols
        out.append(obj)
    return out


def _block_objective_from_factor(blk: SDPBlockData, F) -> float:
    """<C, F F^T> from sparse C entries (lower-tri, implicit symmetry)
    without forming X: O(nnz * r)."""
    F = np.asarray(F, dtype=np.float64)
    if blk.obj_val.size == 0:
        return 0.0
    dots = np.sum(F[blk.obj_row] * F[blk.obj_col], axis=1)
    w = np.where(blk.obj_row == blk.obj_col, 1.0, 2.0)
    return float(np.dot(blk.obj_val * w, dots))


def split_objectives_factors(problems: List["SDPProblem"], factors,
                             lp_vals=None) -> List[float]:
    """Per-instance objectives from FACTORS (X_i = F_i F_i^T) of a
    merged-batch solution — the O(nnz * r) form of
    :func:`split_objectives` (a dense X at the scales the batching
    feature targets would be tens of GB).  ``factors``:
    LoradsSolver.factor_blocks output, merged block order."""
    if lp_vals is None and any(p.lp is not None for p in problems):
        raise ValueError("an instance has an LP block: pass the merged "
                         "lp_vals (LoradsSolver.factor_blocks()[1])")
    out = []
    bi = 0
    ci = 0
    for p in problems:
        obj = 0.0
        for b in p.blocks:
            obj += _block_objective_from_factor(b, factors[bi])
            bi += 1
        if p.lp is not None:
            obj += float(np.dot(p.lp.obj,
                                lp_vals[ci:ci + p.lp.n_cols]))
            ci += p.lp.n_cols
        out.append(obj)
    return out
