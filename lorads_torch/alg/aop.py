"""Whole-problem operators over the buckets and the LP block.

Port of lorads_tpu/alg/aop.py (132-419).  On
diag-identity buckets (``_diag_fast``, Max-Cut) A(.) and A^*(.) are
elementwise, the per-factor cache is CR = C @ R (``CRCache``), and the
only sparse work per ALM step is one C @ D product (kernel K2).  Every
other bucket has no cache (``None``; see pattern.gather_cache): the
pattern values come from the factors through the SDDMM kernels (K3,
K3p) and W @ R from build_w + w_mul (K4, K5).

* ``auv``:   A(sym(U V^T)) -> per-bucket locals + global m-vector
* ``grad``:  2 (C + A^*(w)) R for an m-vector w (ALMSetGrad,
             lorads_alm.c:9-38); LP columns 2 (c_j + a_j^T w) r_j

The LP block (ops/lp.py) adds its objective <c, uv> and its constraint
values A_lp(uv) (kernel K4) to every product, and its columns'
gradient to ``grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from lorads_torch.alg.state import FactorVec, fv_norm2sq
from lorads_torch.core.presolve import Presolved
from lorads_torch.ops import kernels
from lorads_torch.ops import lp as lp_ops
from lorads_torch.ops import pattern as pat


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Device-resident instance data."""

    m: int
    buckets: Tuple[pat.BucketData, ...]
    rhs: torch.Tensor                # [m]
    lp: Optional[lp_ops.LPData] = None
    # scalar norm constants (cal_sdp_const, lorads_solver.c:1054-1073)
    c_nrm1: float = 0.0
    c_nrm2: float = 0.0
    c_nrm_inf: float = 0.0
    b_nrm1: float = 0.0
    b_nrm2: float = 0.0
    b_nrm_inf: float = 0.0

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def build_problem_data(ps: Presolved, dtype, device,
                       buckets=None) -> ProblemData:
    """The presolve's problem data on ``device``; ``buckets`` (a sharded
    solve's placed buckets) in place of the buckets built from the
    plans."""
    if buckets is None:
        buckets = tuple(pat.build_bucket_data(bp, ps.m, dtype, device)
                        for bp in ps.buckets)
    lpd = (lp_ops.build_lp_data(ps.problem.lp, dtype, device)
           if ps.problem.lp is not None else None)
    return ProblemData(
        m=ps.m, buckets=buckets, lp=lpd,
        rhs=torch.as_tensor(ps.problem.rhs, dtype=dtype, device=device),
        c_nrm1=ps.c_nrm1, c_nrm2=ps.c_nrm2, c_nrm_inf=ps.c_nrm_inf,
        b_nrm1=ps.b_nrm1, b_nrm2=ps.b_nrm2, b_nrm_inf=ps.b_nrm_inf)


def scale_objective(pd: ProblemData, s: float) -> ProblemData:
    """Scale C by s in every block (reopt objScale_dualvar,
    lorads_solver.c:1040-1052); norm constants keep their init values."""
    return dataclasses.replace(
        pd, buckets=tuple(pat.scale_bucket(bk, s) for bk in pd.buckets),
        lp=None if pd.lp is None else lp_ops.scale_lp(pd.lp, s))


def _diag_fast(bk) -> bool:
    """Static gate of the diag-identity fast path (aop.py:213-223): a
    diag-identity bucket, or the summed shards of a diag-identity parent
    cone (``diag_parent``: each shard's own diag_ident is False, but
    A(.) and A^*(.) stay elementwise with the full diagonal map, and
    C @ R sums over the shards inside cmul)."""
    return bk.split and ((bk.diag_ident and not bk.summed)
                         or bk.diag_parent)


def _adiag(bk):
    """The diagonal constraint coefficients by row: [B, n], or a
    diag-parent's full map [1, n] (aop.py:226-230)."""
    return bk.a_val_d_full[:1] if bk.diag_parent else bk.a_val_d


def _scatter_diag(bk, vals):
    """Diag-fast constraint values [B or 1, m_loc] into the m-vector
    (aop.py:233-241): a diag-parent's values come whole from the
    factors, the same on every shard and rank, so they scatter once
    (shard 0's slots, kernel K4) with no sum over shards."""
    if bk.diag_parent:
        return kernels.gather_segsum(vals.reshape(1, -1), bk.diag_scat_idx,
                                     bk.diag_scat_val, bk.bnd_diag_scat)[0]
    return pat.scatter_constr(bk, vals)


def _wloc_diag(bk, w_loc):
    """A diag-parent's gathered w_loc is the same on every shard: its
    first row (aop.py:244-246)."""
    return w_loc[:1] if bk.diag_parent else w_loc


@dataclasses.dataclass(frozen=True)
class CRCache:
    """Diag-fast cache of a factor R: CR = C @ R."""

    cr: torch.Tensor


def _zero(pd: ProblemData) -> torch.Tensor:
    return torch.zeros((), dtype=pd.rhs.dtype, device=pd.rhs.device)


def auv(pd: ProblemData, X: FactorVec, Y: FactorVec):
    """A(sym(X Y^T)): (per-bucket locals [B, m_loc], global total [m])
    (LORADSInitConstrValAll + InitConstrValSum)."""
    locals_ = []
    total = torch.zeros_like(pd.rhs)
    for bk, U, V in zip(pd.buckets, X.cones, Y.cones):
        vals = pat.constr_vals(bk, pat.uvt(bk, U, V))
        locals_.append(vals)
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        total = total + lp_ops.constr_vals(pd.lp, X.lp * Y.lp)
    return tuple(locals_), total


def obj_and_auv(pd: ProblemData, X: FactorVec, Y: FactorVec):
    """(<C, sym(XY^T)>, locals, total) in one pass sharing UV^T
    (LORADSObjConstrValAll)."""
    locals_ = []
    total = torch.zeros_like(pd.rhs)
    obj = _zero(pd)
    for bk, U, V in zip(pd.buckets, X.cones, Y.cones):
        uvt_val = pat.uvt(bk, U, V)
        obj = obj + pat.shard_sum(bk, pat.obj_inner(bk, uvt_val), "obj")
        vals = pat.constr_vals(bk, uvt_val)
        locals_.append(vals)
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        xy = X.lp * Y.lp
        obj = obj + lp_ops.obj_inner(pd.lp, xy)
        total = total + lp_ops.constr_vals(pd.lp, xy)
    return obj, tuple(locals_), total


def obj_only(pd: ProblemData, X: FactorVec, Y: FactorVec) -> torch.Tensor:
    """<C, sym(XY^T)> (LORADSCalObjRR_ALM, lorads_alm.c:1259)."""
    obj = _zero(pd)
    for bk, U, V in zip(pd.buckets, X.cones, Y.cones):
        obj = obj + pat.shard_sum(bk, pat.obj_inner(bk, pat.uvt(bk, U, V)),
                                  "obj")
    if pd.lp is not None:
        obj = obj + lp_ops.obj_inner(pd.lp, X.lp * Y.lp)
    return obj


def gather_caches(pd: ProblemData, R: FactorVec):
    """Per-bucket caches of R: CR = C @ R for diag-identity buckets,
    None otherwise (pattern.gather_cache)."""
    return tuple(CRCache(pat.cmul(bk, Rb)) if _diag_fast(bk)
                 else pat.gather_cache(bk, Rb)
                 for bk, Rb in zip(pd.buckets, R.cones))


def axpy_caches(caches, t, dcaches):
    """caches + t * dcaches (C @ . is linear); None passes through."""
    return tuple(c if c is None else CRCache(c.cr + t * d.cr)
                 for c, d in zip(caches, dcaches))


def obj_and_auv_pair_cached(pd: ProblemData, R: FactorVec, D: FactorVec,
                            caches):
    """Objective and constraint values at sym(RD^T) and sym(DD^T) from
    R's caches -> (p1, t1, p2, t2, D's caches).  Diag-fast:
    <C, sym(RD^T)> = (<R, CD> + <D, CR>)/2, <C, DD^T> = <D, CD>;
    otherwise the pair SDDMM (kernel K3p) and A(.) (K4)."""
    p1, p2 = _zero(pd), _zero(pd)
    t1 = torch.zeros_like(pd.rhs)
    t2 = torch.zeros_like(pd.rhs)
    dcaches = []
    for bk, Rb, Db, cache in zip(pd.buckets, R.cones, D.cones, caches):
        if isinstance(cache, CRCache):
            cd = pat.cmul(bk, Db)
            dcaches.append(CRCache(cd))
            p1 = p1 + 0.5 * (pat.factor_sum(bk, Rb * cd, "obj")
                             + pat.factor_sum(bk, Db * cache.cr, "obj"))
            p2 = p2 + pat.factor_sum(bk, Db * cd, "obj")
            t1 = t1 + _scatter_diag(
                bk, _adiag(bk) * torch.sum(Rb * Db, -1))
            t2 = t2 + _scatter_diag(
                bk, _adiag(bk) * torch.sum(Db * Db, -1))
            continue
        (uv_rd, uv_dd), dc = pat.uvt_pair_cached(bk, Rb, Db, cache)
        dcaches.append(dc)
        p1 = p1 + pat.shard_sum(bk, pat.obj_inner(bk, uv_rd), "obj")
        p2 = p2 + pat.shard_sum(bk, pat.obj_inner(bk, uv_dd), "obj")
        t1 = t1 + pat.scatter_constr(bk, pat.constr_vals(bk, uv_rd))
        t2 = t2 + pat.scatter_constr(bk, pat.constr_vals(bk, uv_dd))
    if pd.lp is not None:
        rd = R.lp * D.lp
        dd = D.lp * D.lp
        p1 = p1 + lp_ops.obj_inner(pd.lp, rd)
        p2 = p2 + lp_ops.obj_inner(pd.lp, dd)
        t1 = t1 + lp_ops.constr_vals(pd.lp, rd)
        t2 = t2 + lp_ops.constr_vals(pd.lp, dd)
    return p1, t1, p2, t2, tuple(dcaches)


def auv_cached(pd: ProblemData, R: FactorVec, caches) -> torch.Tensor:
    """A(sym(RR^T)) global sum (diag-fast: no pattern work)."""
    total = torch.zeros_like(pd.rhs)
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        if isinstance(cache, CRCache):
            total = total + _scatter_diag(
                bk, _adiag(bk) * torch.sum(Rb * Rb, -1))
            continue
        vals = pat.constr_vals(bk, pat.uvt_from_cache(bk, Rb, cache))
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        total = total + lp_ops.constr_vals(pd.lp, R.lp * R.lp)
    return total


def obj_and_auv_cached(pd: ProblemData, R: FactorVec, caches):
    """obj_and_auv from R's caches (diag-fast: obj = <R, CR>)."""
    locals_ = []
    total = torch.zeros_like(pd.rhs)
    obj = _zero(pd)
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        if isinstance(cache, CRCache):
            obj = obj + pat.factor_sum(bk, Rb * cache.cr, "obj")
            vals = _adiag(bk) * torch.sum(Rb * Rb, -1)
            locals_.append(vals)
            total = total + _scatter_diag(bk, vals)
            continue
        uv = pat.uvt_from_cache(bk, Rb, cache)
        obj = obj + pat.shard_sum(bk, pat.obj_inner(bk, uv), "obj")
        vals = pat.constr_vals(bk, uv)
        locals_.append(vals)
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        xy = R.lp * R.lp
        obj = obj + lp_ops.obj_inner(pd.lp, xy)
        total = total + lp_ops.constr_vals(pd.lp, xy)
    return obj, tuple(locals_), total


def obj_cached(pd: ProblemData, R: FactorVec, caches) -> torch.Tensor:
    """<C, sym(RR^T)> from the caches (diag-fast: <R, CR>)."""
    obj = _zero(pd)
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        if isinstance(cache, CRCache):
            obj = obj + pat.factor_sum(bk, Rb * cache.cr, "obj")
        else:
            obj = obj + pat.shard_sum(bk, pat.obj_inner(
                bk, pat.uvt_from_cache(bk, Rb, cache)), "obj")
    if pd.lp is not None:
        obj = obj + lp_ops.obj_inner(pd.lp, R.lp * R.lp)
    return obj


def grad_cached(pd: ProblemData, R: FactorVec, w: torch.Tensor,
                caches) -> FactorVec:
    """2 (C + A^*(w)) R from R's caches: diag-fast 2 (CR + (a .* w) .* R)
    (A^*(w) is diagonal), otherwise 2 W @ R with W = build_w (K4) and
    the product w_mul (K5); LP columns 2 (c + A_lp^T w) .* r, the sum
    one K4 launch with c as its base."""
    cones = []
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        w_loc = pat.gather_w(bk, w)
        if isinstance(cache, CRCache):
            cones.append(2.0 * (cache.cr + (
                _adiag(bk) * _wloc_diag(bk, w_loc))[:, :, None] * Rb))
            continue
        W = pat.build_w(bk, w_loc)
        cones.append(2.0 * pat.w_mul_cached(bk, W, Rb, cache))
    if pd.lp is not None:
        lp_g = 2.0 * lp_ops.adjoint_cols(pd.lp, w, base=pd.lp.obj) * R.lp
    else:
        lp_g = torch.zeros_like(R.lp)
    return FactorVec(tuple(cones), lp_g)


def grad(pd: ProblemData, R: FactorVec, w: torch.Tensor) -> FactorVec:
    """2 (C + A^*(w)) R over all blocks (ALMCalGrad, lorads_alm.c:9-100)
    with w = rho (A(RR^T) - b) - lambda computed by the caller."""
    return grad_cached(pd, R, w, gather_caches(pd, R))


def cert_value(pd: ProblemData, g: FactorVec) -> torch.Tensor:
    """The ALM certificate ||g|| / (1 + ||C||_inf)."""
    return torch.sqrt(fv_norm2sq(g, pd)) / (1.0 + pd.c_nrm_inf)


def primal_infeas_l1(pd: ProblemData, total: torch.Tensor) -> torch.Tensor:
    """||b - A(X)||_2 / (1 + ||b||_1) (primalInfeasibility,
    lorads_alg_common.c:250-258: a 2-norm despite the "L1" label)."""
    return torch.linalg.vector_norm(pd.rhs - total) / (1.0 + pd.b_nrm1)
