"""Direct dual refinement: factor-space least squares on the slack.

Port of lorads_tpu/alg/dualrefine.py (19-153).  At a primal-dual
optimum of min <C,X> s.t. A(X)=b, X >= 0 with X = R R^T, complementary
slackness forces S(lambda) R = 0, S(lambda) = C - A^*(lambda).  Given a
near-optimal primal factor R, the dual consistent with complementarity
solves the linear least-squares problem

    min_lambda  || (C - A^*(lambda)) R ||_F^2            (LS)

by CGNR on operators the solver already has:

    M d    = A^*(d) R          (aop.grad / 2 minus the C term)
    M^T Y  = A(sym(Y R^T))     (aop.auv against R)

restricted to the level set {d : b^T d = 0}, so that dObj = b^T lambda
(and with it the gap) is unchanged by any step.  The caller
(solver._try_dual_refine) re-certifies the candidates dual + t d and
keeps one only if dinf meets its band.

lorads_tpu runs the CGNR loop on the device (one while_loop).  Here it
runs in masked chunks of ``CHUNK`` iterations with one host read per
chunk (counted in ``device.HOST_SYNCS``): the exit test rs <= stop is
applied per iteration, and an iteration past it leaves every iterate
unchanged, so the iteration count and the iterates are the reference's.
"""

from __future__ import annotations

import torch

from lorads_torch import device as dev
from lorads_torch.alg import aop
from lorads_torch.alg.state import FactorVec, fv_norm2sq

# CGNR iterations between two host reads of the exit test
CHUNK = 8


def _weight_by_spectrum(R: FactorVec) -> FactorVec:
    """Rt = R (R^T R)^{1/2} per block, so that ||S Rt||_F = ||S R R^T||_F
    = ||S X||_F: the LS equations weighted by X's spectrum (R's
    noise-level columns would otherwise count as much as its dominant
    ones; lorads_tpu dualrefine.py:47-65).  The r x r Gram square roots
    come from torch.linalg.eigh."""
    cones = []
    for Rb in R.cones:
        G = torch.einsum("bnr,bns->brs", Rb, Rb)
        evals, evecs = torch.linalg.eigh(G)
        sq = torch.sqrt(torch.clamp(evals, min=0.0))
        Gh = torch.einsum("brk,bk,bsk->brs", evecs, sq, evecs)
        cones.append(torch.einsum("bnr,brs->bns", Rb, Gh))
    return FactorVec(tuple(cones), R.lp)


def dual_ls_refine(pd, R: FactorVec, dual: torch.Tensor, n_iter: int,
                   rel_tol: float = 1e-4):
    """CGNR for (LS) from ``dual`` over the b-orthogonal subspace.

    Returns (step d, ls_norm0, ls_norm1, iterations): the refinement
    direction, sqrt of the LS objective before and after the full step
    (0-d tensors) and the CGNR iterations taken (at most ``n_iter``).
    The caller forms the candidates dual + t d."""
    R = _weight_by_spectrum(R)
    CR = aop.grad(pd, R, torch.zeros_like(dual)).scale(0.5)    # C R

    def M(d):                                    # A^*(d) R
        return aop.grad(pd, R, d).scale(0.5).axpy(-1.0, CR)

    def Mt(Y):                                   # A(sym(Y R^T)) in R^m
        return aop.auv(pd, Y, R)[1]

    rhs = pd.rhs
    bb = torch.dot(rhs, rhs)

    def proj(z):                                 # onto {b^T z = 0}
        return torch.where(bb > 0, z - (torch.dot(rhs, z) / torch.clamp(
            bb, min=1e-30)) * rhs, z)

    r0 = CR.axpy(-1.0, M(dual))                  # S(dual) R
    ls0 = fv_norm2sq(r0)
    r = proj(Mt(r0))
    x = torch.zeros_like(dual)
    p = r
    rs = torch.dot(r, r)
    stop = rel_tol * rel_tol * rs
    done = ~(rs > stop)
    its = torch.zeros((), dtype=torch.int64, device=dual.device)
    k = 0
    while k < n_iter and not dev.host_read(done, "repair"):
        for _ in range(min(CHUNK, n_iter - k)):
            Ap = proj(Mt(M(p)))
            denom = torch.dot(p, Ap)
            # non-positive curvature: numerical breakdown of the PSD
            # normal operator; alpha = 0 freezes the iterate
            alpha = torch.where(denom > 0.0,
                                rs / torch.clamp(denom, min=1e-30),
                                torch.zeros_like(rs))
            r_next = r - alpha * Ap
            rs_new = torch.dot(r_next, r_next)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            x = torch.where(done, x, x + alpha * p)
            p = torch.where(done, p, r_next + beta * p)
            r = torch.where(done, r, r_next)
            rs = torch.where(done, rs, rs_new)
            its = its + (~done).to(its.dtype)
            done = done | ~(rs > stop)
            k += 1
    ls1 = fv_norm2sq(CR.axpy(-1.0, M(dual + x)))
    return x, torch.sqrt(ls0), torch.sqrt(ls1), its
