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

As in lorads_tpu (one while_loop), the CGNR runs on the device: a
device-decided ``devloop.Loop`` (its exit, rs <= stop or the iteration
cap, tested on the device), one graph replay and one host read (label
``repair``) a run on the card, the LS norms in the read; on the CPU the
host reads the exit test before each iteration.
"""

from __future__ import annotations

import torch

from lorads_torch.alg import aop, devloop
from lorads_torch.alg.state import FactorVec, fv_norm2sq


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


def _proj(rhs, bb, z):
    """z projected onto {b^T z = 0}."""
    return torch.where(bb > 0, z - (torch.dot(rhs, z) / torch.clamp(
        bb, min=1e-30)) * rhs, z)


def cgnr_loop(pd, R: FactorVec, dual: torch.Tensor, n_iter,
              rel_tol: float = 1e-4) -> devloop.Loop:
    """The CGNR for (LS) from ``dual`` as a device-decided devloop.Loop
    (lorads_tpu dualrefine.py:127-150), its prologue computed here: the
    inputs are the spectrum-weighted R, CR, the dual, the stop level and
    the cap; the state (x, r, p, rs, iterations).  The pack: (iterations,
    ||S(dual) R||, ||S(dual + x) R||)."""
    R = _weight_by_spectrum(R)
    CR = aop.grad(pd, R, torch.zeros_like(dual)).scale(0.5)    # C R
    rhs = pd.rhs
    bb = torch.dot(rhs, rhs)

    def M(Rw, CRw, d):                           # A^*(d) R
        return aop.grad(pd, Rw, d).scale(0.5).axpy(-1.0, CRw)

    def Mt(Rw, Y):                               # A(sym(Y R^T)) in R^m
        return aop.auv(pd, Y, Rw)[1]

    r0 = CR.axpy(-1.0, M(R, CR, dual))           # S(dual) R
    ls0 = fv_norm2sq(r0)
    r = _proj(rhs, bb, Mt(R, r0))
    rs = torch.dot(r, r)
    inputs = (R, CR, dual, bb, rel_tol * rel_tol * rs, ls0,
              devloop.scalar(n_iter, torch.int64, dual.device))

    def running(inp, st):
        return (st[3] > inp[4]) & (st[4] < inp[6])

    def step(inp, st, kind):
        Rw, CRw, _, bbw = inp[:4]
        x, r, p, rs, its = st
        Ap = _proj(rhs, bbw, Mt(Rw, M(Rw, CRw, p)))
        denom = torch.dot(p, Ap)
        # non-positive curvature: numerical breakdown of the PSD normal
        # operator; alpha = 0 freezes the iterate
        alpha = torch.where(denom > 0.0, rs / torch.clamp(denom, min=1e-30),
                            torch.zeros_like(rs))
        r_next = r - alpha * Ap
        rs_new = torch.dot(r_next, r_next)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        return (x + alpha * p, r_next, r_next + beta * p, rs_new, its + 1)

    def pack(inp, st):
        Rw, CRw, d, _, _, ls0_, _ = inp
        ls1 = fv_norm2sq(CRw.axpy(-1.0, M(Rw, CRw, d + st[0])))
        return torch.stack([st[4].to(ls1.dtype), torch.sqrt(ls0_),
                            torch.sqrt(ls1)]).to(torch.float64)

    return devloop.Loop(
        key=("cgnr", devloop.ident(pd)), step=step, pack=pack,
        inputs=inputs, state=(torch.zeros_like(dual), r, r, rs,
                              torch.zeros((), dtype=torch.int64,
                                          device=dual.device)),
        label="repair", running=running)


def dual_ls_refine(pd, R: FactorVec, dual: torch.Tensor, n_iter: int,
                   rel_tol: float = 1e-4):
    """CGNR for (LS) from ``dual`` over the b-orthogonal subspace.

    Returns (step d, ls_norm0, ls_norm1, iterations): the refinement
    direction, sqrt of the LS objective before and after the full step
    and the CGNR iterations taken (at most ``n_iter``), the last three
    host numbers from the run's one read.  The caller forms the
    candidates dual + t d."""
    st, (its, ls0, ls1) = devloop.run(cgnr_loop(pd, R, dual, n_iter,
                                                rel_tol))
    return st[0], ls0, ls1, int(its)
