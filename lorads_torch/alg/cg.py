"""Batched matrix-free conjugate gradients over [B, n, r] unknowns.

Port of lorads_tpu/alg/cg.py (31-159).  One CG instance per block, all
blocks of a bucket advanced in lockstep with per-block convergence
masking (a converged block's iterates stop changing; its alpha/beta are
forced to 0).  Semantics of the reference CGSolve
(lorads_cgs.c:81-240):

* stop when ||r||_2 / ||b||_1 < tol   (note the 1-norm scale)
* true-residual restart every 20 iterations
* warm start from the incoming x
* alpha = <r,r>/<p,Ap>, beta = <r',r'>/<r,r>

plus lorads_tpu's no-progress stop (a block whose residual has not
improved 1% in 40 iterations stops).  ``cg_solve_ir`` is lorads_tpu's
mixed-precision variant: f32 inner sweeps, f64 true residuals.

The operator is a closure X -> A(X) on [B, n, r].  lorads_tpu runs the
loops as device while_loops; here they are Python loops whose condition
is read on the host once per iteration (or refinement pass), each read
counted in ``device.HOST_SYNCS``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from lorads_torch import device as dev

RESTART_FREQ = 20


def _bdot(x, y):
    """Per-block dot: [B, n, r] x [B, n, r] -> [B]."""
    return torch.sum(x * y, dim=(1, 2))


def _safe_div(num, den):
    """num / den where den != 0, else 0."""
    return torch.where(den != 0, num / torch.where(den == 0, 1.0, den),
                       torch.zeros_like(num))


def cg_solve(op: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
             b: torch.Tensor, tol: float,
             max_iter: int) -> Tuple[torch.Tensor, int]:
    """Solve op(x) = b for each block.  Returns (x, iterations)."""
    b_nrm1 = torch.sum(torch.abs(b), dim=(1, 2))             # [B]
    safe_b1 = torch.where(b_nrm1 == 0, 1.0, b_nrm1)

    x = x0
    r = b - op(x0)
    p = r
    res = torch.sqrt(_bdot(r, r))
    done = res / safe_b1 < tol
    best = res
    since = torch.zeros_like(res, dtype=torch.int32)
    k = 0
    while k < max_iter and not dev.host_read(torch.all(done)):
        Q = op(p)
        qtr = _bdot(r, r)
        ptq = _bdot(p, Q)
        active = (~done).to(x.dtype)
        alpha = _safe_div(qtr, ptq) * active
        x = x + alpha[:, None, None] * p
        r = r - alpha[:, None, None] * Q
        if k % RESTART_FREQ == 0:
            # true-residual restart (lorads_cgs.c:195-211)
            r = b - op(x)
        qtr_new = _bdot(r, r)
        res_new = torch.sqrt(qtr_new)
        done_new = done | (res_new / safe_b1 < tol) | torch.isnan(res_new)
        # no-progress stop (cg.py:67-81)
        improved = res_new < 0.99 * best
        best = torch.minimum(best, res_new)
        since = torch.where(improved | done_new, 0, since + 1)
        done_new = done_new | (since >= 40)
        beta = _safe_div(qtr_new, qtr) * active
        p = r + beta[:, None, None] * p
        done = done_new
        k += 1
    return x, k


def cg_solve_ir(op_hi: Callable[[torch.Tensor], torch.Tensor],
                op_lo: Callable[[torch.Tensor], torch.Tensor],
                x0: torch.Tensor, b: torch.Tensor, tol: float,
                max_iter: int, inner_tol: float = 1e-5,
                max_passes: int = 6) -> Tuple[torch.Tensor, int]:
    """Mixed-precision CG by iterative refinement (cg.py:94-159): each
    pass solves op_lo(d) ~= r at float32 from zero (relative reduction
    ``inner_tol``), sets x += d and recomputes r = b - op_hi(x) at the
    ambient float64.  Stops on the reference criterion
    ||r||_2 / ||b||_1 < tol of the true residual; a pass that worsens
    the residual is reverted, and one that does not halve it marks the
    block done.  Returns (x, total inner iterations)."""
    b_nrm1 = torch.sum(torch.abs(b), dim=(1, 2))
    safe_b1 = torch.where(b_nrm1 == 0, 1.0, b_nrm1)

    x = x0
    r = b - op_hi(x0)
    res = torch.sqrt(_bdot(r, r))
    done = (res / safe_b1 < tol) | torch.isnan(res)
    passes, total = 0, 0
    while passes < max_passes and not dev.host_read(torch.all(done)):
        d32, k = cg_solve(op_lo, torch.zeros_like(r, dtype=torch.float32),
                          r.to(torch.float32), inner_tol, max_iter)
        act = (~done).to(x.dtype)[:, None, None]
        x_new = x + act * d32.to(x.dtype)
        r_new = b - op_hi(x_new)
        res_new = torch.sqrt(_bdot(r_new, r_new))
        nan = torch.isnan(res_new)
        # revert a pass that worsened the residual (cg.py:143-149)
        keep = (res_new <= res) & ~nan
        x = torch.where(keep[:, None, None], x_new, x)
        r = torch.where(keep[:, None, None], r_new, r)
        res_kept = torch.where(keep, res_new, res)
        # a pass that failed to halve the residual hit the IR floor
        done = (done | (res_kept / safe_b1 < tol) | nan
                | (res_new > 0.5 * res))
        res = res_kept
        passes += 1
        total += k
    return x, total
