"""Batched matrix-free conjugate gradients over [B, n, r] unknowns.

Port of lorads_tpu/alg/cg.py (31-159).  One CG instance per block, all
blocks of a bucket advanced in lockstep with per-block convergence
masking (a converged block's iterates stop changing).  Semantics of the
reference CGSolve (lorads_cgs.c:81-240):

* stop when ||r||_2 / ||b||_1 < tol   (note the 1-norm scale)
* true-residual restart every 20 iterations
* warm start from the incoming x
* alpha = <r,r>/<p,Ap>, beta = <r',r'>/<r,r>

plus lorads_tpu's no-progress stop (a block whose residual has not
improved 1% in 40 iterations stops).  ``cg_solve_ir`` is lorads_tpu's
mixed-precision variant: f32 inner sweeps, f64 true residuals.

The operator is a closure x -> A(x) on [B, n, r], or a ``Bound``: a
function op(x, *operands) with its operands, which a graph takes as
inputs.  lorads_tpu runs the loop as a device while_loop; here it is a
``devloop.Loop``: the body
masked by the loop's exit test (no block active, or ``max_iter``
reached), evaluated on the device in every iteration, run in chunks of
``CHUNK`` iterations replayed from a CUDA graph with one host read per
chunk (label ``cg``).  ``tol`` and ``max_iter`` ride in as device
scalars and the operands as graph inputs, so one graph serves every
solve of a key (the bucket or block slice, the dtype and the rank).  A
masked iteration leaves x, r, p and the counters unchanged bit for bit
(``torch.where``, never a product with a 0/1 mask, so an inf or NaN in
a done block stays out of the others).  The refinement passes of
``cg_solve_ir`` keep one read each (label ``cg_ir``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from lorads_torch import device as dev
from lorads_torch.alg import devloop

RESTART_FREQ = 20
# CG iterations a chunk on the card, a divisor of RESTART_FREQ: the
# restart then sits at a chunk's first position or nowhere (two graphs).
# 2 read fastest on an H100 among 2, 5 and 10 (theta800, multiblock22;
# PERF.md): a masked iteration costs more device time than a read.
CHUNK = 2


def _bdot(x, y):
    """Per-block dot: [B, n, r] x [B, n, r] -> [B]."""
    return torch.sum(x * y, dim=(1, 2))


def _safe_div(num, den):
    """num / den where den != 0, else 0."""
    return torch.where(den != 0, num / torch.where(den == 0, 1.0, den),
                       torch.zeros_like(num))


class Bound:
    """The operator op(x, *operands) with its operands bound: callable on
    x alone.  In a CG loop the operands are inputs of its graph, and
    ``key`` names what op closes over (default: op itself)."""

    def __init__(self, op: Callable, operands=(), key=None):
        self.op, self.operands = op, tuple(operands)
        self.key = devloop.ident(op) if key is None else key

    def __call__(self, x):
        return self.op(x, *self.operands)


def cg_loop(op: Callable, x0: torch.Tensor, b: torch.Tensor, tol,
            max_iter) -> devloop.Loop:
    """The CG loop for op(x) = b from x0 (``op`` a closure or a Bound), as
    a devloop.Loop; its prologue (the initial residual) is computed
    here."""
    op = op if isinstance(op, Bound) else Bound(op)
    b_nrm1 = torch.sum(torch.abs(b), dim=(1, 2))             # [B]
    safe_b1 = torch.where(b_nrm1 == 0, 1.0, b_nrm1)
    r0 = b - op(x0)
    res0 = torch.sqrt(_bdot(r0, r0))
    tol = devloop.scalar(tol, b.dtype, b.device)
    done0 = res0 / safe_b1 < tol
    fn = op.op
    inputs = (op.operands, b, safe_b1, tol,
              devloop.scalar(max_iter, torch.int64, b.device))
    state = (x0, r0, r0, done0, res0, torch.zeros_like(res0,
                                                       dtype=torch.int32),
             torch.zeros((), dtype=torch.int64, device=b.device))

    def running(inp, st):
        done, k = st[3], st[6]
        return ~torch.all(done) & (k < inp[4])

    def step(inp, st, restart):
        operands, b, safe_b1, tol, _ = inp
        x, r, p, done, best, since, k = st
        run = running(inp, st)
        act = ~done & run
        a3 = act[:, None, None]
        Q = fn(p, *operands)
        qtr = _bdot(r, r)
        ptq = _bdot(p, Q)
        alpha = _safe_div(qtr, ptq)[:, None, None]
        x_n = torch.where(a3, x + alpha * p, x)
        r_n = r - alpha * Q
        if restart:
            # true-residual restart (lorads_cgs.c:195-211)
            r_n = b - fn(x_n, *operands)
        qtr_new = _bdot(r_n, r_n)
        res_new = torch.sqrt(qtr_new)
        done_n = done | (res_new / safe_b1 < tol) | torch.isnan(res_new)
        # no-progress stop (cg.py:67-81)
        improved = res_new < 0.99 * best
        best_n = torch.minimum(best, res_new)
        since_n = torch.where(improved | done_n, 0, since + 1)
        done_n = done_n | (since_n >= 40)
        beta = _safe_div(qtr_new, qtr)[:, None, None]
        p_n = r_n + beta * p
        return (x_n, torch.where(a3, r_n, r), torch.where(a3, p_n, p),
                torch.where(act, done_n, done),
                torch.where(act, best_n, best),
                torch.where(act, since_n, since), k + run.to(k.dtype))

    def pack(inp, st):
        return torch.stack([running(inp, st).to(torch.float64),
                            st[6].to(torch.float64)])

    return devloop.Loop(
        key=("cg", op.key, RESTART_FREQ), step=step, pack=pack, inputs=inputs,
        state=state, K=CHUNK, label="cg",
        kind=lambda pos: pos % RESTART_FREQ == 0)


def cg_solve(op: Callable, x0: torch.Tensor, b: torch.Tensor, tol,
             max_iter) -> Tuple[torch.Tensor, int]:
    """Solve op(x) = b for each block (``op`` a closure or a Bound).
    Returns (x, iterations).  ``tol`` and ``max_iter``: numbers or 0-d
    tensors."""
    st, out = devloop.run(cg_loop(op, x0, b, tol, max_iter))
    return st[0], int(out[1])


def cg_solve_ir(op_hi: Callable[[torch.Tensor], torch.Tensor],
                op_lo: Callable, x0: torch.Tensor, b: torch.Tensor, tol,
                max_iter, inner_tol: float = 1e-5,
                max_passes: int = 6) -> Tuple[torch.Tensor, int]:
    """Mixed-precision CG by iterative refinement (cg.py:94-159): each
    pass solves op_lo(d) ~= r at float32 from zero (relative
    reduction ``inner_tol``; cg_solve, in chunks), sets x += d and
    recomputes r = b - op_hi(x) at the ambient float64.  Stops on the
    reference criterion ||r||_2 / ||b||_1 < tol of the true residual; a
    pass that worsens the residual is reverted, and one that does not
    halve it marks the block done.  Returns (x, total inner
    iterations).  The host reads whether every block is done once a
    pass, after it; where every block is done from the start (lorads_tpu
    then runs no pass) the first pass solves for a zero right-hand side
    (no inner iteration; x and the count stay)."""
    b_nrm1 = torch.sum(torch.abs(b), dim=(1, 2))
    safe_b1 = torch.where(b_nrm1 == 0, 1.0, b_nrm1)

    x = x0
    r = b - op_hi(x0)
    res = torch.sqrt(_bdot(r, r))
    done = (res / safe_b1 < tol) | torch.isnan(res)
    passes, total = 0, 0
    while True:
        r32 = r.to(torch.float32)
        if passes == 0:
            r32 = torch.where(torch.all(done), 0.0, r32)
        d32, k = cg_solve(op_lo, torch.zeros_like(r32), r32, inner_tol,
                          max_iter)
        act = (~done).to(x.dtype)[:, None, None]
        x_new = x + act * d32.to(x.dtype)
        r_new = b - op_hi(x_new)
        res_new = torch.sqrt(_bdot(r_new, r_new))
        nan = torch.isnan(res_new)
        # revert a pass that worsened the residual (cg.py:143-149); a NaN
        # in a done block's d32 never passes keep
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
        if passes >= max_passes or dev.host_read(torch.all(done), "cg_ir"):
            return x, total
