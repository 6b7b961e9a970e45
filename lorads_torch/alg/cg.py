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
device-decided ``devloop.Loop`` (its exit, no block active or
``max_iter`` reached, tested on the device), and so are the refinement
passes of ``cg_solve_ir`` (lorads_tpu's pass while_loop).  Inside
another loop's step (the ADMM iteration, ``devloop.in_step()``) they
run through ``devloop.nest``: WHILE nodes under capture, the CG restart
an IF node, and the counts come back as device tensors.  Called at the
top (the tests), through ``devloop.run``: on the card one graph replay
runs the solve and the host reads its pack once (label ``cg`` or
``cg_ir``); on the CPU the host reads the exit test before each
iteration or pass.  A done block's iterates stay unchanged bit for bit
(``torch.where``, never a product with a 0/1 mask, so an inf or NaN in
a done block stays out of the others).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from lorads_torch.alg import devloop

RESTART_FREQ = 20


def _bdot(x, y):
    """Per-block dot: [B, n, r] x [B, n, r] -> [B]."""
    return torch.sum(x * y, dim=(1, 2))


def restart_due(k):
    """The true-residual restart's predicate on the iteration count k (a
    branch of the step: an IF node under capture)."""
    return k % RESTART_FREQ == 0


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
    a device-decided devloop.Loop; its prologue (the initial residual) is
    computed here."""
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
        # runs while ``running`` holds
        operands, b, safe_b1, tol, _ = inp
        x, r, p, done, best, since, k = st
        act = ~done
        a3 = act[:, None, None]
        Q = fn(p, *operands)
        qtr = _bdot(r, r)
        ptq = _bdot(p, Q)
        alpha = _safe_div(qtr, ptq)[:, None, None]
        x_n = torch.where(a3, x + alpha * p, x)
        r_n = r - alpha * Q
        # true-residual restart (lorads_cgs.c:195-211); restart None: the
        # device decides (an IF node on k)
        if restart is None:
            r_n = devloop.branch(restart_due, (k,),
                                 lambda: b - fn(x_n, *operands), r_n,
                                 "cg_restart")
        elif restart:
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
                torch.where(act, since_n, since), k + 1)

    def pack(inp, st):
        return st[6].to(torch.float64).reshape(1)

    return devloop.Loop(
        key=("cg", op.key, RESTART_FREQ), step=step, pack=pack, inputs=inputs,
        state=state, K=None, label="cg",
        kind=lambda pos: pos % RESTART_FREQ == 0, running=running)


def _solve(loop: devloop.Loop, count: int):
    """Run a device-decided solve -> (x, the count at state[count]): nested
    in a step (the count a 0-d tensor), else at the top (an int)."""
    if devloop.in_step():
        st = devloop.nest(loop)
        return st[0], st[count]
    st, out = devloop.run(loop)
    return st[0], int(out[0])


def cg_solve(op: Callable, x0: torch.Tensor, b: torch.Tensor, tol,
             max_iter) -> Tuple[torch.Tensor, int]:
    """Solve op(x) = b for each block (``op`` a closure or a Bound).
    Returns (x, iterations).  ``tol`` and ``max_iter``: numbers or 0-d
    tensors.  Inside a device-decided loop's step the iterations come
    back as a 0-d int64 tensor."""
    return _solve(cg_loop(op, x0, b, tol, max_iter), 6)


def cg_solve_ir(op_hi: Callable[[torch.Tensor], torch.Tensor],
                op_lo: Callable, x0: torch.Tensor, b: torch.Tensor, tol,
                max_iter, inner_tol: float = 1e-5,
                max_passes: int = 6) -> Tuple[torch.Tensor, int]:
    """Mixed-precision CG by iterative refinement (cg.py:94-159), run to
    its exit (``ir_loop``).  Returns (x, total inner iterations); inside a
    device-decided loop's step the count comes back as a 0-d int64
    tensor."""
    return _solve(ir_loop(op_hi, op_lo, x0, b, tol, max_iter, inner_tol,
                          max_passes), 5)


def ir_loop(op_hi: Callable[[torch.Tensor], torch.Tensor], op_lo: Callable,
            x0: torch.Tensor, b: torch.Tensor, tol, max_iter,
            inner_tol: float = 1e-5, max_passes: int = 6) -> devloop.Loop:
    """cg_solve_ir's passes as a device-decided devloop.Loop: each
    pass solves op_lo(d) ~= r at float32 from zero (relative
    reduction ``inner_tol``; cg_solve, nested) sets x += d and
    recomputes r = b - op_hi(x) at the ambient float64.  Stops on the
    reference criterion ||r||_2 / ||b||_1 < tol of the true residual; a
    pass that worsens the residual is reverted, and one that does not
    halve it marks the block done.  The state: (x, r, res, done, passes,
    total inner iterations).  The first pass
    always runs: where every block is done from the start (lorads_tpu
    then runs no pass) it solves for a zero right-hand side (no inner
    iteration; x and the count stay).  ``op_hi`` and ``op_lo`` (and
    ``max_iter``, ``inner_tol``) are frozen into a graph: its key holds
    them by identity."""
    b_nrm1 = torch.sum(torch.abs(b), dim=(1, 2))
    safe_b1 = torch.where(b_nrm1 == 0, 1.0, b_nrm1)
    r = b - op_hi(x0)
    res = torch.sqrt(_bdot(r, r))
    tol = devloop.scalar(tol, b.dtype, b.device)
    done = (res / safe_b1 < tol) | torch.isnan(res)
    zero = torch.zeros((), dtype=torch.int64, device=b.device)

    def running(inp, st):
        passes, done = st[4], st[3]
        return (passes < max_passes) & ((passes == 0) | ~torch.all(done))

    def step(inp, st, kind):
        b, safe_b1, tol = inp
        x, r, res, done, passes, total = st
        x, r, res, done, k = _ir_pass(op_hi, op_lo, b, safe_b1, tol,
                                      max_iter, inner_tol, x, r, res, done,
                                      passes == 0)
        return x, r, res, done, passes + 1, total + k

    key = ("cg_ir", devloop.ident(op_hi),
           op_lo.key if isinstance(op_lo, Bound) else devloop.ident(op_lo),
           max_iter, inner_tol, max_passes)
    return devloop.Loop(
        key=key, step=step,
        pack=lambda inp, st: st[5].to(torch.float64).reshape(1),
        inputs=(b, safe_b1, tol), state=(x0, r, res, done, zero, zero),
        K=None, label="cg_ir", running=running)


def _ir_pass(op_hi, op_lo, b, safe_b1, tol, max_iter, inner_tol, x, r, res,
             done, first):
    """One refinement pass of cg_solve_ir (``first``: a 0-d bool, the
    first pass, whose right-hand side is zero where every block is done)
    -> (x, r, res, done, inner iterations)."""
    r32 = torch.where(first & torch.all(done), 0.0, r.to(torch.float32))
    d32, k = cg_solve(op_lo, torch.zeros_like(r32), r32, inner_tol, max_iter)
    act = (~done).to(x.dtype)[:, None, None]
    x_new = x + act * d32.to(x.dtype)
    r_new = b - op_hi(x_new)
    res_new = torch.sqrt(_bdot(r_new, r_new))
    nan = torch.isnan(res_new)
    # revert a pass that worsened the residual (cg.py:143-149); a NaN in a
    # done block's d32 never passes keep
    keep = (res_new <= res) & ~nan
    x = torch.where(keep[:, None, None], x_new, x)
    r = torch.where(keep[:, None, None], r_new, r)
    res_kept = torch.where(keep, res_new, res)
    # a pass that failed to halve the residual hit the IR floor
    done = (done | (res_kept / safe_b1 < tol) | nan | (res_new > 0.5 * res))
    return x, r, res_kept, done, k
