"""Phase I -- Augmented Lagrangian Method on the single factor R.

minimize  <C, RR^T> - lambda^T (A(RR^T) - b) + (rho/2) ||A(RR^T) - b||^2

by L-BFGS directions + exact quartic line search.  Port of
lorads_tpu/alg/alm.py.  As there, an ALM phase runs on the device as
nested device-decided loops (alg/devloop.py):

* the outer loop (``outer_loop``; lorads_tpu's ``outer_chunk``): up to
  ``alm_max_outers`` outer iterations a run, each the middle loop, the
  rho do-while, the objective / DIMACS refresh and every termination,
  rank and budget decision of LORADS_ALMOptimize (lorads_alm.c:991-1255;
  745-987 for its reopt variant) as device arithmetic, with a per-outer
  record in a log buffer;
* the middle loop (``_middle_loop``): one outer iteration's L-BFGS
  passes with the EMA stagnation, certificate and budget checks, the
  dual ascent after a pass, the difficulty grading and the rank flag;
* the inner L-BFGS loop (``inner_loop``): direction, line search and
  update, the cache refresh every ``refresh_every`` steps a branch;
* the UpdateRho do-while (``_rho_loop``).

On the card a run of the outer loop is one replay of one graph (WHILE
nodes for the outer, middle, inner and rho loops, an IF node for the
refresh) and one packed host read (label ``alm``: PACK_F, PACK_I and the
log buffer).  On the CPU the steps run eagerly, the host reading each
loop's exit test before each step.  The host (``alm_optimize``) prints
the ``ALM Outer:`` lines from the log buffer and checks the time limit
and the grind threshold after each read; the run stops on the device
when the grind threshold is crossed.  The decisions are those of
LORADS_ALMOptimize in the same order, on f64 device scalars, each with
the reference's order of operations.

With ``TRACE_FIX_INI`` (set by the solver from
``LoradsParams.fix_init_point``) each inner step also writes its
direction norm, tau and its "accepted" flag into a row of a device
buffer of one outer's steps, a run is one outer iteration, and the host
prints the rows after the run's read, in step order: ``nrm2U: %.20f``
every step and ``tau: %.20f`` every accepted step, as lorads_tpu's
jax.debug.print trace (alm.py:36-43, 171-189; lorads_alm.c:1081-1089,
1116-1118).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from lorads_torch import device as dev
from lorads_torch.alg import aop, devloop
from lorads_torch.alg.aop import ProblemData
from lorads_torch.alg.linesearch import alm_line_search
from lorads_torch.alg.state import (FactorVec, LBFGSHistory, fv_norm2sq,
                                    history_push, history_reset,
                                    lbfgs_direction)

EASY, MEDIUM, HARD, SUPER = 0, 1, 2, 3

# The FIX_INI_POINT step trace (see the module docstring); read when an
# ALM phase starts, and part of its loop's key.
TRACE_FIX_INI = False


@dataclasses.dataclass
class ALMStats:
    """Host-side mutable ALM iteration state (lorads_solver.c:1119)."""

    rho: float
    outer_iter: int = 0
    inner_iter: int = 0
    pobj: float = 1e30
    dobj: float = 1e30
    pinf_l1: float = 1e30
    pinf_inf: float = 1e30
    gap: float = 1e30
    tau: float = 0.0


def alm_recompute(pd: ProblemData, R: FactorVec, dual, rho):
    """Fresh A(RR^T), gradient and certificate value (ALG_START,
    lorads_alm.c:1010-1014).  The certificate stays on the device."""
    _, total = aop.auv(pd, R, R)
    w = rho * (total - pd.rhs) - dual
    g = aop.grad(pd, R, w)
    return total, g, aop.cert_value(pd, g)


def alm_dual_and_grad(pd: ProblemData, R: FactorVec, dual, constr_sum, rho,
                      caches):
    """lambda += rho (b - A(X)); then grad/cert at the new dual
    (lorads_alm.c:1151-1153), from R's caches."""
    dual_n = dual + rho * (pd.rhs - constr_sum)
    w = rho * (constr_sum - pd.rhs) - dual_n
    g = aop.grad_cached(pd, R, w, caches)
    return dual_n, g, aop.cert_value(pd, g)


def alm_obj_dimacs(pd: ProblemData, R: FactorVec, dual, scale):
    """(fresh constr_sum, [pObj, dObj, pinf_l1, gap] as host floats)
    (calObj_alm + LORADSCalDualObj + updateDimacsALM)."""
    pobj = aop.obj_only(pd, R, R) / scale
    dobj = torch.dot(pd.rhs, dual) / scale
    _, total = aop.auv(pd, R, R)
    pinf = aop.primal_infeas_l1(pd, total)
    pobj, dobj, pinf = dev.host_read(torch.stack([pobj, dobj, pinf]), "other")
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return total, [pobj, dobj, pinf, gap]


def _sel(pred, a, b):
    """torch.where over two equal trees of tensors (None passes)."""
    la, layout = devloop.flatten(a)
    lb, _ = devloop.flatten(b)
    return devloop.unflatten(layout, [torch.where(pred, x, y)
                                      for x, y in zip(la, lb)])


def ema_update(cur, old, n, value):
    """The EMA stagnation detector LUtilUpdateCheckEma
    (lorads_utils.c:404-434; alpha 0.1, threshold 0.005, interval 5) on
    device scalars -> (cur, old, n, go): ``go`` False when the average
    moved less than the threshold over the interval."""
    cur = 0.1 * value + (1 - 0.1) * cur
    at = n >= 5
    change = (cur - old) / torch.where(old == 0.0, 1.0, old)
    go = ~(at & (old != 0.0)) | ((change >= -0.005) & (change <= 0.005))
    return (cur, torch.where(at, cur, old), torch.where(at, 1, n + 1), go)


# ---------------------------------------------------------------------------
# The inner L-BFGS loop.
# ---------------------------------------------------------------------------

def refresh_due(refresh_every: int):
    """The cache refresh's predicate on the inner step count it (a branch
    of the step: an IF node under capture)."""
    return lambda it: it % refresh_every == refresh_every - 1


def _inner_step(pd: ProblemData, check_pinf_conv: bool, refresh_every: int,
                trace: bool = False):
    """The inner L-BFGS step and the loop's exit test
    (lorads_alm.c:1073-1150; lorads_tpu alm.py:150-233) -> (running,
    step).  ``step(inputs, state, refresh)`` runs while ``running``
    holds; ``refresh`` (this step recomputes the caches and A(RR^T),
    every refresh_every steps) None: the device decides, an IF node.  A
    rejected step (line-search failure, tau too small) leaves R, the
    gradient, the history, the caches, A(RR^T), cert and pinf as they
    were (selects).  With ``trace`` the state ends in (buffer, row):
    the step writes [||D||, tau, accepted, 1] into that row."""
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)

    def running(inp, st):
        _, _, cert_tol, end_sub_tol, _, phase1_tol, gap_ok, max_local = inp
        cert, pinf, it, num_err, tau_small = (st[5], st[6], st[7], st[9],
                                              st[10])
        run = ((cert - cert_tol > end_sub_tol) & (it < max_local)
               & ~num_err & ~tau_small)
        if check_pinf_conv:
            run = run & ~((pinf * pinf_scale <= phase1_tol) & gap_ok)
        return run

    def step(inp, st, refresh):
        dual, rho, _, _, end_tau_tol = inp[:5]
        R, grad, hist, caches, cs, cert, pinf, it = st[:8]
        hist = history_reset(hist, it % 300 == 0)
        D = lbfgs_direction(hist, grad, pd)
        q0 = pd.rhs - cs
        p1, q1, p2, q2, dcaches = aop.obj_and_auv_pair_cached(
            pd, R, D, caches)
        p1, q1 = 2.0 * p1, 2.0 * q1
        tau_n, num = alm_line_search(rho, dual, p1, p2, q0, q1, q2)
        err_n = num == 0
        small_n = ~err_n & (torch.abs(tau_n) < end_tau_tol)
        ok = ~err_n & ~small_n
        y0 = grad.scale(-1.0)
        Rn = R.axpy(tau_n, D)
        cs_inc = cs + tau_n * q1 + (tau_n * tau_n) * q2
        # A(RR^T) and the caches advance incrementally (exact in exact
        # arithmetic) and are recomputed every refresh_every steps for
        # fp hygiene (the reference recomputes each step,
        # lorads_alm.c:1128-1130; lorads_tpu's lax.cond, alm.py:205)
        keep = (aop.axpy_caches(caches, tau_n, dcaches), cs_inc)

        def fresh():
            can = aop.gather_caches(pd, Rn)
            return can, aop.auv_cached(pd, Rn, can)
        if refresh is None:
            can, total = devloop.branch(refresh_due(refresh_every), (it,),
                                        fresh, keep, "alm_refresh")
        else:
            can, total = fresh() if refresh else keep
        w = rho * (cs_inc - pd.rhs) - dual
        gn = aop.grad_cached(pd, Rn, w, can)
        hist = history_push(hist, D.scale(tau_n), y0 + gn, ok, pd)
        pinf_n = aop.primal_infeas_l1(pd, total)
        cert_n = aop.cert_value(pd, gn)
        caches = tuple(c if c is None else aop.CRCache(
            torch.where(ok, n.cr, c.cr)) for n, c in zip(can, caches))
        out = (_sel(ok, Rn, R), _sel(ok, gn, grad), hist, caches,
               torch.where(ok, total, cs), torch.where(ok, cert_n, cert),
               torch.where(ok, pinf_n, pinf), it + 1, tau_n, err_n, small_n)
        if not trace:
            return out
        buf, row = st[11:13]
        rec = torch.stack([torch.sqrt(fv_norm2sq(D, pd)), tau_n,
                           ok.to(tau_n.dtype), torch.ones_like(tau_n)])
        buf = buf.index_copy(0, row.reshape(1),
                             rec.to(buf.dtype).reshape(1, 4))
        return out + (buf, row + 1)
    return running, step


def inner_loop(pd: ProblemData, R: FactorVec, grad: FactorVec,
               hist: LBFGSHistory, dual, constr_sum, cert_val, rho,
               cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
               max_local, check_pinf_conv: bool = True,
               refresh_every: int = 25, caches=None,
               trace=None) -> devloop.Loop:
    """The inner L-BFGS loop (lorads_alm.c:1073-1150) as a device-decided
    devloop.Loop: the scalars (rho, the tolerances, gap_ok, max_local;
    numbers or 0-d tensors) become device scalars, and with ``dual``
    the loop's inputs; the state carries R, the gradient, the history
    (device head and valid count), the caches, A(RR^T), cert, pinf and
    the step's it, tau, num_err and tau_small, and ``trace`` (the FIX_INI
    buffer and its next row) if given.  The history reset at it % 300
    == 0 is a device select in the step.  The pack: (running, cert,
    pinf, it, tau, num_err, tau_small)."""
    if caches is None:
        caches = aop.gather_caches(pd, R)
    dt, dv = pd.rhs.dtype, pd.rhs.device

    def scalar(v, dtype=dt):
        return devloop.scalar(v, dtype, dv)

    running, step = _inner_step(pd, check_pinf_conv, refresh_every,
                                trace is not None)
    inputs = (dual, scalar(rho), scalar(cert_tol), scalar(end_sub_tol),
              scalar(end_tau_tol), scalar(phase1_tol),
              scalar(gap_ok, torch.bool), scalar(max_local, torch.int64))
    false = torch.zeros((), dtype=torch.bool, device=dv)
    state = (R, grad, hist, tuple(caches), constr_sum, scalar(cert_val),
             aop.primal_infeas_l1(pd, constr_sum),
             torch.zeros((), dtype=torch.int64, device=dv),
             torch.zeros((), dtype=dt, device=dv), false, false)
    if trace is not None:
        state += tuple(trace)

    def pack(inp, st):
        return torch.stack([x.to(torch.float64) for x in (
            running(inp, st), st[5], st[6], st[7], st[8], st[9], st[10])])

    return devloop.Loop(
        key=("alm_inner", devloop.ident(pd), check_pinf_conv,
             refresh_every, trace is not None),
        step=step, pack=pack, inputs=inputs, state=state, label="alm_inner",
        kind=lambda pos: pos % refresh_every == refresh_every - 1,
        running=running)


def _inner_loop(pd: ProblemData, R: FactorVec, grad: FactorVec,
                hist: LBFGSHistory, dual, constr_sum, cert_val, rho,
                cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
                max_local, check_pinf_conv: bool = True,
                refresh_every: int = 25, caches=None):
    """The inner L-BFGS loop (lorads_alm.c:1073-1150) run alone to its
    exit (one replay and one read, label ``alm_inner``, on the card).

    Exits when: certificate satisfied, local iteration cap, tau too
    small, line-search failure, or (init phase only) primal
    infeasibility below phase1Tol.  ``caches`` hold CR = C @ R; per
    iteration only C @ D is computed and the caches advance by tau,
    with a fresh recompute every ``refresh_every`` steps.  Returns (R,
    grad, hist, constr_sum, info, caches), info's values host numbers.
    """
    st, out = devloop.run(inner_loop(
        pd, R, grad, hist, dual, constr_sum, cert_val, rho, cert_tol,
        end_sub_tol, end_tau_tol, phase1_tol, gap_ok, max_local,
        check_pinf_conv, refresh_every, caches))
    R, grad, hist, caches, constr_sum = st[:5]
    info = dict(cert_val=out[1], pinf_l1=out[2], local_iter=int(out[3]),
                tau=out[4], num_err=bool(out[5]), tau_small=bool(out[6]))
    return R, grad, hist, constr_sum, info, caches


# ---------------------------------------------------------------------------
# The middle loop and the rho do-while.
# ---------------------------------------------------------------------------

# Exit codes of the middle loop (one ALM outer iteration's L-BFGS
# passes; mirrors the host control flow of LORADS_ALMOptimize,
# lorads_alm.c:1040-1171).
M_RUNNING, M_EASY, M_CERT_TOL, M_EMA_STOP, M_BUDGET, M_RANK, \
    M_NUM_ERR, M_TAU_SMALL, M_PINF_CONV, M_NO_IMPROVE = range(10)
PASS_CAP = 801     # inner steps a pass (lorads_alm.c:1073)


@dataclasses.dataclass
class _Middle:
    """The middle loop's state (lorads_tpu alm.py:393-406)."""

    R: FactorVec
    grad: FactorVec
    hist: LBFGSHistory
    caches: tuple
    dual: torch.Tensor
    constr_sum: torch.Tensor
    cert_val: torch.Tensor
    pinf_l1: torch.Tensor
    tau: torch.Tensor
    best_cert: torch.Tensor
    no_improve: torch.Tensor
    ema_cur: torch.Tensor
    ema_old: torch.Tensor
    ema_n: torch.Tensor
    iter_counter: torch.Tensor
    total_inner: torch.Tensor
    rank_flag: torch.Tensor
    difficulty: torch.Tensor
    exit: torch.Tensor
    trace: Any = None      # the FIX_INI buffer, or None


def _middle_loop(pd: ProblemData, c: _Middle, inputs, check_pinf_conv: bool,
                 high_acc_mode: bool, refresh_every: int) -> devloop.Loop:
    """One ALM outer iteration's middle loop (lorads_tpu
    ``_middle_and_rho``'s while_loop, alm.py:284-407) from ``c``: a pass
    runs only where the pre-pass checks leave the exit M_RUNNING (else
    the inner loop runs no step and the pass's results are not taken).
    ``inputs``: (rho, cert_tol, end_sub_tol, end_tau_tol, phase1_tol,
    gap_ok, max_sub, rank_flag_thres, armed, go); ``go`` False runs no
    pass at all (the outer loop's k-budget break)."""
    def running(inp, c):
        return inp[9] & (c.difficulty != EASY) & (c.exit == M_RUNNING)

    def step(inp, c, kind):
        (rho, cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
         max_sub, thres, armed, _) = inp

        def code(cond, new, e):
            return torch.where((e == M_RUNNING) & cond, new, e)

        # --- pre-pass checks, in host order ---
        improved = c.cert_val < c.best_cert * 0.99
        best = torch.where(improved, c.cert_val, c.best_cert)
        no_improve = torch.where(improved, 0, c.no_improve + 1)
        ema_cur, ema_old, ema_n, ema_go = ema_update(
            c.ema_cur, c.ema_old, c.ema_n, c.cert_val)
        e = torch.where(no_improve >= 3, M_NO_IMPROVE, M_RUNNING)
        if not high_acc_mode:
            e = code(~ema_go, M_EMA_STOP, e)
        e = code(c.iter_counter >= max_sub, M_BUDGET, e)
        e = code(armed & (c.rank_flag >= thres), M_RANK, e)
        e = code(c.cert_val <= cert_tol, M_CERT_TOL, e)
        go = e == M_RUNNING

        inner = devloop.nest(inner_loop(
            pd, c.R, c.grad, c.hist, c.dual, c.constr_sum, c.cert_val, rho,
            cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
            torch.where(go, PASS_CAP, 0), check_pinf_conv, refresh_every,
            c.caches, None if c.trace is None else (c.trace, c.total_inner)))
        R1, g1, h1, ca1, cs1, cert1, pinf1, local, tau1, err1, small1 = \
            inner[:11]
        e2 = torch.where(err1, M_NUM_ERR, M_RUNNING)
        e2 = code(small1, M_TAU_SMALL, e2)
        if check_pinf_conv:
            e2 = code(gap_ok & (pinf1 * (1.0 + pd.b_nrm1)
                                / (1.0 + pd.b_nrm_inf) <= phase1_tol),
                      M_PINF_CONV, e2)
        # dual ascent + fresh gradient (lorads_alm.c:1151-1153), taken
        # after a pass that does not break first (num_err / tau_small /
        # converged)
        graded = go & (e2 == M_RUNNING)
        dual_n, g2, cert2 = alm_dual_and_grad(pd, R1, c.dual, cs1, rho,
                                              ca1)
        # difficulty grading (lorads_alm.c:1154-1171); reopt grades
        # SUPER as HARD
        difficulty = torch.where(
            local <= 20, EASY, torch.where(
                local <= 100, MEDIUM, torch.where(local < 400, HARD,
                                                  SUPER)))
        if not check_pinf_conv:
            difficulty = torch.clamp(difficulty, max=HARD)
        rank_inc = torch.where(local <= 20, 0, torch.where(
            local <= 100, 2, torch.where(difficulty == HARD, 3, 4)))
        # EASY resets the flag; grading only on a normally completed pass
        rank_flag = torch.where(graded, torch.where(
            local <= 20, 0, c.rank_flag + rank_inc), c.rank_flag)
        return _Middle(
            R=R1, grad=_sel(graded, g2, g1), hist=h1, caches=ca1,
            dual=torch.where(graded, dual_n, c.dual), constr_sum=cs1,
            cert_val=torch.where(graded, cert2, cert1),
            pinf_l1=torch.where(go, pinf1, c.pinf_l1),
            tau=torch.where(go, tau1, c.tau), best_cert=best,
            no_improve=no_improve, ema_cur=ema_cur, ema_old=ema_old,
            ema_n=ema_n, iter_counter=c.iter_counter + local,
            total_inner=c.total_inner + local, rank_flag=rank_flag,
            difficulty=torch.where(go, difficulty, c.difficulty),
            exit=torch.where(go, e2, e),
            trace=None if c.trace is None else inner[11])

    return devloop.Loop(
        key=("alm_middle",), step=step, pack=None, inputs=inputs, state=c,
        label="alm", running=running)


def _rho_loop(pd: ProblemData, m: _Middle, rho, factor, todo) -> devloop.Loop:
    """do { rho *= factor; recompute grad } while (0.1/rho >= cert)
    (UpdateRho, lorads_alm.c:1174-1180; lorads_tpu alm.py:88-105) from
    the middle loop's final state, where the 0-d bool ``todo`` holds
    (else no step).  State: (rho, grad, cert, steps)."""
    def running(inp, st):
        rho_, _, cert, n = st
        return inp[-1] & ((n == 0) | (0.1 / rho_ >= cert))

    def step(inp, st, kind):
        R, dual, cs, caches, factor_, _ = inp
        rho_n = st[0] * factor_
        w = rho_n * (cs - pd.rhs) - dual
        g = aop.grad_cached(pd, R, w, caches)
        return rho_n, g, aop.cert_value(pd, g), st[3] + 1

    return devloop.Loop(
        key=("alm_rho",), step=step, pack=None,
        inputs=(m.R, m.dual, m.constr_sum, m.caches, factor, todo),
        state=(rho, m.grad, m.cert_val, torch.zeros_like(m.total_inner)),
        label="alm", running=running)


# ---------------------------------------------------------------------------
# The outer loop.
# ---------------------------------------------------------------------------

# Outer exit codes.
O_LIMIT, O_DONE, O_NUM_ERR, O_RANK, O_KMAX = range(5)

# ALM grind escalation threshold (auto-history solves): cumulative
# inner iterations in one init ALM phase beyond which the solver
# restarts the phase with L-BFGS history 4 (see alm_optimize).
GRIND_INNER_THRESHOLD = 6000
# single-outer grind symptom: one outer's middle loop needing this many
# L-BFGS iterations
GRIND_OUTER_THRESHOLD = 1500
# MAX_ALM_SUB_ITER's ceiling (lorads_alm.c:1044-1049)
MAX_SUB_CAP = 25000
# the reference never moves its last_outer_start (lorads_alm.c:1013)
LAST_OUTER_START = 1

# The pack a run's read returns: every scalar the host needs, then the
# log buffer, one row an outer: k, its inner steps, pObj, dObj, pinf_l1,
# pinf_inf, gap, rho (lorads_tpu's LOG_COLS), then its middle exit and
# tau (the host's "update rho since tau is too small" line).
PACK_F = ("cert_val", "rho", "rho_factor", "pobj", "dobj",
          "pinf_l1", "pinf_inf", "gap", "tau")
PACK_I = ("rho_flag", "k", "max_sub", "update_max_sub_counter",
          "rank_flag", "total_inner", "mexit", "oexit", "n_done")
LOG_COLS = 10


@dataclasses.dataclass
class ALMInputs:
    """The outer loop's inputs: device scalars (``budget``: the run's
    inner-step budget; ``grind_armed``: stop after an outer of
    GRIND_OUTER_THRESHOLD inner steps)."""

    scale_obj: torch.Tensor
    k0: torch.Tensor
    max_alm_iter: torch.Tensor
    rank_flag_thres: torch.Tensor
    is_rank_max: torch.Tensor
    phase1_tol: torch.Tensor
    phase2_tol: torch.Tensor
    end_sub_tol: torch.Tensor
    end_tau_tol: torch.Tensor
    budget: torch.Tensor
    grind_armed: torch.Tensor


@dataclasses.dataclass
class ALMCarry:
    """The outer loop's state (lorads_tpu outer_chunk's carry,
    alm.py:654-670), with ``last_inner`` (the last outer's inner steps)
    and the FIX_INI buffer."""

    R: FactorVec
    grad: FactorVec
    hist: LBFGSHistory
    caches: tuple
    dual: torch.Tensor
    constr_sum: torch.Tensor
    cert_val: torch.Tensor
    rho: torch.Tensor
    rho_factor: torch.Tensor
    rho_flag: torch.Tensor
    k: torch.Tensor
    max_sub: torch.Tensor
    update_max_sub_counter: torch.Tensor
    rank_flag: torch.Tensor
    total_inner: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    pinf_l1: torch.Tensor
    pinf_inf: torch.Tensor
    gap: torch.Tensor
    tau: torch.Tensor
    mexit: torch.Tensor
    oexit: torch.Tensor
    n_done: torch.Tensor
    last_inner: torch.Tensor
    logbuf: torch.Tensor
    trace: Any = None


def outer_loop(pd: ProblemData, inputs: ALMInputs, carry: ALMCarry,
               reopt: bool = False, high_acc_mode: bool = False,
               early_stop: bool = True, cones_ok: bool = True,
               refresh_every: int = 25) -> devloop.Loop:
    """Up to ``carry.logbuf.shape[0]`` whole ALM outer iterations as one
    device-decided loop (lorads_tpu's ``outer_chunk``, alm.py:488-676):
    the k-budget break, the max_sub adaptation, the middle loop, the rho
    do-while and the history reset, the rho-factor damping, the init
    mode's fast termination, the DIMACS refresh, the reopt and strict
    termination and the rank trigger, each outer's record in the log
    buffer.  It runs while the outer exit is O_LIMIT, fewer than
    max_outers outers ran, the run's inner steps stay under the budget
    and (grind armed) no outer took GRIND_OUTER_THRESHOLD steps.  The
    pack: PACK_F, PACK_I, the log buffer."""
    max_outers = carry.logbuf.shape[0]
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)
    check_pinf_conv = not reopt
    f64 = torch.float64

    def running(inp, c):
        return ((c.oexit == O_LIMIT) & (c.n_done < max_outers)
                & (c.total_inner < inp.budget)
                & ~(inp.grind_armed
                    & (c.last_inner >= GRIND_OUTER_THRESHOLD)))

    def step(inp, c, kind):
        p1, p2 = inp.phase1_tol, inp.phase2_tol
        # ---- loop-top break (k budget): no outer runs, the carry stays
        brk = c.k > inp.max_alm_iter
        if reopt:
            brk = brk & (c.pinf_inf <= p1)
            if high_acc_mode:
                brk = brk & (c.gap <= torch.maximum(p1, p2 * 5))
        go = ~brk
        # max_alm_sub_iter adaptation (lorads_alm.c:1044-1049)
        bump = c.update_max_sub_counter >= 2
        umsc = torch.where(bump, 0, c.update_max_sub_counter)
        max_sub = torch.where(bump, torch.clamp(c.max_sub + 10000,
                                                max=MAX_SUB_CAP), c.max_sub)
        gap_ok = (c.gap <= p1) if high_acc_mode else torch.ones_like(go)
        armed = ~inp.is_rank_max & (c.k - LAST_OUTER_START >= 3)
        cert_tol = 0.1 / c.rho
        zero = torch.zeros_like(c.k)
        m = devloop.nest(_middle_loop(pd, _Middle(
            R=c.R, grad=c.grad, hist=c.hist, caches=c.caches, dual=c.dual,
            constr_sum=c.constr_sum, cert_val=c.cert_val,
            pinf_l1=c.pinf_l1, tau=torch.zeros_like(c.tau),
            best_cert=torch.full_like(c.cert_val, float("inf")),
            no_improve=zero, ema_cur=torch.zeros_like(c.tau),
            ema_old=torch.zeros_like(c.tau), ema_n=zero + 1,
            iter_counter=zero + 1, total_inner=zero, rank_flag=c.rank_flag,
            difficulty=zero + HARD, exit=zero + M_RUNNING, trace=c.trace),
            (c.rho, cert_tol, inp.end_sub_tol, inp.end_tau_tol, p1, gap_ok,
             max_sub, inp.rank_flag_thres, armed, go),
            check_pinf_conv, high_acc_mode, refresh_every))
        mexit = m.exit
        oexit = torch.where(mexit == M_NUM_ERR, O_NUM_ERR, torch.where(
            mexit == M_PINF_CONV, O_DONE, O_LIMIT))
        umsc = torch.where(mexit == M_BUDGET, umsc + 1, umsc)
        phase_exit = (mexit == M_NUM_ERR) | (mexit == M_PINF_CONV)
        # UpdateRho do-while + history reset, skipped when the phase exits
        do_rho = go & ~phase_exit
        rho_n, grad, cert, _ = devloop.nest(_rho_loop(
            pd, m, c.rho, c.rho_factor, do_rho))
        hist = history_reset(m.hist, do_rho)
        # rho-factor damping thresholds (lorads_alm.c:1192-1205)
        rf, flag = c.rho_factor, c.rho_flag
        for thres, fl in ((5e4, 4), (5e6, 6), (5e8, 8)):
            hit = (rho_n >= thres) & (flag < fl)
            rf = torch.where(hit, rf ** 0.25, rf)
            flag = torch.where(hit, fl, flag)
        k_n = torch.where(phase_exit, c.k, c.k + 1)
        # init-mode fast termination (pre-DIMACS, lorads_alm.c:1208)
        if not reopt:
            oexit = torch.where((oexit == O_LIMIT)
                                & (m.pinf_l1 * pinf_scale <= p1) & gap_ok,
                                O_DONE, oexit)
        # objective/DIMACS refresh (updateDimacsALM + calObj); the fresh
        # constraint sum replaces the incremental one
        pobj = aop.obj_cached(pd, m.R, m.caches) / inp.scale_obj
        dobj = torch.dot(pd.rhs, m.dual) / inp.scale_obj
        total = aop.auv_cached(pd, m.R, m.caches)
        pinf = aop.primal_infeas_l1(pd, total)
        gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj)
                                        + torch.abs(dobj))
        pinf_inf = pinf * pinf_scale
        # reopt / strict termination (lorads_alm.c:755-780, 1246)
        if not reopt:
            term = (gap <= p1 * 1e-3) & (pinf <= p1 * 1e-3)
        elif early_stop:
            term = ((pinf <= p1) & (gap <= torch.maximum(p1, p2 * 5))
                    & (k_n - inp.k0 > 1))
        else:
            term = (gap <= p2) & (pinf <= p2) & (k_n - inp.k0 > 1)
        oexit = torch.where((oexit == O_LIMIT) & term, O_DONE, oexit)
        # rank augmentation trigger (lorads_alm.c:1227-1236)
        rank_flag = m.rank_flag
        if cones_ok:
            trig = (rank_flag >= inp.rank_flag_thres) & ~inp.is_rank_max
            rank_flag = torch.where(trig, 0, rank_flag)
            oexit = torch.where(trig & (k_n - LAST_OUTER_START >= 2)
                                & (oexit == O_LIMIT), O_RANK, oexit)
        rec = torch.stack([x.to(f64) for x in (
            k_n, m.total_inner, pobj, dobj, pinf, pinf_inf, gap, rho_n,
            mexit, m.tau)])
        logbuf = torch.where(go, c.logbuf.index_copy(
            0, c.n_done.reshape(1), rec.reshape(1, LOG_COLS)), c.logbuf)

        def s(new, old):
            return torch.where(go, new, old)
        return ALMCarry(
            R=m.R, grad=grad, hist=hist, caches=m.caches, dual=m.dual,
            constr_sum=s(total, c.constr_sum), cert_val=cert, rho=rho_n,
            rho_factor=s(rf, c.rho_factor), rho_flag=s(flag, c.rho_flag),
            k=s(k_n, c.k), max_sub=s(max_sub, c.max_sub),
            update_max_sub_counter=s(umsc, c.update_max_sub_counter),
            rank_flag=s(rank_flag, c.rank_flag),
            total_inner=c.total_inner + m.total_inner,
            pobj=s(pobj, c.pobj), dobj=s(dobj, c.dobj),
            pinf_l1=s(pinf, c.pinf_l1), pinf_inf=s(pinf_inf, c.pinf_inf),
            gap=s(gap, c.gap), tau=s(m.tau, c.tau), mexit=s(mexit, c.mexit),
            oexit=s(oexit, O_KMAX), n_done=c.n_done + go.to(c.n_done.dtype),
            last_inner=m.total_inner, logbuf=logbuf, trace=m.trace)

    def pack(inp, c):
        return torch.cat([torch.stack([getattr(c, f).to(f64)
                                       for f in PACK_F + PACK_I]),
                          c.logbuf.reshape(-1).to(f64)])

    return devloop.Loop(
        key=("alm_outer", devloop.ident(pd), reopt, high_acc_mode,
             early_stop, cones_ok, refresh_every),
        step=step, pack=pack, inputs=inputs, state=carry, label="alm",
        running=running)


def alm_start(pd: ProblemData, params, R: FactorVec, dual, hist,
              stats: ALMStats, scale_obj: float, is_rank_max: bool,
              rho_update_factor: float, max_sub: int, max_outers: int,
              max_alm_iter: int, trace: bool = False):
    """(the outer loop's carry at a phase's start, its inputs but the
    budget and grind_armed as a dict): the fresh gradient and
    certificate at (R, dual), the caches, the stats' rho, k and last
    DIMACS values (1e30 where unset), a log buffer of ``max_outers``
    rows, and with ``trace`` the FIX_INI buffer."""
    dt, dv = pd.rhs.dtype, pd.rhs.device
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)

    def f(v, dtype=dt):
        return devloop.scalar(v, dtype, dv)

    def i(v):
        return f(v, torch.int64)

    constr_sum, grad, cert_val = alm_recompute(pd, R, dual, stats.rho)
    pinf0 = stats.pinf_l1 if stats.pinf_l1 < 1e29 else 1e30
    carry = ALMCarry(
        R=R, grad=grad, hist=hist, caches=tuple(aop.gather_caches(pd, R)),
        dual=dual, constr_sum=constr_sum, cert_val=cert_val,
        rho=f(stats.rho), rho_factor=f(rho_update_factor), rho_flag=i(0),
        k=i(stats.outer_iter), max_sub=i(max_sub),
        update_max_sub_counter=i(0), rank_flag=i(0), total_inner=i(0),
        pobj=f(stats.pobj), dobj=f(stats.dobj), pinf_l1=f(pinf0),
        pinf_inf=f(pinf0 * pinf_scale),
        gap=f(stats.gap if stats.gap < 1e29 else 1e30), tau=f(0.0),
        mexit=i(M_RUNNING), oexit=i(O_LIMIT), n_done=i(0), last_inner=i(0),
        logbuf=torch.zeros((max_outers, LOG_COLS), dtype=torch.float64,
                           device=dv),
        trace=torch.zeros((MAX_SUB_CAP + PASS_CAP, 4), dtype=torch.float64,
                          device=dv) if trace else None)
    fixed = dict(
        scale_obj=f(scale_obj), k0=i(stats.outer_iter),
        max_alm_iter=i(max_alm_iter),
        rank_flag_thres=i(params.rank_flag_thres),
        is_rank_max=f(bool(is_rank_max), torch.bool),
        phase1_tol=f(params.phase1_tol), phase2_tol=f(params.phase2_tol),
        end_sub_tol=f(params.end_alm_sub_tol),
        end_tau_tol=f(params.end_tau_tol))
    return carry, fixed


@dataclasses.dataclass
class ALMResult:
    action: str   # "done" | "aug_rank" | "num_err" | "time_out" | "regrind"
    R: FactorVec
    dual: torch.Tensor
    hist: LBFGSHistory
    constr_sum: torch.Tensor
    # one outer needed >= GRIND_OUTER_THRESHOLD inner iterations
    super_outer: bool = False


def alm_optimize(pd: ProblemData, params, R: FactorVec, dual, hist,
                 stats: ALMStats, scale_obj: float, is_rank_max: bool,
                 rho_update_factor: float, time_solve_start: float,
                 solver_ctx, reopt: bool = False,
                 early_stop: bool = True,
                 max_alm_iter: Optional[int] = None,
                 log=print) -> ALMResult:
    """Full ALM phase: LORADS_ALMOptimize (init) and
    LORADS_ALMOptimize_reopt control flow, as runs of ``outer_loop`` of
    up to ``solver_ctx.alm_max_outers`` outers (1 with the FIX_INI
    trace), one read each.  ``solver_ctx`` carries the cross-call
    MAX_ALM_SUB_ITER global (lorads_alm.c:7) as ``max_alm_sub_iter``.
    The time limit and the grind escalation are checked after each run
    (the run stops on the device once the grind threshold is crossed)."""
    t0 = time.time()
    if max_alm_iter is None:
        max_alm_iter = params.max_alm_iter
    if not reopt:
        solver_ctx.max_alm_sub_iter = 5000
        rho_update_factor = (params.alm_rho_factor
                             if params.alm_rho_factor is not None
                             else 2.0)
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)
    trace = TRACE_FIX_INI
    max_outers = 1 if trace else getattr(solver_ctx, "alm_max_outers", 8)

    def i(v, dtype=torch.int64):
        return devloop.scalar(v, dtype, pd.rhs.device)

    carry, fixed = alm_start(pd, params, R, dual, hist, stats, scale_obj,
                             is_rank_max, rho_update_factor,
                             solver_ctx.max_alm_sub_iter, max_outers,
                             max_alm_iter, trace)
    cones_ok = True if not reopt else (pd.n_buckets <= 10)
    grind = (getattr(solver_ctx, "_lbfgs_auto", False)
             and solver_ctx.lbfgs_len < 4)

    def finalize(action: str) -> ALMResult:
        # before any outer has run (max_alm_iter=0 edge) recompute fresh
        if stats.pobj >= 1e29:
            _, (pobj, dobj, pinf, gap) = alm_obj_dimacs(pd, carry.R,
                                                        carry.dual,
                                                        scale_obj)
            stats.pobj, stats.dobj = pobj, dobj
            stats.pinf_l1, stats.gap = pinf, gap
            stats.pinf_inf = stats.pinf_l1 * pinf_scale
        log(f"Exit ALM: OuterIter:{stats.outer_iter} "
            f"InnerIter:{stats.inner_iter} pObj:{stats.pobj:5.5e} "
            f"dObj:{stats.dobj:5.5e} pInf(1):{stats.pinf_l1:5.5e} "
            f"pdGap:{stats.gap:5.5e} rho:{stats.rho:3.2f} "
            f"Time:{time.time() - t0:3.2f}")
        return ALMResult(action, carry.R, carry.dual, carry.hist,
                         carry.constr_sum)

    max_outer_inner = 0
    while True:
        # the device stops the run where the host's check below would
        # regrind: the phase's inner steps reaching the threshold
        budget = (max(1, GRIND_INNER_THRESHOLD - stats.inner_iter) if grind
                  else 2 ** 30)
        inputs = ALMInputs(budget=i(budget),
                           grind_armed=i(grind, torch.bool), **fixed)
        carry, out = devloop.run(outer_loop(
            pd, inputs, carry, reopt, params.high_acc_mode, early_stop,
            cones_ok))
        nf, ni = len(PACK_F), len(PACK_I)
        sc = dict(zip(PACK_F, out[:nf]))
        sc.update((k, int(v)) for k, v in zip(PACK_I, out[nf:nf + ni]))
        rows = [out[nf + ni + LOG_COLS * j: nf + ni + LOG_COLS * (j + 1)]
                for j in range(sc["n_done"])]
        if trace and sc["total_inner"]:
            for nrm, tau, ok, _ in dev.host_read(
                    carry.trace[:sc["total_inner"]], "alm"):
                print(f"nrm2U: {nrm:.20f}")
                if ok:
                    print(f"tau: {tau:.20f}")
        stats.rho = sc["rho"]
        solver_ctx.max_alm_sub_iter = sc["max_sub"]
        stats.pobj, stats.dobj = sc["pobj"], sc["dobj"]
        stats.pinf_l1, stats.pinf_inf = sc["pinf_l1"], sc["pinf_inf"]
        stats.gap, stats.tau = sc["gap"], sc["tau"]
        stats.outer_iter = sc["k"]
        for row in rows:
            stats.inner_iter += int(row[1])
            max_outer_inner = max(max_outer_inner, int(row[1]))
            log(f"ALM Outer:{int(row[0])} Inner:{stats.inner_iter} "
                f"pObj:{row[2]:5.5e} dObj:{row[3]:5.5e} "
                f"pInf(1):{row[4]:5.5e} pInf(Inf):{row[5]:5.5e} "
                f"pdGap:{row[6]:5.5e} rho:{row[7]:3.2f} "
                f"Time:{time.time() - t0:3.2f}")
            if int(row[8]) == M_TAU_SMALL:
                log(f"update rho since tau is too small: {row[9]:5.3e}")
        zero = i(0)
        carry = dataclasses.replace(carry, total_inner=zero, n_done=zero,
                                    last_inner=zero)

        oexit = sc["oexit"]
        super_outer = max_outer_inner >= GRIND_OUTER_THRESHOLD
        if oexit == O_NUM_ERR:
            return finalize("num_err")
        if oexit in (O_DONE, O_KMAX):
            return finalize("done")
        if oexit == O_RANK:
            return ALMResult("aug_rank", carry.R, carry.dual, carry.hist,
                             carry.constr_sum, super_outer=super_outer)
        if time.time() - time_solve_start >= params.time_sec_limit:
            return finalize("time_out")
        # ALM grind escalation (auto-history solves only): restart the
        # phase from the current iterate with L-BFGS history 4
        if grind and (stats.inner_iter >= GRIND_INNER_THRESHOLD
                      or super_outer):
            return ALMResult("regrind", carry.R, carry.dual, carry.hist,
                             carry.constr_sum, super_outer=super_outer)
