"""Phase I -- Augmented Lagrangian Method on the single factor R.

minimize  <C, RR^T> - lambda^T (A(RR^T) - b) + (rho/2) ||A(RR^T) - b||^2

by L-BFGS directions + exact quartic line search.  Port of
lorads_tpu/alg/alm.py.  lorads_tpu runs the inner, middle and outer
loops as device while_loops and fetches one packed vector per dispatch.
Here the inner L-BFGS loop is a ``devloop.Loop`` as well: its masked
step (direction, line search, update, exit test) stays on the device,
in graphed chunks of INNER_CHUNK steps on the card with one packed read
a chunk.  The middle and outer loops are Python loops that read their
conditions on the host (every read goes through ``device.host_read``
and is counted); their decisions are those of LORADS_ALMOptimize and
its reopt variant (lorads_alm.c:745-1255) in the same order, on Python
floats.

With ``TRACE_FIX_INI`` (set by the solver from
``LoradsParams.fix_init_point``) each inner step also writes its
direction norm, tau and its "accepted" and "ran" flags into its slot of
the chunk's state; the host prints them after the chunk's read, in step
order, for the steps that ran: ``nrm2U: %.20f`` every step and
``tau: %.20f`` every accepted step, as lorads_tpu's jax.debug.print
trace (alm.py:36-43, 171-189; lorads_alm.c:1081-1089, 1116-1118).

The outer loop hands control back to the host after every outer
iteration (lorads_tpu batches several per dispatch and sizes the batch
against a TPU worker's time limit, which the port does not need), so the
time-limit and grind checks run once per outer.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

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
# inner loop is built, and part of its key, so a graph of one setting is
# never replayed under the other.
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
                      caches=None):
    """lambda += rho (b - A(X)); then grad/cert at the new dual
    (lorads_alm.c:1151-1153)."""
    if caches is None:
        caches = aop.gather_caches(pd, R)
    dual_n = dual + rho * (pd.rhs - constr_sum)
    w = rho * (constr_sum - pd.rhs) - dual_n
    g = aop.grad_cached(pd, R, w, caches)
    return dual_n, g, aop.cert_value(pd, g)


def alm_update_rho_body(pd: ProblemData, R: FactorVec, dual, constr_sum,
                        rho, factor, grad0: FactorVec, caches=None):
    """do { rho *= factor; recompute grad } while (0.1/rho >= cert)
    (UpdateRho, lorads_alm.c:1174-1180) -> (rho, grad, cert float)."""
    if caches is None:
        caches = aop.gather_caches(pd, R)

    def body(rho_):
        rho_n = rho_ * factor
        w = rho_n * (constr_sum - pd.rhs) - dual
        g = aop.grad_cached(pd, R, w, caches)
        return rho_n, g, dev.host_read(aop.cert_value(pd, g), "other")

    rho_n, g, cert = body(rho)
    while 0.1 / rho_n >= cert:
        rho_n, g, cert = body(rho_n)
    return rho_n, g, cert


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


def _inner_step(pd: ProblemData, check_pinf_conv: bool, trace: bool = False):
    """The masked inner L-BFGS step and the loop's exit test
    (lorads_alm.c:1073-1150; lorads_tpu alm.py:150-233) ->
    (running, step): ``running(inputs, state)`` is the loop condition
    on the device; ``step(inputs, state, kind)`` one iteration, the
    state unchanged where the condition fails.  ``kind`` is ``refresh``
    (this step recomputes the caches and A(RR^T), every refresh_every
    steps), or with ``trace`` (refresh, j): the step also writes
    [||D||, tau, accepted, ran] into row j of the state's last tensor."""
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

    def step(inp, st, kind):
        dual, rho, _, _, end_tau_tol = inp[:5]
        refresh, j = kind if trace else (kind, None)
        R, grad, hist, caches, cs, cert, pinf, it, tau, num_err, \
            tau_small = st[:11]
        run = running(inp, st)
        hist = history_reset(hist, run & (it % 300 == 0))
        D = lbfgs_direction(hist, grad)
        q0 = pd.rhs - cs
        p1, q1, p2, q2, dcaches = aop.obj_and_auv_pair_cached(
            pd, R, D, caches)
        p1, q1 = 2.0 * p1, 2.0 * q1
        tau_n, num = alm_line_search(rho, dual, p1, p2, q0, q1, q2)
        err_n = num == 0
        small_n = ~err_n & (torch.abs(tau_n) < end_tau_tol)
        ok = run & ~err_n & ~small_n
        y0 = grad.scale(-1.0)
        Rn = R.axpy(tau_n, D)
        cs_inc = cs + tau_n * q1 + (tau_n * tau_n) * q2
        # A(RR^T) and the caches advance incrementally (exact in exact
        # arithmetic) and are recomputed every refresh_every steps for
        # fp hygiene (the reference recomputes each step,
        # lorads_alm.c:1128-1130)
        if refresh:
            can = aop.gather_caches(pd, Rn)
            total = aop.auv_cached(pd, Rn, can)
        else:
            can = aop.axpy_caches(caches, tau_n, dcaches)
            total = cs_inc
        w = rho * (cs_inc - pd.rhs) - dual
        gn = aop.grad_cached(pd, Rn, w, can)
        hist = history_push(hist, D.scale(tau_n), y0 + gn, ok)
        pinf_n = aop.primal_infeas_l1(pd, total)
        cert_n = aop.cert_value(pd, gn)
        sel = lambda a, b: torch.where(ok, a, b)  # noqa: E731
        fv = lambda a, b: FactorVec(  # noqa: E731
            tuple(map(sel, a.cones, b.cones)), sel(a.lp, b.lp))
        caches = tuple(c if c is None else aop.CRCache(sel(n.cr, c.cr))
                       for n, c in zip(can, caches))
        out = (fv(Rn, R), fv(gn, grad), hist, caches, sel(total, cs),
               sel(cert_n, cert), sel(pinf_n, pinf),
               it + run.to(it.dtype), torch.where(run, tau_n, tau),
               torch.where(run, err_n, num_err),
               torch.where(run, small_n, tau_small))
        if not trace:
            return out
        tr = st[11].clone()
        tr[j] = torch.stack([torch.sqrt(fv_norm2sq(D)), tau_n,
                             ok.to(tau_n.dtype), run.to(tau_n.dtype)]
                            ).to(tr.dtype)
        return out + (tr,)
    return running, step


def _print_trace(out, positions, K):
    """The FIX_INI lines of the steps at ``positions`` from a pack
    ``out`` (its slots after the loop's seven values)."""
    for p in positions:
        nrm, tau, ok, ran = out[7 + 4 * (p % K): 11 + 4 * (p % K)]
        if ran:
            print(f"nrm2U: {nrm:.20f}")
            if ok:
                print(f"tau: {tau:.20f}")


# ALM inner steps a chunk on the card, a divisor of the cache refresh
# period (25): the refresh then sits at a fixed position of one of two
# graphs (the history reset is a device select).  5 read faster on an
# H100 than 25 (PERF.md): an inner pass runs ~4-15 steps on Max-Cut and
# matrix completion, and a masked step past its exit costs as much
# device time as a real one.
INNER_CHUNK = 5


def inner_loop(pd: ProblemData, R: FactorVec, grad: FactorVec,
               hist: LBFGSHistory, dual, constr_sum, cert_val, rho,
               cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
               max_local, check_pinf_conv: bool = True,
               refresh_every: int = 25, caches=None) -> devloop.Loop:
    """The inner L-BFGS loop (lorads_alm.c:1073-1150) as a
    devloop.Loop: the scalars (rho, the tolerances, gap_ok, max_local;
    numbers or 0-d tensors) become device scalars, and with ``dual``
    the loop's inputs; the state carries R, the gradient, the history
    (device head and valid count), the caches, A(RR^T), cert, pinf and
    the step's it, tau, num_err and tau_small.  The history reset at
    it % 300 == 0 is a device select in the step.  The pack: (running,
    cert, pinf, it, tau, num_err, tau_small), and with TRACE_FIX_INI the
    chunk's [K, 4] trace slots, printed after each read."""
    if caches is None:
        caches = aop.gather_caches(pd, R)
    dt, dv = pd.rhs.dtype, pd.rhs.device

    def scalar(v, dtype=dt):
        return devloop.scalar(v, dtype, dv)

    trace, K = TRACE_FIX_INI, INNER_CHUNK
    running, step = _inner_step(pd, check_pinf_conv, trace)
    inputs = (dual, scalar(rho), scalar(cert_tol), scalar(end_sub_tol),
              scalar(end_tau_tol), scalar(phase1_tol),
              scalar(gap_ok, torch.bool), scalar(max_local, torch.int64))
    false = torch.zeros((), dtype=torch.bool, device=dv)
    state = (R, grad, hist, tuple(caches), constr_sum, scalar(cert_val),
             aop.primal_infeas_l1(pd, constr_sum),
             torch.zeros((), dtype=torch.int64, device=dv),
             torch.zeros((), dtype=dt, device=dv), false, false)
    if trace:
        state += (torch.zeros((K, 4), dtype=torch.float64, device=dv),)

    def pack(inp, st):
        out = torch.stack([x.to(torch.float64) for x in (
            running(inp, st), st[5], st[6], st[7], st[8], st[9], st[10])])
        return torch.cat([out, st[11].reshape(-1)]) if trace else out

    def kind(it):
        refresh = it % refresh_every == refresh_every - 1
        return (refresh, it % K) if trace else refresh

    return devloop.Loop(
        key=("alm_inner", devloop.ident(pd), check_pinf_conv,
             refresh_every, trace),
        step=step, pack=pack, inputs=inputs, state=state, K=K,
        label="alm_inner", kind=kind,
        on_read=(lambda out, pos: _print_trace(out, pos, K)) if trace
        else None)


def _inner_loop(pd: ProblemData, R: FactorVec, grad: FactorVec,
                hist: LBFGSHistory, dual, constr_sum, cert_val, rho,
                cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
                max_local, check_pinf_conv: bool = True,
                refresh_every: int = 25, caches=None):
    """The inner L-BFGS loop (lorads_alm.c:1073-1150), run to its exit.

    Exits when: certificate satisfied, local iteration cap, tau too
    small, line-search failure, or (init phase only) primal
    infeasibility below phase1Tol.  ``caches`` hold CR = C @ R; per
    iteration only C @ D is computed and the caches advance by tau,
    with a fresh recompute every ``refresh_every`` steps.  On the card
    the steps run in graphed chunks of INNER_CHUNK, one host read each
    (label ``alm_inner``).  Returns (R, grad, hist, constr_sum, info,
    caches), info's values host numbers from the last read.
    """
    st, out = devloop.run(inner_loop(
        pd, R, grad, hist, dual, constr_sum, cert_val, rho, cert_tol,
        end_sub_tol, end_tau_tol, phase1_tol, gap_ok, max_local,
        check_pinf_conv, refresh_every, caches))
    R, grad, hist, caches, constr_sum = st[:5]
    info = dict(cert_val=out[1], pinf_l1=out[2], local_iter=int(out[3]),
                tau=out[4], num_err=bool(out[5]), tau_small=bool(out[6]))
    return R, grad, hist, constr_sum, info, caches


# Exit codes of the middle loop (one ALM outer iteration's L-BFGS
# passes; mirrors the host control flow of LORADS_ALMOptimize,
# lorads_alm.c:1040-1171).
M_RUNNING, M_EASY, M_CERT_TOL, M_EMA_STOP, M_BUDGET, M_RANK, \
    M_NUM_ERR, M_TAU_SMALL, M_PINF_CONV, M_NO_IMPROVE = range(10)


def _middle_and_rho(pd: ProblemData, R: FactorVec, grad: FactorVec,
                    hist: LBFGSHistory, caches, dual, constr_sum,
                    cert_val, rho, cert_tol, end_sub_tol, end_tau_tol,
                    phase1_tol, gap_ok, max_sub_iter, rank_flag,
                    rank_flag_thres, rank_trigger_armed,
                    rho_update_factor, pinf_l1_init,
                    check_pinf_conv: bool = True,
                    high_acc_mode: bool = False):
    """One ALM outer iteration: the middle loop of L-BFGS passes
    (difficulty grading, EMA stagnation, certificate and budget checks,
    dual ascent per pass) followed -- unless the phase exits -- by the
    rho escalation do-while (UpdateRho) and a history reset.

    Returns (state dict, new rho)."""
    c = dict(R=R, grad=grad, hist=hist, dual=dual, constr_sum=constr_sum,
             caches=caches, cert_val=float(cert_val),
             pinf_l1=float(pinf_l1_init), tau=0.0, best_cert=math.inf,
             no_improve=0, iter_counter=1, total_inner=0,
             rank_flag=int(rank_flag), difficulty=HARD, exit=M_RUNNING)
    ema = EmaDetector()
    while c["difficulty"] != EASY and c["exit"] == M_RUNNING:
        # --- pre-pass checks, in host order ---
        improved = c["cert_val"] < c["best_cert"] * 0.99
        c["best_cert"] = c["cert_val"] if improved else c["best_cert"]
        c["no_improve"] = 0 if improved else c["no_improve"] + 1
        ema_go = ema.update(c["cert_val"])

        exit_ = M_RUNNING
        if c["no_improve"] >= 3:
            exit_ = M_NO_IMPROVE
        elif not high_acc_mode and not ema_go:
            exit_ = M_EMA_STOP
        elif c["iter_counter"] >= max_sub_iter:
            exit_ = M_BUDGET
        elif rank_trigger_armed and c["rank_flag"] >= rank_flag_thres:
            exit_ = M_RANK
        elif c["cert_val"] <= cert_tol:
            exit_ = M_CERT_TOL
        if exit_ != M_RUNNING:
            c["exit"] = exit_
            continue

        R1, g1, h1, cs1, info, ca1 = _inner_loop(
            pd, c["R"], c["grad"], c["hist"], c["dual"], c["constr_sum"],
            c["cert_val"], rho, cert_tol, end_sub_tol, end_tau_tol,
            phase1_tol, gap_ok, 801, check_pinf_conv=check_pinf_conv,
            caches=c["caches"])
        local = info["local_iter"]
        exit2 = M_RUNNING
        if info["num_err"]:
            exit2 = M_NUM_ERR
        elif info["tau_small"]:
            exit2 = M_TAU_SMALL
        elif check_pinf_conv and gap_ok and (
                info["pinf_l1"] * (1.0 + pd.b_nrm1)
                / (1.0 + pd.b_nrm_inf) <= phase1_tol):
            exit2 = M_PINF_CONV
        # dual ascent + fresh gradient (lorads_alm.c:1151-1153), skipped
        # when the pass breaks first (num_err / tau_small / converged)
        dual_n, g2, cert2 = c["dual"], g1, info["cert_val"]
        if exit2 == M_RUNNING:
            dual_n, g2, cert2 = alm_dual_and_grad(pd, R1, c["dual"], cs1,
                                                  rho, caches=ca1)
            cert2 = dev.host_read(cert2, "other")
        # difficulty grading (lorads_alm.c:1154-1171); reopt grades
        # SUPER as HARD
        difficulty = (EASY if local <= 20 else MEDIUM if local <= 100
                      else HARD if local < 400 else SUPER)
        if not check_pinf_conv:
            difficulty = min(difficulty, HARD)
        rank_inc = (0 if local <= 20 else 2 if local <= 100
                    else 3 if difficulty == HARD else 4)
        # EASY resets the flag; grading only on a normally completed pass
        if exit2 == M_RUNNING:
            c["rank_flag"] = 0 if local <= 20 else c["rank_flag"] + rank_inc
        c.update(R=R1, grad=g2, hist=h1, caches=ca1, constr_sum=cs1,
                 dual=dual_n, cert_val=cert2, pinf_l1=info["pinf_l1"],
                 tau=info["tau"], iter_counter=c["iter_counter"] + local,
                 total_inner=c["total_inner"] + local,
                 difficulty=difficulty, exit=exit2)

    # UpdateRho do-while + history reset, skipped when the phase exits
    rho_out = rho
    if c["exit"] not in (M_NUM_ERR, M_PINF_CONV):
        rho_out, g, cert = alm_update_rho_body(
            pd, c["R"], c["dual"], c["constr_sum"], rho, rho_update_factor,
            c["grad"], caches=c["caches"])
        c.update(grad=g, cert_val=cert, hist=history_reset(c["hist"]))
    return c, rho_out


# Outer exit codes.
O_LIMIT, O_DONE, O_NUM_ERR, O_RANK, O_KMAX = range(5)

# ALM grind escalation threshold (auto-history solves): cumulative
# inner iterations in one init ALM phase beyond which the solver
# restarts the phase with L-BFGS history 4 (see alm_optimize).
GRIND_INNER_THRESHOLD = 6000
# single-outer grind symptom: one outer's middle loop needing this many
# L-BFGS iterations
GRIND_OUTER_THRESHOLD = 1500


class EmaDetector:
    """Reference LUtilUpdateCheckEma (lorads_utils.c:404-434)."""

    def __init__(self, alpha=0.1, threshold=0.005, interval=5):
        self.alpha = alpha
        self.threshold = threshold
        self.interval = interval
        self.current = 0.0
        self.old = 0.0
        self.counter = 1

    def update(self, value: float) -> bool:
        result = True
        self.current = self.alpha * value + (1 - self.alpha) * self.current
        if self.counter >= self.interval:
            if self.old != 0.0:
                change = (self.current - self.old) / self.old
                result = -self.threshold <= change <= self.threshold
            self.old = self.current
            self.counter = 1
        else:
            self.counter += 1
        return result


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
    LORADS_ALMOptimize_reopt control flow.  ``solver_ctx`` carries the
    cross-call MAX_ALM_SUB_ITER global (lorads_alm.c:7) as
    ``max_alm_sub_iter``."""
    t0 = time.time()
    if max_alm_iter is None:
        max_alm_iter = params.max_alm_iter
    if not reopt:
        solver_ctx.max_alm_sub_iter = 5000
        rho_update_factor = (params.alm_rho_factor
                             if params.alm_rho_factor is not None
                             else 2.0)
    high_acc = params.high_acc_mode
    phase1_tol, phase2_tol = params.phase1_tol, params.phase2_tol
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)
    update_max_sub_counter = 0
    last_outer_start = 1
    rank_flag = 0
    rank_flag_thres = params.rank_flag_thres
    rho_factor_flag = 0
    k0 = stats.outer_iter
    k = stats.outer_iter

    constr_sum, grad, cert_val = alm_recompute(pd, R, dual, stats.rho)
    cert_val = dev.host_read(cert_val, "other")
    caches = aop.gather_caches(pd, R)

    def finalize(action: str) -> ALMResult:
        # before any outer has run (max_alm_iter=0 edge) recompute fresh
        if stats.pobj >= 1e29:
            _, (pobj, dobj, pinf, gap) = alm_obj_dimacs(pd, R, dual,
                                                        scale_obj)
            stats.pobj, stats.dobj = pobj, dobj
            stats.pinf_l1, stats.gap = pinf, gap
            stats.pinf_inf = stats.pinf_l1 * pinf_scale
        log(f"Exit ALM: OuterIter:{stats.outer_iter} "
            f"InnerIter:{stats.inner_iter} pObj:{stats.pobj:5.5e} "
            f"dObj:{stats.dobj:5.5e} pInf(1):{stats.pinf_l1:5.5e} "
            f"pdGap:{stats.gap:5.5e} rho:{stats.rho:3.2f} "
            f"Time:{time.time() - t0:3.2f}")
        return ALMResult(action, R, dual, hist, constr_sum)

    cones_ok = True if not reopt else (pd.n_buckets <= 10)
    max_sub = solver_ctx.max_alm_sub_iter
    gap = stats.gap if stats.gap < 1e29 else 1e30
    pinf = stats.pinf_l1 if stats.pinf_l1 < 1e29 else 1e30
    pinf_inf = pinf * pinf_scale
    max_outer_inner = 0
    while True:
        # ---- loop-top break (k budget) ----
        gap_brk = (gap <= max(phase1_tol, phase2_tol * 5)) if high_acc \
            else True
        if k > max_alm_iter and (not reopt or (pinf_inf <= phase1_tol
                                               and gap_brk)):
            return finalize("done")

        # max_alm_sub_iter adaptation (lorads_alm.c:1044-1049)
        if update_max_sub_counter >= 2:
            update_max_sub_counter = 0
            max_sub = min(max_sub + 10000, 25000)
        gap_ok = True if not high_acc else gap <= phase1_tol
        armed = (not is_rank_max) and (k - last_outer_start >= 3)
        m, rho_n = _middle_and_rho(
            pd, R, grad, hist, caches, dual, constr_sum, cert_val,
            stats.rho, 0.1 / stats.rho, params.end_alm_sub_tol,
            params.end_tau_tol, phase1_tol, gap_ok, max_sub, rank_flag,
            rank_flag_thres, armed, rho_update_factor, pinf,
            check_pinf_conv=not reopt, high_acc_mode=high_acc)
        mexit = m["exit"]
        oexit = O_LIMIT
        if mexit == M_NUM_ERR:
            oexit = O_NUM_ERR
        elif mexit == M_PINF_CONV:
            oexit = O_DONE
        if mexit == M_BUDGET:
            update_max_sub_counter += 1
        phase_exit = mexit in (M_NUM_ERR, M_PINF_CONV)

        # rho-factor damping thresholds (lorads_alm.c:1192-1205)
        for thres, flag in ((5e4, 4), (5e6, 6), (5e8, 8)):
            if rho_n >= thres and rho_factor_flag < flag:
                rho_update_factor = rho_update_factor ** 0.25
                rho_factor_flag = flag

        k = k if phase_exit else k + 1
        # init-mode fast termination (pre-DIMACS, lorads_alm.c:1208)
        if (not reopt and oexit == O_LIMIT
                and m["pinf_l1"] * pinf_scale <= phase1_tol and gap_ok):
            oexit = O_DONE

        # objective/DIMACS refresh (updateDimacsALM + calObj); the fresh
        # constraint sum replaces the incremental one
        R, caches = m["R"], m["caches"]
        grad, hist, dual = m["grad"], m["hist"], m["dual"]
        cert_val = m["cert_val"]
        total = aop.auv_cached(pd, R, caches)
        pobj, dobj, pinf = dev.host_read(torch.stack([
            aop.obj_cached(pd, R, caches) / scale_obj,
            torch.dot(pd.rhs, dual) / scale_obj,
            aop.primal_infeas_l1(pd, total)]), "other")
        gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
        pinf_inf = pinf * pinf_scale
        constr_sum = total

        # reopt / strict termination (lorads_alm.c:755-780, 1246)
        if reopt:
            if early_stop:
                term = (pinf <= phase1_tol
                        and gap <= max(phase1_tol, phase2_tol * 5)
                        and k - k0 > 1)
            else:
                term = (gap <= phase2_tol and pinf <= phase2_tol
                        and k - k0 > 1)
        else:
            term = gap <= phase1_tol * 1e-3 and pinf <= phase1_tol * 1e-3
        if oexit == O_LIMIT and term:
            oexit = O_DONE

        # rank augmentation trigger (lorads_alm.c:1227-1236)
        rank_flag = m["rank_flag"]
        if cones_ok and rank_flag >= rank_flag_thres and not is_rank_max:
            rank_flag = 0
            if k - last_outer_start >= 2 and oexit == O_LIMIT:
                oexit = O_RANK

        stats.rho = rho_n
        solver_ctx.max_alm_sub_iter = max_sub
        stats.inner_iter += m["total_inner"]
        stats.pobj, stats.dobj = pobj, dobj
        stats.pinf_l1, stats.pinf_inf, stats.gap = pinf, pinf_inf, gap
        stats.tau = m["tau"]
        stats.outer_iter = k
        max_outer_inner = max(max_outer_inner, m["total_inner"])
        log(f"ALM Outer:{k} Inner:{stats.inner_iter} "
            f"pObj:{pobj:5.5e} dObj:{dobj:5.5e} "
            f"pInf(1):{pinf:5.5e} pInf(Inf):{pinf_inf:5.5e} "
            f"pdGap:{gap:5.5e} rho:{rho_n:3.2f} "
            f"Time:{time.time() - t0:3.2f}")
        if mexit == M_TAU_SMALL:
            log(f"update rho since tau is too small: {stats.tau:5.3e}")

        super_outer = max_outer_inner >= GRIND_OUTER_THRESHOLD
        if oexit == O_NUM_ERR:
            return finalize("num_err")
        if oexit == O_DONE:
            return finalize("done")
        if oexit == O_RANK:
            return ALMResult("aug_rank", R, dual, hist, constr_sum,
                             super_outer=super_outer)
        if time.time() - time_solve_start >= params.time_sec_limit:
            return finalize("time_out")
        # ALM grind escalation (auto-history solves only): restart the
        # phase from the current iterate with L-BFGS history 4
        if (getattr(solver_ctx, "_lbfgs_auto", False)
                and solver_ctx.lbfgs_len < 4
                and (stats.inner_iter >= GRIND_INNER_THRESHOLD
                     or super_outer)):
            return ALMResult("regrind", R, dual, hist, constr_sum,
                             super_outer=super_outer)
