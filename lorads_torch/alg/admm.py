"""Phase II -- ADMM splitting on X = U V^T.

Port of lorads_tpu/alg/admm.py.  Per iteration (LORADSADMMOptimize,
lorads_admm.c:33-157): for each bucket the U-update then the V-update,
then the LP columns (U then V), objective + DIMACS at X_bar = (U+V)/2
(which also REPLACES the constraint-value caches with
A(X_bar X_bar^T), as the reference does), dual ascent at X_bar, rho
schedule with the stagnation escape, divergence and bad_pd guards.

Order of the sweep, as in lorads_tpu: buckets in sequence; the blocks
of a bucket of several blocks one after another (the bucket
Gauss-Seidel scan, ``_update_sdp_var_bucket_gs``, over
``pattern.bucket_slice`` views) unless the solver marks the bucket
Jacobi (its blocks touch disjoint constraints, so updating them at once
is the same update); the LP columns in closed form, all at once
(Jacobi) or in order with ``lp_gauss_seidel`` (kernel K8c).

Each side's subproblem (I + N) x = rhs, N the normal operator of the
fixed factor, is solved

* on diag-identity cones (Max-Cut) in closed form: N is row-decoupled
  and each row solves by Sherman-Morrison (no CG);
* otherwise by matrix-free CG (alg/cg.py), mixed-precision by default
  (``admm_mixed_cg``: f32 sweeps on the bucket's f32 cast, f64 true
  residuals).  The operator is x + W(x) @ F with W(x) = A^*(A(sym(x F^T)))
  -- kernel K6 when every off constraint owns a slot (a_off_unique),
  K7a on dense buckets with single-entry or diagonal-only constraints
  (a_single_dense), else uvt -> constr_vals -> build_w (K4) -- and the
  product w_mul (K5, or torch.matmul on dense buckets).

lorads_tpu runs up to ``n_steps`` iterations per device dispatch; here
``admm_chunk`` runs them as a Python loop and reads the four DIMACS
scalars of each iteration to the host (one counted read), where the
status, rho schedule and stall detectors run on Python floats.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lorads_torch import device as dev
from lorads_torch.alg import aop
from lorads_torch.alg.aop import ProblemData
from lorads_torch.alg.cg import cg_solve, cg_solve_ir
from lorads_torch.alg.state import FactorVec
from lorads_torch.ops import kernels
from lorads_torch.ops import lp as lp_ops
from lorads_torch.ops import pattern as pat

# exit codes of a chunk
RUNNING, CONVERGED, NUM_ERR, BAD_PD, EARLY_STOP, STALLED = 0, 1, 2, 3, 4, 5

# Phase-II pinf exit margin: converge to 0.95*tol instead of 1.00*tol so
# the reported pinf never rides the acceptance band's edge.
EXIT_MARGIN = 0.95


@dataclasses.dataclass
class ADMMStats:
    """Host mirror of lorads_admm_state (def_lorads_solver.h)."""

    rho: float
    iter: int = 0
    cg_iter: int = 0
    pobj: float = 1e30
    dobj: float = 1e30
    pinf_l1: float = 1e30
    pinf_inf: float = 1e30
    gap: float = 1e30
    dinf_l1: float = 1e30
    dinf_inf: float = 1e30


# Per-chunk CG budgets (admm.py:494-505): the chunk returns to the host
# once its cumulative CG count crosses the budget
CG_BUDGET_MIXED = 24000
CG_BUDGET_F64 = 4000
# the CG iteration cap of every solve (admm.py:519)
CG_MAX_ITER = 800


def _admm_cache(bk: pat.BucketData, x):
    """ADMM cache of one factor: C @ X for diag-identity cones (the
    closed-form update's W @ X is C @ X + (a .* w) .* X); None for every
    other bucket (the port keeps no gathered-row caches)."""
    if aop._diag_fast(bk):
        return aop.CRCache(pat.cmul(bk, x))
    return pat.gather_cache(bk, x)


def _cg_operator(bk, F: torch.Tensor):
    """x -> x + A^*(A(sym(x F^T))) @ F, the CG operator of one side
    (linSysProduct, lorads_admm.c:376-391; admm.py:154-170): kernel K6
    on split buckets whose off constraints own their slots, K7a on
    dense buckets whose constraints are single-entry or diagonal-only,
    else A(.) then A^*(.)."""
    def op(x):
        if bk.dense and bk.a_single_dense:
            Wop = pat.a_adj_a_dense(bk, pat.uvt_half_cached(bk, x, F, None))
        elif bk.a_off_unique:
            Wop = pat.a_adj_a(bk, x, F)
        else:
            vals = pat.cone_total(bk, pat.constr_vals(bk, pat.uvt(bk, x, F)))
            Wop = pat.build_w(bk, vals, include_obj=False)
        return x + pat.w_mul(bk, Wop, F)
    return op


def _update_sdp_var_one(pd: ProblemData, bk: pat.BucketData, update_var,
                        fixed_var, local_vals, constr_sum, dual, rho,
                        cg_tol=1e-8, fcache=None, bk_lo=None):
    """One side of the splitting for one bucket (LORADSUpdateSDPVarOne,
    lorads_admm.c:428-480): solve (I + N) x = rhs for U with V fixed.

    Diag-identity cones make the normal system row-decoupled,
    N(x)_i = a_i^2 (x_i . v_i) v_i, so each row solves
    (I + a_i^2 v_i v_i^T) x_i = rhs_i exactly by Sherman-Morrison, with
    W @ V = C @ V (``fcache``) + (a .* w) .* V.  Other cones form
    W = C + A^*(w) (K4) and W @ V (K5), and solve by CG to ``cg_tol``
    (at most CG_MAX_ITER iterations); with ``bk_lo`` (the bucket's f32
    cast) the CG is the mixed-precision cg_solve_ir.
    Returns (new_var, new_local_vals, new_constr_sum, cg_iters,
    new_cache)."""
    base = rho * (constr_sum - pd.rhs) - dual
    w_loc = pat.gather_w(bk, base) - rho * pat.cone_total(bk, local_vals)
    if aop._diag_fast(bk):
        if fcache is None:
            fcache = _admm_cache(bk, fixed_var)
        rhs = -(fcache.cr + (bk.a_val_d * w_loc)[:, :, None] * fixed_var
                - rho * fixed_var) / rho
        a2 = bk.a_val_d * bk.a_val_d
        vr = torch.sum(fixed_var * rhs, -1)
        vv = torch.sum(fixed_var * fixed_var, -1)
        coef = a2 * vr / (1.0 + a2 * vv)
        new_var = rhs - coef[..., None] * fixed_var
        iters = 0
        new_local = bk.a_val_d * torch.sum(new_var * fixed_var, -1)
    else:
        W = pat.build_w(bk, w_loc)                        # C + A*(M1)
        rhs = -(pat.w_mul(bk, W, fixed_var) - rho * fixed_var) / rho
        op = _cg_operator(bk, fixed_var)
        if bk_lo is not None:
            op_lo = _cg_operator(bk_lo, fixed_var.to(torch.float32))
            new_var, iters = cg_solve_ir(op, op_lo, update_var, rhs,
                                         cg_tol, CG_MAX_ITER)
        else:
            new_var, iters = cg_solve(op, update_var, rhs, cg_tol,
                                      CG_MAX_ITER)
        new_local = pat.constr_vals(bk, pat.uvt(bk, new_var, fixed_var))
    new_sum = constr_sum + pat.scatter_constr(bk, new_local - local_vals)
    return new_var, new_local, new_sum, iters, _admm_cache(bk, new_var)


def _update_lp_var(pd: ProblemData, upd, fixed, lp_contrib, constr_sum,
                   dual, rho):
    """Closed-form LP column updates, Jacobi over the columns
    (LORADSUpdateLPVarOne, lorads_admm.c:595-628; admm.py:211-236):
    wsum_j = c_j + a_j^T (rho (csum - b) - lambda) - rho ||a_j||^2 u_j v_j,
    the last term removing column j's own contribution.  ``lp_contrib``
    is the cached A_lp(uv).  Returns (new u, new A_lp(u v), new
    constr_sum)."""
    lpd = pd.lp
    base_w = rho * (constr_sum - pd.rhs) - dual
    base = lp_ops.adjoint_cols(lpd, base_w)
    corr = rho * lpd.col_nrm2sq * upd * fixed
    wsum = lpd.obj + base - corr
    m2 = wsum * fixed - rho * fixed
    new = (-m2 / rho) / (1.0 + lpd.col_nrm2sq * fixed * fixed)
    new_contrib = lp_ops.constr_vals(lpd, new * fixed)
    return new, new_contrib, constr_sum + new_contrib - lp_contrib


def _update_lp_var_gs(pd: ProblemData, upd, fixed, lp_contrib, constr_sum,
                      dual, rho):
    """The same closed form swept over the columns in order, each
    reading the constr_sum the previous columns updated
    (lorads_admm.c:595-628 driven by lorads_alg_common.c:229-247;
    admm.py:238-276): kernel K8c.  Returns as _update_lp_var."""
    lpd = pd.lp
    new, new_sum = kernels.lp_gs_sweep(
        lpd.pc_con, lpd.pc_val, lpd.obj, lpd.col_nrm2sq, upd, fixed,
        constr_sum, pd.rhs, dual, rho)
    return new, lp_ops.constr_vals(lpd, new * fixed), new_sum


def _update_sdp_var_bucket_gs(pd: ProblemData, slices, slices_lo, upd,
                              fixed, local_vals, constr_sum, dual, rho,
                              cg_tol):
    """One side of the splitting over a bucket's blocks in sequence, each
    block seeing the constr_sum the previous ones updated -- the
    reference's sweep (lorads_alg_common.c:190-214; admm.py:279-299,
    a lax.scan there, a host loop over ``slices`` here, the
    bucket_slice views of each block).  Returns (new_var [B, n, r],
    new_local_vals [B, m_loc], new_constr_sum, cg_iters, None)."""
    new_var, new_local, iters = [], [], 0
    for b, bk1 in enumerate(slices):
        u1, loc1, constr_sum, it, _ = _update_sdp_var_one(
            pd, bk1, upd[b:b + 1], fixed[b:b + 1], local_vals[b:b + 1],
            constr_sum, dual, rho, cg_tol,
            bk_lo=None if slices_lo is None else slices_lo[b])
        new_var.append(u1)
        new_local.append(loc1)
        iters += it
    return (torch.cat(new_var), torch.cat(new_local), constr_sum, iters,
            None)


def sweep_plan(pd: ProblemData, jacobi=(), mixed: bool = False):
    """What a sweep needs per bucket, built once per ADMM phase:
    (buckets_lo, slices, slices_lo).  ``jacobi``: per-bucket flags (a
    missing flag is False); a bucket of several blocks that is not
    Jacobi gets its block slices (bucket_slice) for the Gauss-Seidel
    scan, and, with the mixed-precision CG, their f32 casts."""
    lo = tuple(None if (not mixed or aop._diag_fast(bk))
               else pat.cast_floats(bk, torch.float32)
               for bk in pd.buckets)
    slices, slices_lo = [], []
    for j, bk in enumerate(pd.buckets):
        jac = j < len(jacobi) and bool(jacobi[j])
        if jac or bk.B == 1:
            slices.append(None)
            slices_lo.append(None)
            continue
        slices.append(tuple(pat.bucket_slice(bk, b) for b in range(bk.B)))
        slices_lo.append(None if lo[j] is None else tuple(
            pat.bucket_slice(lo[j], b) for b in range(bk.B)))
    return (lo if mixed else None), tuple(slices), tuple(slices_lo)


def admm_update_all(pd: ProblemData, U: FactorVec, V: FactorVec, locals_,
                    constr_sum, dual, rho, u_caches=None, v_caches=None,
                    cg_tol=1e-8, buckets_lo=None, slices=None,
                    slices_lo=None, lp_gs=False):
    """One sweep: each bucket U then V, then the LP columns U then V
    (LORADSUpdateSDPVar / LORADSUpdateSDPLPVar,
    lorads_alg_common.c:187-248; admm.py:302-368).  ``locals_`` holds
    one [B, m_loc] tensor per bucket and, with an LP block, its [m]
    contribution A_lp(uv) last.  ``buckets_lo``: the buckets' f32 casts
    for the mixed-precision CG; ``slices`` / ``slices_lo``: per bucket
    its block slices (sweep_plan) for the Gauss-Seidel scan, None for
    a bucket updated at once; ``lp_gs``: the LP columns in order (K8c).
    Returns (U, V, locals, constr_sum, u_caches, v_caches, cg_iters)."""
    nb = len(pd.buckets)
    u_cones, v_cones = list(U.cones), list(V.cones)
    locals_ = list(locals_)
    u_caches = list(u_caches) if u_caches is not None else [None] * nb
    v_caches = list(v_caches) if v_caches is not None else [None] * nb
    lo = buckets_lo if buckets_lo is not None else [None] * nb
    slices = slices if slices is not None else [None] * nb
    slices_lo = slices_lo if slices_lo is not None else [None] * nb
    cg_total = 0
    for j, bk in enumerate(pd.buckets):
        if slices[j] is None:
            u_new, loc, constr_sum, it1, uc = _update_sdp_var_one(
                pd, bk, u_cones[j], v_cones[j], locals_[j], constr_sum,
                dual, rho, cg_tol, fcache=v_caches[j], bk_lo=lo[j])
            v_new, loc, constr_sum, it2, vc = _update_sdp_var_one(
                pd, bk, v_cones[j], u_new, loc, constr_sum, dual, rho,
                cg_tol, fcache=uc, bk_lo=lo[j])
        else:
            u_new, loc, constr_sum, it1, uc = _update_sdp_var_bucket_gs(
                pd, slices[j], slices_lo[j], u_cones[j], v_cones[j],
                locals_[j], constr_sum, dual, rho, cg_tol)
            v_new, loc, constr_sum, it2, vc = _update_sdp_var_bucket_gs(
                pd, slices[j], slices_lo[j], v_cones[j], u_new, loc,
                constr_sum, dual, rho, cg_tol)
        u_cones[j], v_cones[j] = u_new, v_new
        u_caches[j], v_caches[j] = uc, vc
        locals_[j] = loc
        cg_total += it1 + it2
    lp_u, lp_v = U.lp, V.lp
    if pd.lp is not None:
        upd_fn = _update_lp_var_gs if lp_gs else _update_lp_var
        lp_u, lpc, constr_sum = upd_fn(pd, lp_u, lp_v, locals_[nb],
                                       constr_sum, dual, rho)
        lp_v, lpc, constr_sum = upd_fn(pd, lp_v, lp_u, lpc, constr_sum,
                                       dual, rho)
        locals_[nb] = lpc
    return (FactorVec(tuple(u_cones), lp_u), FactorVec(tuple(v_cones), lp_v),
            tuple(locals_), constr_sum, tuple(u_caches), tuple(v_caches),
            cg_total)


def _obj_dimacs_xbar(pd: ProblemData, U: FactorVec, V: FactorVec, dual,
                     scale, u_caches=None, v_caches=None):
    """pObj/dObj/pinf/gap at X_bar = (U+V)/2 as device scalars, plus the
    refreshed locals (with the LP's A_lp(uv) last) and total
    (calObj_admm + updateDimacsADMM, lorads_admm.c:79-81).  With U's and
    V's caches, X_bar's is their mean (C @ . is linear); buckets without
    caches take sym(RR^T) on the pattern (kernel K3)."""
    R = U.average(V)
    if u_caches is not None and v_caches is not None:
        xcaches = tuple(
            _admm_cache(bk, Rb) if uc is None or vc is None
            else aop.CRCache(0.5 * (uc.cr + vc.cr))
            for bk, Rb, uc, vc in zip(pd.buckets, R.cones, u_caches,
                                      v_caches))
        pobj, locals_, total = aop.obj_and_auv_cached(pd, R, xcaches)
    else:
        pobj, locals_, total = aop.obj_and_auv(pd, R, R)
    if pd.lp is not None:
        locals_ = locals_ + (lp_ops.constr_vals(pd.lp, R.lp * R.lp),)
    pobj = pobj / scale
    dobj = torch.dot(pd.rhs, dual) / scale
    pinf = aop.primal_infeas_l1(pd, total)
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return pobj, dobj, pinf, gap, locals_, total


def admm_init_eval(pd: ProblemData, U: FactorVec, V: FactorVec, dual,
                   scale):
    """Entry evaluation (lorads_admm.c:47-58): (locals, total,
    [pObj, dObj, pinf_l1, gap] host floats)."""
    pobj, dobj, pinf, gap, locals_, total = _obj_dimacs_xbar(
        pd, U, V, dual, scale)
    return locals_, total, dev.host_read(torch.stack([pobj, dobj, pinf,
                                                      gap]))


def admm_chunk(params, pd: ProblemData, c: dict, scale: float,
               iter_celling: int, n_steps: int, reopt: bool = False,
               gap_stop: bool = False, jacobi=()) -> dict:
    """Up to ``n_steps`` ADMM iterations (lorads_tpu's _make_admm_chunk
    body).  ``c`` carries the device tensors U, V, locals, constr_sum,
    dual and the host state rho, cur_rho_max, pinf_buf (10 floats),
    old_pinf_mean, bad_pd, it, pinf_l1, gap, pobj, dobj, best_gap,
    since_best, best_pinf, since_pinf; returns the updated carry with
    ``status``, ``pinf_inf``, ``cg_iter`` (this chunk's CG iterations)
    and ``plan`` (sweep_plan, built on the phase's first chunk and kept).
    ``jacobi``: per-bucket flags, True for a bucket whose blocks update
    at once (LoradsParams.admm_jacobi sets them all).  The chunk also
    returns once its CG count crosses the per-chunk budget.

    ``reopt`` tightens the bad_pd limit, shifts the rho schedule and
    converges on pinf_l1; ``gap_stop`` is the gap-continuation variant
    (convergence also needs gap <= tol, the stall detector watches the
    gap alone)."""
    tol2, tol1 = params.phase2_tol, params.phase1_tol
    rho_freq, rho_factor = params.rho_freq, params.rho_factor
    escape_pow = float(rho_factor ** round(
        math.log(rho_freq * 100) / math.log(rho_freq)))
    bad_pd_limit = 200 if reopt else 800
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)
    mixed = params.admm_mixed_cg and pd.rhs.dtype == torch.float64
    cg_tol_mult = 1e-4 if reopt else 1e-2
    cg_budget = CG_BUDGET_MIXED if mixed else CG_BUDGET_F64
    c = dict(c)
    if "plan" not in c:
        if params.admm_jacobi:
            jacobi = (True,) * len(pd.buckets)
        c["plan"] = sweep_plan(pd, jacobi, mixed)
    buckets_lo, slices, slices_lo = c["plan"]
    # caches of the buckets updated at once; the scan makes its own
    c["u_caches"] = tuple(None if sl is not None else _admm_cache(bk, x)
                          for bk, x, sl in zip(pd.buckets, c["U"].cones,
                                               slices))
    c["v_caches"] = tuple(None if sl is not None else _admm_cache(bk, x)
                          for bk, x, sl in zip(pd.buckets, c["V"].cones,
                                               slices))
    c["pinf_inf"] = c["pinf_l1"] * pinf_scale
    status, count, cg_iter = RUNNING, 0, 0
    while (status == RUNNING and count < n_steps and c["it"] < iter_celling
           and cg_iter < cg_budget):
        cg_tol = min(c["pinf_l1"] * cg_tol_mult, 1e-8)
        U, V, locals_, csum, ucs, vcs, cg_it = admm_update_all(
            pd, c["U"], c["V"], c["locals"], c["constr_sum"], c["dual"],
            c["rho"], c["u_caches"], c["v_caches"], cg_tol=cg_tol,
            buckets_lo=buckets_lo, slices=slices, slices_lo=slices_lo,
            lp_gs=params.lp_gauss_seidel)
        cg_iter += cg_it
        pobj, dobj, pinf, gap, locals_, csum = _obj_dimacs_xbar(
            pd, U, V, c["dual"], scale, ucs, vcs)
        pobj, dobj, pinf, gap = dev.host_read(
            torch.stack([pobj, dobj, pinf, gap]))
        pinf_inf = pinf * pinf_scale

        status = (NUM_ERR if (pinf_inf >= 1e10 or gap >= 1 - 1e-8)
                  else RUNNING)
        bad_pd = c["bad_pd"]
        if gap <= tol2 * 5:
            bad_pd = max(0, bad_pd - 5)
        if gap >= tol1 * 1e2:
            bad_pd = bad_pd + 2
        if status == RUNNING and bad_pd >= bad_pd_limit:
            status = BAD_PD
        buf = list(c["pinf_buf"])
        buf[count % 10] = pinf_inf
        conv_now = ((pinf <= EXIT_MARGIN * tol2) if reopt
                    else (pinf_inf <= EXIT_MARGIN * tol2))
        if gap_stop:
            conv_now = conv_now and gap <= tol2
        if status == RUNNING and conv_now:
            status = CONVERGED

        # dual ascent at X_bar (lorads_admm.c:120)
        rho = c["rho"]
        dual = c["dual"]
        if status != CONVERGED:
            dual = dual + rho * (pd.rhs - csum)

        # rho schedule (lorads_admm.c:121-138)
        it_off = c["it"] + (0 if reopt else 1)
        rho_n, cur_rho_max = rho, c["cur_rho_max"]
        old_mean = c["old_pinf_mean"]
        if it_off % rho_freq == 0:
            rho_n = rho * rho_factor
            if rho_n >= cur_rho_max:
                rho_n = cur_rho_max
                if it_off % (rho_freq * 100) == 0:
                    pinf_mean = sum(abs(x) for x in buf) / 10.0
                    if pinf_mean / old_mean >= 0.65 and pinf_inf > tol2:
                        rho_n = rho_n * escape_pow
                        cur_rho_max = rho_n
                    old_mean = pinf_mean
        rho_n = min(rho_n, params.rho_celling_admm)

        if (status == RUNNING and gap <= tol2 * 1e-3
                and pinf <= tol2 * 1e-3):
            status = EARLY_STOP

        # no-progress detectors: gap (main phase: with pinf deep under
        # tol) and, in the gap continuation, gap alone
        since_best = 0 if gap < c["best_gap"] * 0.9 else c["since_best"] + 1
        since_pinf = (0 if pinf < c["best_pinf"] * 0.9
                      else c["since_pinf"] + 1)
        stalled = (since_best >= 75 if gap_stop
                   else since_best >= 50 and pinf <= tol2 * 0.1)
        if status == RUNNING and stalled:
            status = STALLED

        c.update(U=U, V=V, locals=tuple(locals_), u_caches=ucs,
                 v_caches=vcs, constr_sum=csum, dual=dual, rho=rho_n,
                 cur_rho_max=cur_rho_max, pinf_buf=buf,
                 old_pinf_mean=old_mean, bad_pd=bad_pd, it=c["it"] + 1,
                 pinf_l1=pinf, pinf_inf=pinf_inf, gap=gap, pobj=pobj,
                 dobj=dobj, best_gap=min(gap, c["best_gap"]),
                 since_best=since_best,
                 best_pinf=min(pinf, c["best_pinf"]),
                 since_pinf=since_pinf)
        count += 1
    c["status"] = status
    c["cg_iter"] = cg_iter
    return c
