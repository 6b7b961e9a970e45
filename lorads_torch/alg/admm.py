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
(Jacobi) or in order with ``lp_gauss_seidel`` (kernel K8c).  With
``dual_uv`` (the reference's DUAL_U_V build) every U-side subproblem
adds the solver's consensus term S to M2 and every V-side one subtracts
it (lorads_admm.c:401-420, 658-660; admm.py:130-133, 233-234, 253):
the SDP cones of S are zero, its LP columns random.

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

A chunk of up to ``n_steps`` iterations is one device-decided loop
(``admm_chunk``, lorads_tpu's ``_make_admm_chunk`` while_loop): the
iteration is a step on tensors, its decisions (the status codes, the
pinf ring, dual ascent, the rho schedule and its escape, the stall
detectors) ``torch.where``s as lorads_tpu writes them, and its CG solves
nested loops (alg/cg.py).  On CUDA tensors a key's first chunk runs
eagerly (the host reads each exit test); every later chunk replays one
CUDA graph whose WHILE node runs the iterations, whose bucket scan is
unrolled over the plan's block slices and whose CG and refinement loops
are WHILE nodes inside, and the host reads one pack (PACK_F, PACK_I, then
cur_rho_max; label ``admm``).  rho, cg_tol, the chunk's limits and the
reopt / gap-continuation flags are device tensors, so one graph serves
every chunk of a phase.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lorads_torch import device as dev
from lorads_torch.alg import aop, devloop
from lorads_torch.alg.aop import ProblemData
from lorads_torch.alg.cg import Bound, cg_solve, cg_solve_ir
from lorads_torch.alg.state import FactorVec
from lorads_torch.ops import kernels
from lorads_torch.ops import lp as lp_ops
from lorads_torch.ops import pattern as pat

# exit codes of a chunk
RUNNING, CONVERGED, NUM_ERR, BAD_PD, EARLY_STOP, STALLED = 0, 1, 2, 3, 4, 5

# the chunk's pack, in lorads_tpu's order (admm.py:52-53); the port adds
# cur_rho_max after them
PACK_F = ("rho", "pobj", "dobj", "pinf_l1", "pinf_inf", "gap")
PACK_I = ("it", "cg_iter", "status")

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


def _over(x, d):
    """x / d, d a number or a 0-d tensor, as a division by a number
    rounds: on CUDA tensors PyTorch multiplies by the reciprocal of a
    host scalar, so a device divisor does the same."""
    if isinstance(d, torch.Tensor) and x.is_cuda:
        return x * (1.0 / d)
    return x / d


def _admm_cache(bk: pat.BucketData, x):
    """ADMM cache of one factor: C @ X for diag-identity cones (the
    closed-form update's W @ X is C @ X + (a .* w) .* X); None for every
    other bucket (the port keeps no gathered-row caches)."""
    if aop._diag_fast(bk):
        return aop.CRCache(pat.cmul(bk, x))
    return pat.gather_cache(bk, x)


def _cg_operator(bk, F=None):
    """(x, F) -> x + A^*(A(sym(x F^T))) @ F, the CG operator of one side
    with the fixed factor F (linSysProduct, lorads_admm.c:376-391;
    admm.py:154-170): kernel K6 on split buckets whose off constraints
    own their slots, K7a on dense buckets whose constraints are
    single-entry or diagonal-only, else A(.) then A^*(.).  The solver
    passes F as an operand of the CG loop (a graph input on the card);
    given here, it is op's default."""
    def op(x, F=F):
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
                        cg_tol=1e-8, fcache=None, bk_lo=None, s_term=None):
    """One side of the splitting for one bucket (LORADSUpdateSDPVarOne,
    lorads_admm.c:428-480): solve (I + N) x = rhs for U with V fixed.

    Diag-identity cones make the normal system row-decoupled,
    N(x)_i = a_i^2 (x_i . v_i) v_i, so each row solves
    (I + a_i^2 v_i v_i^T) x_i = rhs_i exactly by Sherman-Morrison, with
    W @ V = C @ V (``fcache``) + (a .* w) .* V.  Other cones form
    W = C + A^*(w) (K4) and W @ V (K5), and solve by CG to ``cg_tol``
    (at most CG_MAX_ITER iterations; ``cg_tol`` a number or a 0-d
    tensor); with ``bk_lo`` (the bucket's f32 cast) the CG is the
    mixed-precision cg_solve_ir.  A CG loop's graphs are keyed by the
    bucket (or block slice) it runs on.  ``s_term`` (the signed DUAL_U_V
    term, [B, n, r]) is added to M2 = W @ fixed - rho fixed.
    Returns (new_var, new_local_vals, new_constr_sum, cg_iters,
    new_cache)."""
    base = rho * (constr_sum - pd.rhs) - dual
    w_loc = pat.gather_w(bk, base) - rho * pat.cone_total(bk, local_vals)
    if aop._diag_fast(bk):
        if fcache is None:
            fcache = _admm_cache(bk, fixed_var)
        M2 = (fcache.cr + (bk.a_val_d * w_loc)[:, :, None] * fixed_var
              - rho * fixed_var)
        rhs = _over(-(M2 if s_term is None else M2 + s_term), rho)
        a2 = bk.a_val_d * bk.a_val_d
        vr = torch.sum(fixed_var * rhs, -1)
        vv = torch.sum(fixed_var * fixed_var, -1)
        coef = a2 * vr / (1.0 + a2 * vv)
        new_var = rhs - coef[..., None] * fixed_var
        iters = 0
        new_local = bk.a_val_d * torch.sum(new_var * fixed_var, -1)
    else:
        W = pat.build_w(bk, w_loc)                        # C + A*(M1)
        M2 = pat.w_mul(bk, W, fixed_var) - rho * fixed_var
        rhs = _over(-(M2 if s_term is None else M2 + s_term), rho)
        if bk_lo is not None:
            op_lo = Bound(_cg_operator(bk_lo),
                          (fixed_var.to(torch.float32),),
                          devloop.ident(bk_lo))
            new_var, iters = cg_solve_ir(_cg_operator(bk, fixed_var), op_lo,
                                         update_var, rhs, cg_tol,
                                         CG_MAX_ITER)
        else:
            op = Bound(_cg_operator(bk), (fixed_var,), devloop.ident(bk))
            new_var, iters = cg_solve(op, update_var, rhs, cg_tol,
                                      CG_MAX_ITER)
        new_local = pat.constr_vals(bk, pat.uvt(bk, new_var, fixed_var))
    new_sum = constr_sum + pat.scatter_constr(bk, new_local - local_vals)
    return new_var, new_local, new_sum, iters, _admm_cache(bk, new_var)


def _update_lp_var(pd: ProblemData, upd, fixed, lp_contrib, constr_sum,
                   dual, rho, s_lp=None):
    """Closed-form LP column updates, Jacobi over the columns
    (LORADSUpdateLPVarOne, lorads_admm.c:595-628; admm.py:211-236):
    wsum_j = c_j + a_j^T (rho (csum - b) - lambda) - rho ||a_j||^2 u_j v_j,
    the last term removing column j's own contribution.  ``lp_contrib``
    is the cached A_lp(uv); ``s_lp`` the signed DUAL_U_V term, added to
    m2.  Returns (new u, new A_lp(u v), new constr_sum)."""
    lpd = pd.lp
    base_w = rho * (constr_sum - pd.rhs) - dual
    base = lp_ops.adjoint_cols(lpd, base_w)
    corr = rho * lpd.col_nrm2sq * upd * fixed
    wsum = lpd.obj + base - corr
    m2 = wsum * fixed - rho * fixed
    if s_lp is not None:
        m2 = m2 + s_lp
    new = _over(-m2, rho) / (1.0 + lpd.col_nrm2sq * fixed * fixed)
    new_contrib = lp_ops.constr_vals(lpd, new * fixed)
    return new, new_contrib, constr_sum + new_contrib - lp_contrib


def _update_lp_var_gs(pd: ProblemData, upd, fixed, lp_contrib, constr_sum,
                      dual, rho, s_lp=None):
    """The same closed form swept over the columns in order, each
    reading the constr_sum the previous columns updated
    (lorads_admm.c:595-628 driven by lorads_alg_common.c:229-247;
    admm.py:238-276): kernel K8c.  Returns as _update_lp_var."""
    lpd = pd.lp
    new, new_sum = kernels.lp_gs_sweep(
        lpd.pc_con, lpd.pc_val, lpd.obj, lpd.col_nrm2sq, upd, fixed,
        constr_sum, pd.rhs, dual, rho, s=s_lp)
    return new, lp_ops.constr_vals(lpd, new * fixed), new_sum


def _update_sdp_var_bucket_gs(pd: ProblemData, slices, slices_lo, upd,
                              fixed, local_vals, constr_sum, dual, rho,
                              cg_tol, s=None):
    """One side of the splitting over a bucket's blocks in sequence, each
    block seeing the constr_sum the previous ones updated -- the
    reference's sweep (lorads_alg_common.c:190-214; admm.py:279-299,
    a lax.scan there, a host loop over ``slices`` here, the
    bucket_slice views of each block); ``s`` the signed DUAL_U_V term
    [B, n, r], block b's slice to block b.  Returns (new_var [B, n, r],
    new_local_vals [B, m_loc], new_constr_sum, cg_iters, None)."""
    new_var, new_local, iters = [], [], 0
    for b, bk1 in enumerate(slices):
        u1, loc1, constr_sum, it, _ = _update_sdp_var_one(
            pd, bk1, upd[b:b + 1], fixed[b:b + 1], local_vals[b:b + 1],
            constr_sum, dual, rho, cg_tol,
            bk_lo=None if slices_lo is None else slices_lo[b],
            s_term=None if s is None else s[b:b + 1])
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
                    slices_lo=None, lp_gs=False, S: FactorVec = None):
    """One sweep: each bucket U then V, then the LP columns U then V
    (LORADSUpdateSDPVar / LORADSUpdateSDPLPVar,
    lorads_alg_common.c:187-248; admm.py:302-368).  ``locals_`` holds
    one [B, m_loc] tensor per bucket and, with an LP block, its [m]
    contribution A_lp(uv) last.  ``buckets_lo``: the buckets' f32 casts
    for the mixed-precision CG; ``slices`` / ``slices_lo``: per bucket
    its block slices (sweep_plan) for the Gauss-Seidel scan, None for
    a bucket updated at once; ``lp_gs``: the LP columns in order (K8c);
    ``S``: the DUAL_U_V term (None: none), +S on the U side, -S on the V
    side.
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
        s_j = None if S is None else S.cones[j]
        s_n = None if S is None else -s_j
        if slices[j] is None:
            u_new, loc, constr_sum, it1, uc = _update_sdp_var_one(
                pd, bk, u_cones[j], v_cones[j], locals_[j], constr_sum,
                dual, rho, cg_tol, fcache=v_caches[j], bk_lo=lo[j],
                s_term=s_j)
            v_new, loc, constr_sum, it2, vc = _update_sdp_var_one(
                pd, bk, v_cones[j], u_new, loc, constr_sum, dual, rho,
                cg_tol, fcache=uc, bk_lo=lo[j], s_term=s_n)
        else:
            u_new, loc, constr_sum, it1, uc = _update_sdp_var_bucket_gs(
                pd, slices[j], slices_lo[j], u_cones[j], v_cones[j],
                locals_[j], constr_sum, dual, rho, cg_tol, s=s_j)
            v_new, loc, constr_sum, it2, vc = _update_sdp_var_bucket_gs(
                pd, slices[j], slices_lo[j], v_cones[j], u_new, loc,
                constr_sum, dual, rho, cg_tol, s=s_n)
        u_cones[j], v_cones[j] = u_new, v_new
        u_caches[j], v_caches[j] = uc, vc
        locals_[j] = loc
        cg_total += it1 + it2
    lp_u, lp_v = U.lp, V.lp
    if pd.lp is not None:
        upd_fn = _update_lp_var_gs if lp_gs else _update_lp_var
        s_lp = None if S is None else S.lp
        lp_u, lpc, constr_sum = upd_fn(pd, lp_u, lp_v, locals_[nb],
                                       constr_sum, dual, rho, s_lp)
        lp_v, lpc, constr_sum = upd_fn(pd, lp_v, lp_u, lpc, constr_sum,
                                       dual, rho,
                                       None if S is None else -s_lp)
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
    pobj = _over(pobj, scale)
    dobj = _over(torch.dot(pd.rhs, dual), scale)
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
                                                      gap]), "admm")


@dataclasses.dataclass
class ADMMCarry:
    """The chunk loop's state on the device: lorads_tpu's carry
    (admm.py:617-657) as tensors, 0-d but for the factors, locals,
    caches, constr_sum, dual and the pinf ring [10].  ``k`` counts the
    chunk's iterations, ``cg_iter`` its CG iterations."""

    U: FactorVec
    V: FactorVec
    locals: tuple
    u_caches: tuple
    v_caches: tuple
    constr_sum: torch.Tensor
    dual: torch.Tensor
    rho: torch.Tensor
    cur_rho_max: torch.Tensor
    pinf_buf: torch.Tensor
    old_pinf_mean: torch.Tensor
    bad_pd: torch.Tensor
    it: torch.Tensor
    k: torch.Tensor
    pinf_l1: torch.Tensor
    pinf_inf: torch.Tensor
    gap: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    best_gap: torch.Tensor
    since_best: torch.Tensor
    best_pinf: torch.Tensor
    since_pinf: torch.Tensor
    status: torch.Tensor
    cg_iter: torch.Tensor


_INTS = ("bad_pd", "it", "k", "since_best", "since_pinf", "status",
         "cg_iter")


def make_carry(pd: ProblemData, U, V, locals_, constr_sum, dual,
               **scalars) -> ADMMCarry:
    """A carry on pd's device from the factors, locals, constr_sum and
    dual and the host numbers ``scalars`` (rho, cur_rho_max, pinf_buf,
    old_pinf_mean, bad_pd, it, pinf_l1, gap, pobj, dobj, best_gap,
    since_best, best_pinf, since_pinf; the rest start at 0 and the
    caches are made by admm_chunk)."""
    dt, device = pd.rhs.dtype, pd.rhs.device
    nb = len(pd.buckets)

    def tensor(name, v):
        if isinstance(v, torch.Tensor):
            return v
        if name == "pinf_buf":
            return torch.tensor(v, dtype=dt, device=device)
        return torch.full((), v, device=device,
                          dtype=torch.int64 if name in _INTS else dt)

    vals = dict(k=0, pinf_inf=0.0, status=RUNNING, cg_iter=0, **scalars)
    return ADMMCarry(U=U, V=V, locals=tuple(locals_),
                     u_caches=(None,) * nb, v_caches=(None,) * nb,
                     constr_sum=constr_sum, dual=dual,
                     **{k: tensor(k, v) for k, v in vals.items()})


def _with_caches(pd: ProblemData, c: ADMMCarry, slices) -> ADMMCarry:
    """The carry with the caches of the buckets updated at once made from
    its factors (the scan makes its own)."""
    return dataclasses.replace(
        c, u_caches=tuple(None if sl is not None else _admm_cache(bk, x)
                          for bk, x, sl in zip(pd.buckets, c.U.cones,
                                               slices)),
        v_caches=tuple(None if sl is not None else _admm_cache(bk, x)
                       for bk, x, sl in zip(pd.buckets, c.V.cones, slices)))


def chunk_loop(params, pd: ProblemData, carry: ADMMCarry, plan, scale,
               iter_celling: int, n_steps: int, reopt: bool = False,
               gap_stop: bool = False, S: FactorVec = None) -> devloop.Loop:
    """The chunk as a device-decided devloop.Loop (lorads_tpu's
    _make_admm_chunk: ``init`` its carry's set-up, admm.py:630-657;
    ``running`` its cond, :507-511; ``step`` its body, :513-628).  The
    loop's inputs: scale, iter_celling, n_steps, the reopt and gap_stop
    flags with what they select (the CG tolerance factor, the bad_pd
    limit, the rho schedule's offset) and S; ``plan`` is sweep_plan's."""
    tol2, tol1 = params.phase2_tol, params.phase1_tol
    rho_freq, rho_factor = params.rho_freq, params.rho_factor
    escape_pow = float(rho_factor ** round(
        math.log(rho_freq * 100) / math.log(rho_freq)))
    rho_celling = params.rho_celling_admm
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)
    mixed = params.admm_mixed_cg and pd.rhs.dtype == torch.float64
    cg_budget = CG_BUDGET_MIXED if mixed else CG_BUDGET_F64
    lp_gs = params.lp_gauss_seidel
    buckets_lo, slices, slices_lo = plan
    dt, device = pd.rhs.dtype, pd.rhs.device

    def full(v, dtype=dt):
        return torch.full((), v, dtype=dtype, device=device)

    i64 = torch.int64
    inputs = (full(scale), full(iter_celling, i64), full(n_steps, i64),
              full(reopt, torch.bool), full(gap_stop, torch.bool),
              full(1e-4 if reopt else 1e-2), full(200 if reopt else 800, i64),
              full(0 if reopt else 1, i64),
              S if params.dual_uv else None)

    def init(inp, c):
        zero = torch.zeros_like(c.k)
        return dataclasses.replace(
            _with_caches(pd, c, slices), pinf_inf=c.pinf_l1 * pinf_scale,
            k=zero, status=zero, cg_iter=zero)

    def running(inp, c):
        _, celling, n_steps_t = inp[:3]
        return ((c.status == RUNNING) & (c.k < n_steps_t)
                & (c.it < celling) & (c.cg_iter < cg_budget))

    def step(inp, c, kind):
        (scale_t, _, _, reopt_f, gap_stop_f, cg_tol_mult, bad_pd_limit,
         it_shift, S_used) = inp
        cg_tol = torch.minimum(c.pinf_l1 * cg_tol_mult, full(1e-8))
        U, V, locals_, csum, ucs, vcs, cg_it = admm_update_all(
            pd, c.U, c.V, c.locals, c.constr_sum, c.dual, c.rho, c.u_caches,
            c.v_caches, cg_tol=cg_tol, buckets_lo=buckets_lo, slices=slices,
            slices_lo=slices_lo, lp_gs=lp_gs, S=S_used)
        pobj, dobj, pinf, gap, locals_, csum = _obj_dimacs_xbar(
            pd, U, V, c.dual, scale_t, ucs, vcs)
        pinf_inf = pinf * pinf_scale

        def code(cond, new, status):
            return torch.where((status == RUNNING) & cond, new, status)

        status = torch.where((pinf_inf >= 1e10) | (gap >= 1 - 1e-8),
                             NUM_ERR, RUNNING)
        bad_pd = torch.where(gap <= tol2 * 5,
                             torch.clamp(c.bad_pd - 5, min=0), c.bad_pd)
        bad_pd = torch.where(gap >= tol1 * 1e2, bad_pd + 2, bad_pd)
        status = code(bad_pd >= bad_pd_limit, BAD_PD, status)
        slot = torch.arange(10, device=device)
        buf = torch.where(slot == c.k % 10, pinf_inf, c.pinf_buf)
        conv_now = (torch.where(reopt_f, pinf <= EXIT_MARGIN * tol2,
                                pinf_inf <= EXIT_MARGIN * tol2)
                    & (~gap_stop_f | (gap <= tol2)))
        status = code(conv_now, CONVERGED, status)

        # dual ascent at X_bar (lorads_admm.c:120)
        dual = torch.where(status != CONVERGED,
                           c.dual + c.rho * (pd.rhs - csum), c.dual)

        # rho schedule (lorads_admm.c:121-138)
        it_off = c.it + it_shift
        sched = it_off % rho_freq == 0
        rho_n = torch.where(sched, c.rho * rho_factor, c.rho)
        hit_max = sched & (rho_n >= c.cur_rho_max)
        rho_n = torch.where(hit_max, c.cur_rho_max, rho_n)
        esc_hit = hit_max & (it_off % (rho_freq * 100) == 0)
        # the ring's mean, summed in order (as the host did)
        pinf_sum = torch.abs(buf[0])
        for i in range(1, 10):
            pinf_sum = pinf_sum + torch.abs(buf[i])
        pinf_mean = pinf_sum / full(10.0)
        escape = (esc_hit & (pinf_mean / c.old_pinf_mean >= 0.65)
                  & (pinf_inf > tol2))
        rho_n = torch.where(escape, rho_n * escape_pow, rho_n)
        cur_rho_max = torch.where(escape, rho_n, c.cur_rho_max)
        old_mean = torch.where(esc_hit, pinf_mean, c.old_pinf_mean)
        rho_n = torch.minimum(rho_n, full(rho_celling))

        status = code((gap <= tol2 * 1e-3) & (pinf <= tol2 * 1e-3),
                      EARLY_STOP, status)
        # no-progress detectors: gap (main phase: with pinf deep under
        # tol) and, in the gap continuation, gap alone
        since_best = torch.where(gap < c.best_gap * 0.9, 0,
                                 c.since_best + 1)
        since_pinf = torch.where(pinf < c.best_pinf * 0.9, 0,
                                 c.since_pinf + 1)
        stalled = torch.where(gap_stop_f, since_best >= 75,
                              (since_best >= 50) & (pinf <= tol2 * 0.1))
        status = code(stalled, STALLED, status)
        return ADMMCarry(
            U=U, V=V, locals=tuple(locals_), u_caches=ucs, v_caches=vcs,
            constr_sum=csum, dual=dual, rho=rho_n, cur_rho_max=cur_rho_max,
            pinf_buf=buf, old_pinf_mean=old_mean, bad_pd=bad_pd,
            it=c.it + 1, k=c.k + 1, pinf_l1=pinf, pinf_inf=pinf_inf,
            gap=gap, pobj=pobj, dobj=dobj,
            best_gap=torch.minimum(gap, c.best_gap), since_best=since_best,
            best_pinf=torch.minimum(pinf, c.best_pinf),
            since_pinf=since_pinf, status=status,
            cg_iter=c.cg_iter + cg_it)

    def pack(inp, c):
        return torch.stack([getattr(c, f).to(torch.float64)
                            for f in PACK_F + PACK_I + ("cur_rho_max",)])

    key = ("admm", devloop.ident(pd), devloop.ident(plan), tol2, tol1,
           rho_freq, rho_factor, rho_celling, mixed, lp_gs)
    return devloop.Loop(key=key, step=step, pack=pack, inputs=inputs,
                        state=carry, K=None, label="admm", running=running,
                        init=init)


def chunk_start(params, pd: ProblemData, carry: ADMMCarry, jacobi=(),
                plan=None) -> dict:
    """A phase's first admm_chunk ``c``: the carry with its caches laid
    out as the loop leaves them, and the sweep plan (``plan``, if given,
    is kept: one sweep_plan made for this pd and flags, whose chunk
    graph, keyed by it, a later phase on the same pd replays)."""
    if plan is None:
        mixed = params.admm_mixed_cg and pd.rhs.dtype == torch.float64
        if params.admm_jacobi:
            jacobi = (True,) * len(pd.buckets)
        plan = sweep_plan(pd, jacobi, mixed)
    return {"carry": _with_caches(pd, carry, plan[1]), "plan": plan}


def prepare_chunk(params, pd: ProblemData, c: dict, scale, iter_celling,
                  n_steps, reopt=False, gap_stop=False, jacobi=(), S=None):
    """(c, the chunk's loop): ``c`` (chunk_start's, made here from a bare
    ``{"carry": ...}``) and chunk_loop on it; admm_chunk's arguments."""
    c = dict(c)
    if "plan" not in c:
        c = chunk_start(params, pd, c["carry"], jacobi)
    return c, chunk_loop(params, pd, c["carry"], c["plan"], scale,
                         iter_celling, n_steps, reopt, gap_stop, S)


def admm_chunk(params, pd: ProblemData, c: dict, scale: float,
               iter_celling: int, n_steps: int, reopt: bool = False,
               gap_stop: bool = False, jacobi=(), S: FactorVec = None
               ) -> dict:
    """Up to ``n_steps`` ADMM iterations as one device-decided loop
    (chunk_loop).  ``c`` holds ``carry`` (an ADMMCarry) and ``plan``
    (chunk_start's; made on a bare carry's first chunk); returns it with
    the carry advanced and the pack read to host numbers under their
    names (PACK_F, PACK_I and cur_rho_max; ``cg_iter`` this chunk's CG
    iterations).  ``jacobi``: per-bucket flags, True for a
    bucket whose blocks update at once (LoradsParams.admm_jacobi sets
    them all).  The chunk also returns once its CG count crosses the
    per-chunk budget.  ``S``: the DUAL_U_V term, used only with
    ``params.dual_uv`` (admm.py:474).

    ``reopt`` tightens the bad_pd limit, shifts the rho schedule and
    converges on pinf_l1; ``gap_stop`` is the gap-continuation variant
    (convergence also needs gap <= tol, the stall detector watches the
    gap alone)."""
    c, loop = prepare_chunk(params, pd, c, scale, iter_celling, n_steps,
                            reopt, gap_stop, jacobi, S)
    c["carry"], out = devloop.run(loop)
    c.update((k, int(v) if k in PACK_I else v)
             for k, v in zip(PACK_F + PACK_I + ("cur_rho_max",), out))
    return c
