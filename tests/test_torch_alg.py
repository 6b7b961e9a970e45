"""lorads_torch algorithm pieces vs lorads_tpu on the same inputs.

Line search, L-BFGS two-loop, the diag-fast ``aop`` operators, the first
ALM inner iterates of maxcut(300, 4) from the same R0 (rtol 1e-9) and
one closed-form ADMM sweep from lorads_tpu's post-ALM state (rtol
1e-10).  lorads_tpu runs on CPU at f64; the port on CPU tensors.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import alm as tpu_alm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg import linesearch as tpu_ls
from lorads_tpu.alg import state as tpu_state
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core.presolve import presolve as tpu_presolve
from lorads_tpu.io import generators as tpu_gen
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import alm as t_alm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import linesearch as t_ls
from lorads_torch.alg import state as t_state
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _np(x):
    return np.asarray(x, dtype=np.float64)


# ---------------------------------------------------------------------------
# Line search.
# ---------------------------------------------------------------------------

def _cubic_cases():
    rng = np.random.default_rng(17)
    a, b, c, d = rng.standard_normal((4, 500))
    a[:50] *= 1e-9                      # nearly quadratic
    special = np.array([
        [0.0, 0.0, 1.0, -2.0],          # A = B = 0: degenerate root
        [1.0, -3.0, 3.0, -1.0],         # triple root at 1
        [1.0, 0.0, -1.0, 0.0],          # three real roots
        [1.0, -2.0, 1.0, 0.0],          # delta == 0 double root
        [2.0, 1.0, 1.0, 1.0],           # one real root
        [0.0, 1.0, -1.0, 0.0],          # a = 0
    ]).T
    return [np.concatenate([x, s]) for x, s in zip((a, b, c, d), special)]


def test_cubic_roots_matches():
    a, b, c, d = _cubic_cases()
    jr, jn = tpu_ls.cubic_roots(*(jnp.asarray(x) for x in (a, b, c, d)))
    tr, tn = t_ls.cubic_roots(*(_t(x) for x in (a, b, c, d)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=1e-10, atol=1e-12)


def _ls_inputs(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    m = 40
    q0, q1, q2, lam = rng.standard_normal((4, m)) * scale
    p1, p2 = rng.standard_normal(2) * scale
    rho = float(10.0 ** rng.uniform(-2, 3))
    return rho, lam, p1, abs(p2), q0, q1, q2


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scale", [1.0, 1e80])
def test_alm_line_search_matches(seed, scale):
    """Random quartics; scale 1e80 drives the raw discriminant past the
    f64 range, where only the coefficient normalization (linesearch.py
    107-118) keeps the root finder alive."""
    rho, lam, p1, p2, q0, q1, q2 = _ls_inputs(seed, scale)
    jt, jn = tpu_ls.alm_line_search(
        rho, jnp.asarray(lam), p1, p2, jnp.asarray(q0), jnp.asarray(q1),
        jnp.asarray(q2))
    tt, tn = t_ls.alm_line_search(
        rho, _t(lam), _t(p1), _t(p2), _t(q0), _t(q1), _t(q2))
    assert tn == int(jn)
    assert tn > 0
    assert tt == pytest.approx(float(jt), rel=1e-9, abs=1e-12)
    assert 0.0 <= tt <= 1.0


# ---------------------------------------------------------------------------
# L-BFGS two-loop.
# ---------------------------------------------------------------------------

def _fv_pair(rng, shape):
    x = rng.standard_normal(shape)
    return (tpu_state.FactorVec((jnp.asarray(x),), jnp.zeros((0,))),
            t_state.FactorVec((_t(x),), torch.zeros(0, dtype=torch.float64)))


@pytest.mark.parametrize("pushes", [0, 2, 3, 5])
def test_lbfgs_twoloop_matches(pushes):
    rng = np.random.default_rng(pushes)
    shape = (1, 30, 4)
    g_j, g_t = _fv_pair(rng, shape)
    hist = tpu_state.make_history(g_j, 3)
    for _ in range(pushes):
        s_j, _ = _fv_pair(rng, shape)
        # y = s + noise keeps <y, s> > 0 (a convex-like history)
        y = _np(s_j.cones[0]) + 0.3 * rng.standard_normal(shape)
        y_j = tpu_state.FactorVec((jnp.asarray(y),), jnp.zeros((0,)))
        hist = tpu_state.history_push(hist, s_j, y_j)
    th = interop.state_from_numpy(hist=hist)["hist"]
    assert (th.head, th.n_valid) == (int(hist.head), int(hist.n_valid))
    jd = tpu_state.lbfgs_direction_twoloop(hist, g_j)
    td = t_state.lbfgs_direction_twoloop(th, g_t)
    np.testing.assert_allclose(td.cones[0].numpy(), _np(jd.cones[0]),
                               rtol=1e-11, atol=1e-13)


def test_lbfgs_descent_safeguard():
    """s = g, y = -g makes the two-loop return +g (ascent): both
    packages fall back to -g."""
    rng = np.random.default_rng(1)
    g_j, g_t = _fv_pair(rng, (1, 20, 3))
    hist = tpu_state.history_push(tpu_state.make_history(g_j, 3), g_j,
                                  g_j.scale(-1.0))
    th = interop.state_from_numpy(hist=hist)["hist"]
    jd = tpu_state.lbfgs_direction_twoloop(hist, g_j)
    td = t_state.lbfgs_direction_twoloop(th, g_t)
    np.testing.assert_array_equal(td.cones[0].numpy(),
                                  -g_t.cones[0].numpy())
    np.testing.assert_array_equal(td.cones[0].numpy(), _np(jd.cones[0]))


# ---------------------------------------------------------------------------
# aop (diag-fast subset).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mc300():
    problem = tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    ps = tpu_presolve(problem, TpuParams())
    jpd = tpu_aop.build_problem_data(ps, jnp.float64)
    tpd = t_aop.build_problem_data(ps, torch.float64, "cpu")
    return problem, ps, jpd, tpd


def test_aop_diag_fast_matches(mc300):
    problem, ps, jpd, tpd = mc300
    rng = np.random.default_rng(8)
    n, r = ps.buckets[0].n, ps.buckets[0].rank
    R_j, R_t = _fv_pair(rng, (1, n, r))
    D_j, D_t = _fv_pair(rng, (1, n, r))
    w = rng.standard_normal(problem.m)
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        _np(a), _np(b), rtol=1e-11, atol=1e-11)
    assert t_aop._diag_fast(tpd.buckets[0]) == tpu_aop._diag_fast(
        jpd.buckets[0]) is True
    jl, jt = tpu_aop.auv(jpd, R_j, D_j)
    tl, tt = t_aop.auv(tpd, R_t, D_t)
    close(tl[0], jl[0])
    close(tt, jt)
    jo, jl, jt = tpu_aop.obj_and_auv(jpd, R_j, D_j)
    to, tl, tt = t_aop.obj_and_auv(tpd, R_t, D_t)
    close(to, jo)
    close(tt, jt)
    close(t_aop.obj_only(tpd, R_t, D_t), tpu_aop.obj_only(jpd, R_j, D_j))
    jc = tpu_aop.gather_caches(jpd, R_j)
    tc = t_aop.gather_caches(tpd, R_t)
    close(tc[0].cr, jc[0].cr)
    jout = tpu_aop.obj_and_auv_pair_cached(jpd, R_j, D_j, jc)
    tout = t_aop.obj_and_auv_pair_cached(tpd, R_t, D_t, tc)
    for a, b in zip(tout[:4], jout[:4]):
        close(a, b)
    close(tout[4][0].cr, jout[4][0].cr)
    jac = tpu_aop.axpy_caches(jc, 0.3, jout[4])
    tac = t_aop.axpy_caches(tc, 0.3, tout[4])
    close(tac[0].cr, jac[0].cr)
    close(t_aop.auv_cached(tpd, R_t, tc), tpu_aop.auv_cached(jpd, R_j, jc))
    jo, _, jt = tpu_aop.obj_and_auv_cached(jpd, R_j, jc)
    to, _, tt = t_aop.obj_and_auv_cached(tpd, R_t, tc)
    close(to, jo)
    close(tt, jt)
    close(t_aop.obj_cached(tpd, R_t, tc), tpu_aop.obj_cached(jpd, R_j, jc))
    close(t_aop.grad_cached(tpd, R_t, _t(w), tc).cones[0],
          tpu_aop.grad_cached(jpd, R_j, jnp.asarray(w), jc).cones[0])
    close(t_aop.grad(tpd, R_t, _t(w)).cones[0],
          tpu_aop.grad(jpd, R_j, jnp.asarray(w)).cones[0])
    close(t_aop.primal_infeas_l1(tpd, _t(w)),
          tpu_aop.primal_infeas_l1(jpd, jnp.asarray(w)))
    s_j = tpu_aop.scale_objective(jpd, 5.0)
    s_t = t_aop.scale_objective(tpd, 5.0)
    close(t_aop.obj_only(s_t, R_t, R_t), tpu_aop.obj_only(s_j, R_j, R_j))


# ---------------------------------------------------------------------------
# ALM: the first inner iterates; ADMM: one closed-form sweep.
# ---------------------------------------------------------------------------

def test_first_alm_inner_iterates_match():
    problem = tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    js = TpuSolver(problem, TpuParams(verbose=False))
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    # same rng stream -> the same R0, bit for bit
    np.testing.assert_array_equal(ts.R.cones[0].numpy(),
                                  _np(js.R.cones[0]))
    rho, p = js.ps.rho0, js.params
    jcs, jg, jcert = tpu_alm.alm_recompute(js.pd, js.R, js.dual, rho)
    tcs, tg, tcert = t_alm.alm_recompute(ts.pd, ts.R, ts.dual, rho)
    np.testing.assert_allclose(tg.cones[0].numpy(), _np(jg.cones[0]),
                               rtol=1e-11, atol=1e-12)
    args = (0.1 / rho, p.end_alm_sub_tol, p.end_tau_tol, p.phase1_tol,
            True)
    for k in range(1, 6):
        jR, _, _, jcsk, jinfo = tpu_alm.inner_chunk(
            js.pd, js.R, jg, js.hist, js.dual, jcs, jcert, rho, *args, k)
        tR, _, _, tcsk, tinfo, _ = t_alm._inner_loop(
            ts.pd, ts.R, tg, ts.hist, ts.dual, tcs, float(tcert), rho,
            *args, k)
        assert tinfo["local_iter"] == int(jinfo["local_iter"]) == k
        assert tinfo["tau"] == pytest.approx(float(jinfo["tau"]),
                                             rel=1e-9)
        np.testing.assert_allclose(tR.cones[0].numpy(), _np(jR.cones[0]),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tcsk.numpy(), _np(jcsk), rtol=1e-9,
                                   atol=1e-12)


def test_admm_sweep_from_lorads_tpu_state():
    problem = tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    js = TpuSolver(problem, TpuParams(verbose=False))
    alm_stats = tpu_alm.ALMStats(rho=js.ps.rho0)
    js.alm_phase(alm_stats, time.time())
    admm_stats = tpu_admm.ADMMStats(rho=js.ps.rho0)
    js.alm_to_admm(alm_stats, admm_stats)
    rho = admm_stats.rho
    jl, jlp, jtot, _ = tpu_admm.admm_init_eval(js.pd, js.U, js.V, js.dual,
                                               jnp.asarray(1.0))
    jU, jV, jl2, _, jcs, _, _, _ = tpu_admm.admm_update_all(
        js.pd, js.U, js.V, jl, jlp, jtot, js.dual, rho, 1e-8, 800)

    st = interop.state_from_numpy(U=js.U, V=js.V, dual=np.asarray(js.dual))
    tpd = t_aop.build_problem_data(js.ps, torch.float64, "cpu")
    tl, ttot, vals = t_admm.admm_init_eval(tpd, st["U"], st["V"],
                                           st["dual"], 1.0)
    np.testing.assert_allclose(ttot.numpy(), _np(jtot), rtol=1e-10,
                               atol=1e-12)
    tU, tV, tl2, tcs, _, _, cg_iters = t_admm.admm_update_all(
        tpd, st["U"], st["V"], tl, ttot, st["dual"], rho)
    assert cg_iters == 0                 # closed form: no CG
    for a, b in ((tU.cones[0], jU.cones[0]), (tV.cones[0], jV.cones[0]),
                 (tl2[0], jl2[0]), (tcs, jcs)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-10,
                                   atol=1e-12)


def test_ema_detector_matches():
    rng = np.random.default_rng(4)
    vals = np.concatenate([np.geomspace(1.0, 1e-3, 30),
                           1e-3 * (1 + 1e-3 * rng.standard_normal(30))])
    a, b = tpu_alm.EmaDetector(), t_alm.EmaDetector()
    assert [a.update(float(v)) for v in vals] == \
        [b.update(float(v)) for v in vals]
    assert not all(b.update(1e-3) for _ in range(10))
