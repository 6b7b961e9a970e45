"""lorads_torch's ADMM chunk as one device-decided loop (alg/admm.py
``admm_chunk``) held to lorads_tpu's ``_make_admm_chunk`` on the CPU.

The same factors, dual and rho, made from a numpy seed, go through one
chunk of each package's loop: lorads_tpu's jitted while_loop and the
port's device step, run here eagerly (the host reads each exit test),
its CG and refinement passes nested loops.  Statuses, iteration and CG
counts, rho, cur_rho_max, bad_pd and the stall counters must be equal.
The floats agree to within a bound of their scale (the largest
magnitude of each field) for each case and group (objectives; DIMACS
pinf, gap and the pinf ring; factors, dual and constraint sums): twice
the largest spread measured between the two packages on the CPU,
rounded up to 1, 2 or 5 times a power of ten (each package sums its own
reductions; pinf and gap are differences of nearly equal terms, so
their spread is the widest).  The cases cover Lovász theta (dense K7a
operator, the mixed-precision CG), the bucket Gauss-Seidel scan with
the LP block, K8c with and without the DUAL_U_V term, Max-Cut's closed
form, the reopt and gap-continuation flavours, and every exit of
lorads_tpu's cond: a status, ``n_steps``, ``iter_celling`` and the CG
budget.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg.state import FactorVec as TpuFV
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.alm import ALMStats
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams

FIX = "tests/fixtures/"
# The largest spread between the packages, |port - lorads_tpu| over the
# field's scale, of each case's fields by group, measured on the CPU
# (x86-64, one thread): the bounds are BOUND(reading).
SPREAD = {
    "theta_gtoy60": dict(obj=3.81e-13, dimacs=3.67e-13, vars=5.80e-12),
    "theta_gtoy60_cg_budget": dict(obj=2.97e-12, dimacs=5.17e-12,
                                   vars=2.87e-11),
    "hand_multiblock_celling": dict(obj=6.19e-13, dimacs=5.11e-11,
                                    vars=2.54e-14),
    "maxcut300_gap_stop": dict(obj=5.63e-16, dimacs=5.88e-9, vars=1.46e-14),
    "maxcut300_reopt": dict(obj=7.89e-16, dimacs=6.44e-12, vars=6.95e-15),
    "rmb2_lp_gs_dual_uv": dict(obj=4.79e-10, dimacs=8.78e-9,
                               vars=8.73e-11),
    "rmb2_scan": dict(obj=6.30e-10, dimacs=3.53e-7, vars=1.80e-9),
}


def BOUND(reading):
    """Twice ``reading``, rounded up to 1, 2 or 5 times a power of ten."""
    e = 10.0 ** np.floor(np.log10(2 * reading))
    return next(m * e for m in (1, 2, 5, 10) if m * e >= 2 * reading)


# ALM outer iterations before the ADMM start (max_alm_iter, which the
# ADMM chunk does not read)
ALM_OUTER = 10


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(name):
    if name == "maxcut300":
        return tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    if name.startswith("rmb"):
        nb, dim, m, seed = (int(v) for v in name[3:].split("_"))
        return tpu_gen.random_multiblock(n_blocks=nb, dim=dim, m=m, n_lp=4,
                                         seed=seed)
    return tpu_sdpa.read_sdpa(FIX + name + ".dat-s")


# The multi-block cases take the f64 CG: with the mixed-precision CG
# (theta's cases) their inner f32 solves stop an iteration apart where a
# stop test lies within f32 summation order of its tolerance
# (tests/test_torch_cg_parting.py).
F64_CG = dict(admm_mixed_cg=False)

# name: (problem, params of both packages, the chunk's flavour and
# limits, the exit of lorads_tpu's cond that ends it)
CASES = {
    # the dense bucket's CG (K7a) through the refinement passes
    "theta_gtoy60": ("theta_gtoy60", {}, dict(n_steps=4), "n_steps"),
    # the bucket scan over two blocks that share their constraints, the
    # LP columns Jacobi
    "rmb2_scan": ("rmb2_8_6_2", F64_CG, dict(n_steps=3), "n_steps"),
    # the scan with the f64 CG, K8c (lp_gauss_seidel) and the DUAL_U_V
    # term
    "rmb2_lp_gs_dual_uv": ("rmb2_8_6_2",
                           dict(F64_CG, lp_gauss_seidel=True, dual_uv=True),
                           dict(n_steps=3), "n_steps"),
    # K8c; cut by iter_celling
    "hand_multiblock_celling": ("hand_multiblock",
                                dict(F64_CG, lp_gauss_seidel=True),
                                dict(n_steps=10, celling=2), "celling"),
    # Max-Cut's closed form in the reopt and gap-continuation flavours;
    # the reopt chunk converges on pinf_l1 at once
    "maxcut300_reopt": ("maxcut300", {}, dict(n_steps=6, reopt=True),
                        "status"),
    "maxcut300_gap_stop": ("maxcut300", {}, dict(n_steps=6, gap_stop=True),
                           "status"),
    # cut by the CG budget (patched to 20 iterations in the port; the
    # port's count of steps is given to lorads_tpu's chunk as n_steps)
    "theta_gtoy60_cg_budget": ("theta_gtoy60", {},
                               dict(n_steps=10, budget=20), "budget"),
}


@functools.lru_cache(maxsize=None)
def _post_alm(name, kw):
    """The port's solver right after its ALM phase, cut at ALM_OUTER outer
    iterations (the ADMM phase's start: U = V = R, the ALM's dual, the
    rho it hands over), and that start as numpy arrays, which both
    packages' chunks start from."""
    ts = TorchSolver(_problem(name),
                     TorchParams(verbose=False, max_alm_iter=ALM_OUTER,
                                 **dict(kw)), device="cpu")
    alm_stats = ALMStats(rho=ts.ps.rho0)
    ts.alm_phase(alm_stats, time.time())
    admm_stats = ADMMStats(rho=ts.ps.rho0)
    ts.alm_to_admm(alm_stats, admm_stats)
    cones = [x.numpy().copy() for x in ts.U.cones]
    return ts, admm_stats.rho, cones, ts.U.lp.numpy().copy(), \
        ts.dual.numpy().copy()


def _tpu_chunk(problem, kw, bucket_jacobi, U, V, dual, S, rho, rho_max,
               reopt, gap_stop, celling, n_steps):
    params = TpuParams(verbose=False, **kw)
    ps = tpu_presolve.presolve(problem, params)
    pd = tpu_aop.build_problem_data(ps, jnp.float64)
    dt = jnp.float64
    scale = jnp.asarray(1.0, dt)
    jl, jlp, jtot, packed = tpu_admm.admm_init_eval(pd, U, V, dual, scale)
    pobj, dobj, pinf, gap = (float(v) for v in jax.device_get(packed))
    fn = tpu_admm.make_admm_chunk(params, reopt, bucket_jacobi,
                                  gap_stop=gap_stop)
    i32 = jnp.int32
    return fn(pd, U, V, jl, jlp, jtot, dual, jnp.asarray(rho, dt),
              jnp.asarray(rho_max, dt), jnp.zeros((10,), dt),
              jnp.asarray(1e30, dt), jnp.zeros((), i32),
              jnp.asarray(0, i32), jnp.asarray(pinf, dt),
              jnp.asarray(gap, dt), jnp.asarray(pobj, dt),
              jnp.asarray(dobj, dt), scale, jnp.asarray(celling, i32),
              jnp.asarray(n_steps, i32), jnp.asarray(gap, dt),
              jnp.zeros((), i32), jnp.asarray(pinf, dt),
              jnp.zeros((), i32), S)


def _close(got, want, bound):
    """|got - want| within ``bound`` times the largest |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=bound * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_admm_chunk_matches_lorads_tpu(monkeypatch, case):
    name, kw, run, want_exit = CASES[case]
    if "budget" in run:
        monkeypatch.setattr(t_admm, "CG_BUDGET_MIXED", run["budget"])
    problem = _problem(name)
    ts, rho, cones, lp, dual = _post_alm(name, tuple(sorted(kw.items())))
    reopt, gap_stop = run.get("reopt", False), run.get("gap_stop", False)
    celling, n_steps = run.get("celling", 1000), run["n_steps"]

    # the port's chunk from the numpy start
    U = interop.factor_from_numpy(cones, lp)
    V = interop.factor_from_numpy(cones, lp)
    tdual = torch.as_tensor(dual)
    tl, ttot, vals = t_admm.admm_init_eval(ts.pd, U, V, tdual, 1.0)
    pobj, dobj, pinf, gap = vals
    carry = t_admm.make_carry(
        ts.pd, U, V, tl, ttot, tdual, rho=rho, cur_rho_max=ts.rho_max,
        pinf_buf=[0.0] * 10, old_pinf_mean=1e30, bad_pd=0, it=0,
        pinf_l1=pinf, gap=gap, pobj=pobj, dobj=dobj, best_gap=gap,
        since_best=0, best_pinf=pinf, since_pinf=0)
    c = t_admm.admm_chunk(ts.params, ts.pd, {"carry": carry}, 1.0, celling,
                          n_steps, reopt=reopt, gap_stop=gap_stop,
                          jacobi=ts._bucket_jacobi, S=ts.S)
    got, pk = c["carry"], c

    # lorads_tpu's chunk from the same start
    if "budget" in run:
        # the port stopped on its budget after these iterations
        assert pk["status"] == t_admm.RUNNING
        assert int(got.k) < n_steps and pk["cg_iter"] >= run["budget"]
        n_steps = int(got.k)
    S = TpuFV(tuple(jnp.asarray(x.numpy()) for x in ts.S.cones),
              jnp.asarray(ts.S.lp.numpy()))
    out = _tpu_chunk(
        problem, kw, ts._bucket_jacobi,
        TpuFV(tuple(jnp.asarray(x) for x in cones), jnp.asarray(lp)),
        TpuFV(tuple(jnp.asarray(x) for x in cones), jnp.asarray(lp)),
        jnp.asarray(dual), S, rho, ts.rho_max, reopt, gap_stop, celling,
        n_steps)

    for f in ("status", "it", "k", "cg_iter", "bad_pd", "since_best",
              "since_pinf"):
        assert int(getattr(got, f)) == int(out[f]), f
    for f in ("rho", "cur_rho_max"):
        assert float(getattr(got, f)) == float(out[f]), f
    assert pk["it"] == int(out["it"]) and pk["status"] == int(out["status"])
    assert pk["cg_iter"] == int(out["cg_iter"])
    assert pk["rho"] == float(out["rho"])
    bound = {g: BOUND(v) for g, v in SPREAD[case].items()}
    for f in ("pobj", "dobj"):
        _close(getattr(got, f).numpy(), out[f], bound["obj"])
    for f in ("pinf_l1", "pinf_inf", "gap", "best_gap", "best_pinf",
              "pinf_buf"):
        _close(getattr(got, f).numpy(), out[f], bound["dimacs"])
    _close(got.old_pinf_mean.numpy(), out["old_pinf_mean"], bound["vars"])
    for a, b in zip(got.U.cones + got.V.cones, out["U"].cones
                    + out["V"].cones):
        _close(a.numpy(), b, bound["vars"])
    _close(got.U.lp.numpy(), out["U"].lp, bound["vars"])
    _close(got.V.lp.numpy(), out["V"].lp, bound["vars"])
    _close(got.dual.numpy(), out["dual"], bound["vars"])
    _close(got.constr_sum.numpy(), out["constr_sum"], bound["vars"])
    # the exit each case is for
    k = int(got.k)
    if want_exit == "n_steps":
        assert k == n_steps and pk["status"] == t_admm.RUNNING
    elif want_exit == "celling":
        assert pk["it"] == celling and k < n_steps
    elif want_exit == "status":
        assert pk["status"] != t_admm.RUNNING and k < n_steps
    if name != "maxcut300":
        assert pk["cg_iter"] > 0
