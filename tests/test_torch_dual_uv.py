"""lorads_torch's DUAL_U_V ADMM variant (``dual_uv``) vs lorads_tpu: the
consensus term S (SDP cones zero, LP columns drawn after R, grown with
the rank), +S on the U side and -S on the V side of the SDP updates
(Max-Cut's closed form, the bucket Gauss-Seidel scan by CG), of the LP
Jacobi update and of the Gauss-Seidel LP sweep (kernel K8c, its plain
version here), and whole solves through the API and the CLI.

lorads_tpu runs on CPU at f64 (conftest); the port on CPU tensors.
Tolerances: the LP updates and the closed form at rtol 1e-11 (the same
few terms summed in another order); CG sweeps as stated; whole solves
against lorads_tpu's CPU f64 results (DUAL_UV_REF) at rtol 1e-8 (API)
and 1e-6 (the CLI's six printed digits).
"""

import re

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
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.alg.state import FactorVec as TorchFV
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.ops import kernels

FIX = "tests/fixtures/"
# lorads_tpu CPU f64, dual_uv=True: random_multiblock(2, 15, 12, n_lp=4,
# seed=9) (its test_dual_uv_variant instance; 217 inner steps, 16 ADMM
# iterations) and hand_multiblock
DUAL_UV_REF = {"rmb9": ("primal_dual_optimal", 39.926678576359116),
               "hand": ("primal_dual_optimal", 0.2177524570925113)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pds(problem):
    ps = tpu_presolve.presolve(problem, TpuParams())
    return (tpu_aop.build_problem_data(ps, jnp.float64),
            t_aop.build_problem_data(ps, torch.float64, "cpu"), ps)


def _close(got, ref, rtol=1e-11):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("gs", [False, True])
def test_lp_updates_with_s_match_lorads_tpu(gs):
    """The LP Jacobi update and the Gauss-Seidel sweep (K8c's plain
    version) with a signed s against lorads_tpu's, one seeded state."""
    problem = tpu_gen.random_multiblock(n_blocks=2, dim=8, m=20,
                                        density=0.3, n_lp=40, seed=3)
    jpd, tpd, _ = _pds(problem)
    rng = np.random.default_rng(8)
    n, m = tpd.lp.n_cols, tpd.m
    u, v, s = (rng.standard_normal(n) for _ in range(3))
    csum, dual = rng.standard_normal(m), rng.standard_normal(m)
    contrib = np.asarray(tpu_admm.lp_ops.constr_vals(jpd.lp,
                                                     jnp.asarray(u * v)))
    jfn = tpu_admm._update_lp_var_gs if gs else tpu_admm._update_lp_var
    tfn = t_admm._update_lp_var_gs if gs else t_admm._update_lp_var
    for sign in (1.0, -1.0):
        ref = jfn(jpd, jnp.asarray(u), jnp.asarray(v), jnp.asarray(contrib),
                  jnp.asarray(csum), jnp.asarray(dual), 2.5,
                  s_lp=jnp.asarray(sign * s))
        got = tfn(tpd, torch.tensor(u), torch.tensor(v),
                  torch.tensor(contrib), torch.tensor(csum),
                  torch.tensor(dual), 2.5, torch.tensor(sign * s))
        for a, b in zip(got, ref):
            _close(a, b)
        # the term moves the update
        plain = tfn(tpd, torch.tensor(u), torch.tensor(v),
                    torch.tensor(contrib), torch.tensor(csum),
                    torch.tensor(dual), 2.5)
        assert not torch.allclose(plain[0], got[0])
    assert kernels.LAUNCHES["lp_gs_sweep"] == 0


def test_lp_gs_sweep_plain_with_s():
    """K8c's plain version with s is the sweep without it after m2 + s_j:
    a one-column sweep against the closed form."""
    def f64(*x):
        return torch.tensor(x, dtype=torch.float64)

    pc_con = torch.tensor([[0, 2, 3]], dtype=torch.int32)
    pc_val = f64(0.5, -1.0, 0.0)[None]
    obj, nrm2, u, v, s = f64(0.3), f64(1.25), f64(0.7), f64(0.4), f64(-0.9)
    csum = f64(0.1, 0.2, -0.3)
    rhs, dual = f64(1.0, 0.5, -0.5), f64(0.2, 0.0, 0.4)
    rho = 3.0
    new, out = kernels.lp_gs_sweep_plain(pc_con, pc_val, obj, nrm2, u, v,
                                         csum, rhs, dual, rho, s)
    base = 0.5 * (rho * (0.1 - 1.0) - 0.2) + (-1.0) * (rho * (-0.3 + 0.5)
                                                       - 0.4)
    wsum = 0.3 + base - rho * 1.25 * 0.7 * 0.4
    m2 = wsum * 0.4 - rho * 0.4 + -0.9
    want = (-m2 / rho) / (1.0 + 1.25 * 0.4 * 0.4)
    assert float(new[0]) == pytest.approx(want, rel=1e-15)
    d = (float(new[0]) - 0.7) * 0.4
    np.testing.assert_allclose(out.numpy(), [0.1 + 0.5 * d, 0.2,
                                             -0.3 - d], rtol=1e-15)


def _admm_state(problem, jpd, rng):
    """Random factors (padded rows zero) and a dual, in both packages."""
    ps = tpu_presolve.presolve(problem, TpuParams())
    cones = []
    for bp in ps.buckets:
        X = rng.standard_normal((bp.B, bp.n, 2))
        for b, d in enumerate(bp.dims):
            X[b, d:] = 0.0
        cones.append(X)
    n_lp = problem.n_lp_cols
    U = TpuFV(tuple(jnp.asarray(x) for x in cones),
              jnp.asarray(rng.standard_normal(n_lp)))
    V = TpuFV(tuple(jnp.asarray(0.5 * x) for x in cones),
              jnp.asarray(rng.standard_normal(n_lp)))
    S = TpuFV(tuple(jnp.asarray(rng.standard_normal(x.shape))
                    for x in cones),
              jnp.asarray(rng.standard_normal(n_lp)))
    return U, V, S, rng.standard_normal(problem.m)


@pytest.mark.parametrize("name", ["maxcut300", "rmb_scan"])
def test_admm_sweep_with_s_matches_lorads_tpu(name):
    """One ADMM sweep with +S / -S from the same seeded state: the
    closed form of Max-Cut (rtol 1e-11), and the dense bucket of two
    blocks that share their constraints by the Gauss-Seidel scan (S's
    block slices to the blocks, each by CG), then the LP columns.  The
    scan's f64 CG to 1e-8: its counts part by summation order as
    ROADMAP's F3 settles (53 against lorads_tpu's 55 here; 52 against
    53 from the same state without S), the factors at 1e-8 of their
    scale."""
    if name == "maxcut300":
        problem = tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    else:
        problem = tpu_gen.random_multiblock(n_blocks=2, dim=15, m=12,
                                            n_lp=4, seed=9)
    jpd, tpd, _ = _pds(problem)
    U, V, S, dual = _admm_state(problem, jpd, np.random.default_rng(5))
    jac = False
    rho = 3.0
    jl, jlp, jtot, _ = tpu_admm.admm_init_eval(jpd, U, V, jnp.asarray(dual),
                                               jnp.asarray(1.0))
    jU, jV, jl2, _, jcs, jcg, _, _ = tpu_admm.admm_update_all(
        jpd, U, V, jl, jlp, jtot, jnp.asarray(dual), rho, 1e-8, 800,
        jacobi=(jac,), S=S, mixed=False)
    st = interop.state_from_numpy(U=U, V=V, dual=dual)
    tS = interop.factor_from_numpy(S.cones, S.lp)
    tl, ttot, _ = t_admm.admm_init_eval(tpd, st["U"], st["V"], st["dual"],
                                        1.0)
    _, slices, _ = t_admm.sweep_plan(tpd, (jac,))
    assert (slices[0] is None) == (name == "maxcut300")
    tU, tV, tl2, tcs, _, _, tcg = t_admm.admm_update_all(
        tpd, st["U"], st["V"], tl, ttot, st["dual"], rho, cg_tol=1e-8,
        slices=slices, S=tS)
    if name == "maxcut300":
        assert tcg == int(jcg) == 0
    else:
        assert abs(tcg - int(jcg)) <= 2 and tcg > 0
    rtol = 1e-11 if name == "maxcut300" else 1e-8
    pairs = [(tU.cones[0], jU.cones[0]), (tV.cones[0], jV.cones[0]),
             (tl2[0], jl2[0]), (tcs, jcs)]
    if problem.n_lp_cols:
        pairs += [(tU.lp, jU.lp), (tV.lp, jV.lp)]
    for a, b in pairs:
        _close(a.numpy(), b, rtol)
    # and S moved the sweep
    nU = t_admm.admm_update_all(tpd, st["U"], st["V"], tl, ttot,
                                st["dual"], rho, cg_tol=1e-8,
                                slices=slices)[0]
    assert not torch.allclose(nU.cones[0], tU.cones[0])


def test_dual_uv_solve_matches_lorads_tpu():
    """tests/test_solver.py's DUAL_U_V instance: lorads_tpu's status and
    pObj (DUAL_UV_REF, its CPU f64 run), and S as lorads_tpu draws it
    (solver.py:323-329)."""
    problem = tpu_gen.random_multiblock(n_blocks=2, dim=15, m=12, n_lp=4,
                                        seed=9)
    s = TorchSolver(problem, TorchParams(verbose=False, dual_uv=True),
                    device="cpu")
    # S: zero cones; LP columns drawn after R's, as lorads_tpu draws them
    rng = np.random.default_rng(TorchParams().seed)
    for bp, r in zip(s.ps.buckets, s.ranks):
        rng.random((bp.B, bp.n, r))
        rng.random((bp.B, bp.n, r))
    n = problem.n_lp_cols
    rng.random(n)
    rng.random(n)
    np.testing.assert_array_equal(s.S.lp.numpy(),
                                  rng.random(n) - rng.random(n))
    for x, y in zip(s.S.cones, s.R.cones):
        assert not x.any() and x.shape == y.shape
    res = s.solve()
    status, pobj = DUAL_UV_REF["rmb9"]
    assert res.status.value == status
    assert res.pobj == pytest.approx(pobj, rel=1e-8)
    assert res.pinf_l1 <= 1e-5


def test_s_grows_with_the_rank():
    problem = tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    s = TorchSolver(problem, TorchParams(verbose=False, dual_uv=True),
                    device="cpu")
    s.S = TorchFV(tuple(torch.ones_like(x) for x in s.S.cones), s.S.lp)
    r0 = s.ranks[0]
    s.aug_rank(1.5)
    x = s.S.cones[0]
    assert x.shape[2] == s.ranks[0] > r0
    assert bool((x[:, :, :r0] == 1).all()) and not x[:, :, r0:].any()


def test_cli_dual_uv_hand_multiblock(capsys):
    from lorads_torch.__main__ import main
    assert main([FIX + "hand_multiblock.dat-s", "--quiet", "--device",
                 "cpu", "--dualUV", "1"]) == 0
    out = capsys.readouterr().out
    status, pobj = DUAL_UV_REF["hand"]
    assert f"status `{status}`" in out
    got = float(re.search(r"Primal Objective: +: (\S+)", out).group(1))
    assert got == pytest.approx(pobj, rel=1e-6)
