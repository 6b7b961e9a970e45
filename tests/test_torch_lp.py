"""lorads_torch's LP block vs lorads_tpu on the same inputs.

The LP block (ops/lp.py): its fields, its two sums on kernel K4 (K8a
A_lp(uv) over the constraint-sorted entries, K8b a_j^T w over the
column-sorted ones, with c as the base and alpha -1 for the
certificate), the Gauss-Seidel column sweep K8c (its plain version)
and the Jacobi closed form of ADMM's LP update, the certificate's LP
part, the two solver rules that count the LP block (the ALM rho
factor's auto rule and the identity directions' slot owners), and the
whole solves of tests/fixtures/hand_multiblock.dat-s with Jacobi and
with Gauss-Seidel LP sweeps.

lorads_tpu runs on CPU at f64 (conftest); the port on CPU tensors.
Tolerances: the sums and the sweeps at rtol 1e-12 (both packages sum
the same few terms per output in another order); the solves' logs to
their six printed digits, pObj at rtol 1e-6, and the analytic optimum
within the 5e-4 of tests/test_fixtures.py.
"""

import math
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.core.problem import LPBlockData
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_tpu.ops import lp as tpu_lp
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import solver as t_solver
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.config import SolverStatus
from lorads_torch.ops import kernels
from lorads_torch.ops import lp as t_lp

FIX = "tests/fixtures/"
RTOL = 1e-12
# lorads_tpu CPU f64 on the fixture
HAND_POBJ = {False: 0.21774877836010853, True: 0.21774893891060546}


def _problem(name):
    if name == "hand":
        return tpu_sdpa.read_sdpa(FIX + "hand_multiblock.dat-s")
    # 40 LP columns on 20 constraints, most columns several entries long
    return tpu_gen.random_multiblock(n_blocks=2, dim=8, m=20, density=0.3,
                                     n_lp=40, seed=3)


def _pds(name):
    """(lorads_tpu ProblemData, the port's) of one problem at f64."""
    problem = _problem(name)
    jpd = tpu_aop.build_problem_data(
        tpu_presolve.presolve(problem, TpuParams()), jnp.float64)
    tpd = t_aop.build_problem_data(
        tpu_presolve.presolve(problem, TpuParams()), torch.float64, "cpu")
    return jpd, tpd


def _close(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# LPData and its sums.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hand", "random"])
def test_lp_fields_match(name):
    jpd, tpd = _pds(name)
    j, t = jpd.lp, tpd.lp
    for f in ("n_cols", "m_glob", "nnz", "max_nnz_col"):
        assert getattr(t, f) == getattr(j, f), f
    for f in t_lp.LP_INT_FIELDS:
        assert getattr(t, f).dtype == torch.int32, f
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    for f in t_lp.LP_FLOAT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    # padding ids of the per-column layout point at m
    assert int(t.pc_con.max()) <= t.m_glob
    assert bool((t.pc_val[t.pc_con == t.m_glob] == 0).all())
    # interop builds the same LP block from lorads_tpu's arrays
    i = interop.lp_from_numpy(j)
    for f in t_lp.LP_INT_FIELDS + t_lp.LP_FLOAT_FIELDS:
        assert torch.equal(getattr(i, f), getattr(t, f)), f


@pytest.mark.parametrize("name", ["hand", "random"])
def test_lp_sums_match(name):
    """K8a and K8b (plain K4 on CPU tensors) against lorads_tpu's
    constr_vals / adjoint_cols, and K8b's base / alpha form."""
    jpd, tpd = _pds(name)
    rng = np.random.default_rng(5)
    uv = rng.standard_normal(tpd.lp.n_cols)
    w = rng.standard_normal(tpd.m)
    _close(t_lp.constr_vals(tpd.lp, torch.tensor(uv)),
           tpu_lp.constr_vals(jpd.lp, jnp.asarray(uv)))
    jadj = np.asarray(tpu_lp.adjoint_cols(jpd.lp, jnp.asarray(w)))
    _close(t_lp.adjoint_cols(tpd.lp, torch.tensor(w)), jadj)
    # c - A^T w (the certificate) and c + A^T w (the ALM gradient)
    c = np.asarray(jpd.lp.obj)
    _close(t_lp.adjoint_cols(tpd.lp, torch.tensor(w), base=tpd.lp.obj,
                             alpha=-1.0), c - jadj)
    _close(t_lp.adjoint_cols(tpd.lp, torch.tensor(w), base=tpd.lp.obj),
           c + jadj)
    assert float(t_lp.obj_inner(tpd.lp, torch.tensor(uv))) == pytest.approx(
        float(tpu_lp.obj_inner(jpd.lp, jnp.asarray(uv))), rel=RTOL)


def _lp_state(tpd, seed):
    rng = np.random.default_rng(seed)
    n, m = tpd.lp.n_cols, tpd.m
    return dict(u=rng.standard_normal(n), v=rng.standard_normal(n),
                csum=rng.standard_normal(m),
                dual=rng.standard_normal(m), rho=2.5)


@pytest.mark.parametrize("name", ["hand", "random"])
@pytest.mark.parametrize("rho", [2.5, 40.0])
def test_lp_gs_sweep_plain_matches_lorads_tpu(name, rho):
    """K8c's plain version (the wrapper on CPU tensors) against
    lorads_tpu's lax.scan over the columns, from the same state."""
    jpd, tpd = _pds(name)
    st = _lp_state(tpd, 6)
    jnew, _, jsum = tpu_admm._update_lp_var_gs(
        jpd, jnp.asarray(st["u"]), jnp.asarray(st["v"]), None,
        jnp.asarray(st["csum"]), jnp.asarray(st["dual"]), rho)
    lp = tpd.lp
    csum = torch.tensor(st["csum"])
    new, tsum = kernels.lp_gs_sweep(
        lp.pc_con, lp.pc_val, lp.obj, lp.col_nrm2sq, torch.tensor(st["u"]),
        torch.tensor(st["v"]), csum, tpd.rhs, torch.tensor(st["dual"]), rho)
    _close(new, jnew)
    _close(tsum, jsum)
    assert torch.equal(csum, torch.tensor(st["csum"]))   # input untouched
    assert kernels.LAUNCHES["lp_gs_sweep"] == 0           # CPU: plain


@pytest.mark.parametrize("name", ["hand", "random"])
@pytest.mark.parametrize("gs", [False, True])
def test_update_lp_var_matches_lorads_tpu(name, gs):
    """ADMM's LP update (Jacobi closed form, or the Gauss-Seidel sweep)
    with its cached contribution: new u, new A_lp(uv), new constr_sum."""
    jpd, tpd = _pds(name)
    st = _lp_state(tpd, 7)
    contrib = np.asarray(tpu_lp.constr_vals(
        jpd.lp, jnp.asarray(st["u"] * st["v"])))
    jfn = tpu_admm._update_lp_var_gs if gs else tpu_admm._update_lp_var
    tfn = t_admm._update_lp_var_gs if gs else t_admm._update_lp_var
    ref = jfn(jpd, jnp.asarray(st["u"]), jnp.asarray(st["v"]),
              jnp.asarray(contrib), jnp.asarray(st["csum"]),
              jnp.asarray(st["dual"]), st["rho"])
    got = tfn(tpd, torch.tensor(st["u"]), torch.tensor(st["v"]),
              torch.tensor(contrib), torch.tensor(st["csum"]),
              torch.tensor(st["dual"]), st["rho"])
    for g, r in zip(got, ref):
        _close(g, r)


def test_lp_gs_sweep_plain_is_the_column_order():
    """The plain K8c against a direct float64 loop over the columns
    (the reference's LORADSUpdateLPVarOne order): each column reads the
    constr_sum its predecessors updated."""
    _, tpd = _pds("random")
    st = _lp_state(tpd, 8)
    A = np.zeros((tpd.m, tpd.lp.n_cols))
    np.add.at(A, (tpd.lp.a_con.numpy(), tpd.lp.a_col.numpy()),
              tpd.lp.a_val.numpy())
    c, b, rho = tpd.lp.obj.numpy(), tpd.rhs.numpy(), st["rho"]
    csum, u, v = st["csum"].copy(), st["u"], st["v"]
    want = np.zeros_like(u)
    for j in range(u.size):
        a = A[:, j]
        wsum = (c[j] + a @ (rho * (csum - b) - st["dual"])
                - rho * (a @ a) * u[j] * v[j])
        want[j] = (-(wsum * v[j] - rho * v[j]) / rho) / (1 + (a @ a) * v[j]
                                                         * v[j])
        csum += a * (want[j] - u[j]) * v[j]
    lp = tpd.lp
    new, tsum = kernels.lp_gs_sweep_plain(
        lp.pc_con, lp.pc_val, lp.obj, lp.col_nrm2sq, torch.tensor(u),
        torch.tensor(v), torch.tensor(st["csum"]), tpd.rhs,
        torch.tensor(st["dual"]), rho)
    np.testing.assert_allclose(new.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(tsum.numpy(), csum, rtol=1e-10,
                               atol=1e-10 * np.abs(csum).max())


def test_lp_gs_sweep_checks_shapes():
    _, tpd = _pds("hand")
    lp = tpd.lp
    z = torch.zeros(lp.n_cols, dtype=torch.float64)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        kernels.lp_gs_sweep(lp.pc_con, lp.pc_val, lp.obj, lp.col_nrm2sq, z,
                            z, torch.zeros(tpd.m + 1, dtype=torch.float64),
                            tpd.rhs, tpd.rhs, 1.0)


# ---------------------------------------------------------------------------
# The certificate's LP part and the solver rules that count the LP block.
# ---------------------------------------------------------------------------

def test_lp_dual_part_matches_lorads_tpu():
    """sum |min(c - A_lp^T lambda, 0)| at a dual that makes some of it
    negative: the port's certificate pass against lorads_tpu's."""
    problem = _problem("random")
    js = TpuSolver(problem, TpuParams(verbose=False))
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    dual = 3.0 * np.random.default_rng(9).standard_normal(problem.m)
    js.dual = jnp.asarray(dual)
    ts.dual = torch.tensor(dual)
    jlp, _ = js._dual_infeas_pass()
    tlp, _ = ts._dual_infeas_pass()
    assert jlp > 0
    assert tlp == pytest.approx(jlp, rel=RTOL)
    assert t_solver._lp_dual_part(ts.pd, ts.dual) == tlp


def _maxcut_with_lp():
    """Max-Cut (one diag-identity block whose constraints each own one
    diagonal slot) plus an LP block of two columns on constraints 0-2."""
    problem = tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    problem.lp = LPBlockData(
        n_cols=2, m=problem.m, obj=np.array([1.0, 2.0]),
        a_con=np.array([0, 1, 2], np.int32),
        a_col=np.array([0, 0, 1], np.int32), a_val=np.array([1.0, 1.0, 1.0]))
    return problem


def test_alm_rho_factor_auto_counts_the_lp_block():
    """The auto rule takes 3.0 only for pure diag-identity problems: an
    LP block makes it 2.0, in both packages."""
    problem = _maxcut_with_lp()
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    assert ts.pd.buckets[0].diag_ident
    js = TpuSolver(problem, TpuParams(verbose=False))
    assert ts.params.alm_rho_factor == js.params.alm_rho_factor == 2.0
    problem.lp = None
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    assert ts.params.alm_rho_factor == 3.0


def test_identity_directions_count_lp_owners():
    """A slot that an LP column shares is no block's own: the identity
    directions agree with lorads_tpu's, and differ from those of the
    problem without its LP block."""
    problem = _maxcut_with_lp()
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    js = TpuSolver(problem, TpuParams(verbose=False))
    got, want = ts._identity_directions(), js._identity_directions()
    assert len(got) == len(want) == 1

    def same(a, b):
        if a is None or b is None:
            return a is None and b is None
        return all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a, b))

    assert same(got[0], want[0])
    problem.lp = None
    alone = TorchSolver(problem, TorchParams(verbose=False),
                        device="cpu")._identity_directions()
    assert alone[0] is not None and not same(got[0], alone[0])


# ---------------------------------------------------------------------------
# Whole solves of the fixture.
# ---------------------------------------------------------------------------

def _log_into(lines):
    return lambda *a, **k: lines.append(" ".join(map(str, a)))


def _log_rows(lines):
    """[(kind, {name: number})] of the ALM / ADMM / certificate lines."""
    out = []
    for ln in lines:
        kind = next((k for k in ("ALM Outer", "ADMM Iter", "Exit ALM",
                                 "Dual infeasibility") if ln.startswith(k)),
                    None)
        if kind is None:
            continue
        nums = dict(re.findall(r"(\w[\w()]*)\s*[:=]\s*(-?[0-9.]+(?:e[-+]?"
                               r"[0-9]+)?)", ln.rsplit("Time:", 1)[0]))
        nums.pop("cgIter", None)
        out.append((kind, {k: float(v) for k, v in nums.items()}))
    return out


@pytest.mark.parametrize("lp_gs", [False, True])
def test_hand_multiblock_solve_matches_lorads_tpu(lp_gs):
    """Two dense one-block buckets on local slots and an LP block of two
    columns: both packages reach primal_dual_optimal along the same
    logged path (every line with its objectives), pObj at rtol 1e-6 of
    lorads_tpu's and within 5e-4 of the analytic optimum
    (tests/test_fixtures.py:87-99)."""
    problem = _problem("hand")
    jlog, tlog = [], []
    js = TpuSolver(problem, TpuParams(verbose=False, lp_gauss_seidel=lp_gs))
    js.log = _log_into(jlog)
    jr = js.solve()
    ts = TorchSolver(problem, TorchParams(verbose=False,
                                          lp_gauss_seidel=lp_gs),
                     device="cpu")
    ts.log = _log_into(tlog)
    t0 = time.time()
    tr = ts.solve()
    assert time.time() - t0 < 30
    assert jr.status.value == "primal_dual_optimal"
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert [bk.B for bk in ts.pd.buckets] == [1, 1]
    assert not any(bk.glob_ident for bk in ts.pd.buckets)
    assert jr.pobj == pytest.approx(HAND_POBJ[lp_gs], rel=1e-12)
    assert tr.pobj == pytest.approx(jr.pobj, rel=1e-6)
    expected = ((1.0 - math.sqrt(2.0)) + (1.0 - math.sqrt(1.25)) + 0.75)
    assert tr.pobj == pytest.approx(expected, abs=5e-4)
    assert (tr.alm_stats.outer_iter, tr.alm_stats.inner_iter) == (
        jr.alm_stats.outer_iter, jr.alm_stats.inner_iter)
    assert tr.admm_stats.iter == jr.admm_stats.iter > 0

    # every logged line with its numbers to the log's six digits (rtol
    # 1e-5; pinf and the gap are differences of near-equal numbers, so
    # also atol 1e-8); cgIter is left out, being the phase's total in
    # the port and the last chunk's in lorads_tpu
    jrows, trows = _log_rows(jlog), _log_rows(tlog)
    assert len(trows) == len(jrows) >= 8
    for t, j in zip(trows, jrows):
        assert t[0] == j[0] and t[1].keys() == j[1].keys()
        np.testing.assert_allclose([t[1][k] for k in t[1]],
                                   [j[1][k] for k in t[1]], rtol=1e-5,
                                   atol=1e-8)
    # per-block factors and the LP columns x = u .* u >= 0, read back as
    # lorads_tpu reads them
    fs, lp_vals = ts.factor_blocks()
    jfs, jlp_vals = js.factor_blocks()
    assert [F.shape for F in fs] == [F.shape for F in jfs] == [(2, 2),
                                                                (3, 2)]
    assert lp_vals.shape == (2,) and np.all(lp_vals >= 0)
    np.testing.assert_allclose(lp_vals, jlp_vals, rtol=1e-5, atol=1e-8)
    for F, G in zip(fs, jfs):
        np.testing.assert_allclose(F @ F.T, G @ G.T, rtol=1e-5, atol=1e-7)
