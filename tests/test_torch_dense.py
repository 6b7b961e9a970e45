"""lorads_torch's dense path (Lovász theta) vs lorads_tpu on the same inputs.

Dense buckets: lovasz_theta(n=24, avg_degree=5, seed=2) and
tests/fixtures/theta_gtoy60.dat-s (single-entry edge constraints plus
the trace: ``a_single_dense``), tests/fixtures/mc_gtoy60.dat-s (Max-Cut
in dense mode: every constraint diagonal-only, so ``a2_full`` is 0) and
random_multiblock(n_blocks=1, dim=30) (multi-entry constraints: the
generic CG operator).  Checked here: the DenseBucketData fields and the
port's sorted layouts, every dense op at f64 and f32, the plain K7a,
``scale_bucket``, the CG solvers on the dense ADMM operator, the first
ALM inner iterates, one ADMM sweep from lorads_tpu's state, the
spectral dual repair from lorads_tpu's post-ADMM state, the dense
Lanczos certificate, and whole solves.

lorads_tpu runs on CPU at f64 (conftest); the port on CPU tensors.
Tolerances:

* f64: rtol 1e-11 plus 4 * 2^-48 * sum|terms| of the whole input
  (lorads_tpu's compensated prefix scan and two-plane f32 scatter carry
  2^-48 of each term and prefix);
* f32 segment sums: 4 * eps32 * sum|terms| of each output; f32 products
  of k terms (the matmuls of uvt and w_mul, k = r or n): k * eps32 *
  sum|terms|, since the two libraries sum them in another order;
* K7a's plain version and A(.) on the single-entry constraints: exact.

Whole solves: lorads_tpu and the port take the same path through the
first ALM outer iterations (theta_gtoy60: 12, theta40: 11, theta300:
17): every outer iteration's inner count agrees, and its logged pObj,
dObj, pinf and gap agree to the log's six digits.  Then theta's ALM
grinds for a thousand inner steps at rho ~ 1e3, where a one-ulp
difference in a sum changes the step count (the port alone, with
sym(UV^T) summed in another order, moves theta_gtoy60's thirteenth
outer iteration from 1087 to 1026 inner steps).  So past that common
path the whole solves are held to the outcome: both primal_dual_optimal,
the spectral repair run and accepted in both, pObj within 5e-5 relative
(the spread seen on the CPU: 7.3e-6 for theta_gtoy60, 2.1e-8 for
theta40, 3.4e-6 for theta300).
"""

import dataclasses
import functools
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import alm as tpu_alm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg import cg as tpu_cg
from lorads_tpu.alg import solver as tpu_solver
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_tpu.ops import pattern as tpu_pat
from lorads_torch import device as t_dev
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import alm as t_alm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import cg as t_cg
from lorads_torch.alg import solver as t_solver
from lorads_torch.alg import spectral_repair as t_repair
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.config import SolverStatus
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as t_pat

FIX = "tests/fixtures/"
EPS32 = float(np.finfo(np.float32).eps)
F64_PREFIX = 2.0 ** -48
POBJ_RTOL = 5e-5
# one "ALM Outer:k Inner:... pObj:... dObj:... pInf(1):... pInf(Inf):...
# pdGap:..." line per outer iteration, in both packages' logs
OUTER_LINE = re.compile(
    r"ALM Outer:(\d+) Inner:(\d+) pObj:(\S+) dObj:(\S+) pInf\(1\):(\S+) "
    r"pInf\(Inf\):(\S+) pdGap:(\S+)")
BUCKETS = ["theta24", "theta_gtoy60", "mc_gtoy60", "multiblock30"]


def _problem(name):
    if name == "theta24":
        return tpu_gen.lovasz_theta(n=24, avg_degree=5, seed=2)
    if name == "theta40":
        return tpu_gen.lovasz_theta(n=40, avg_degree=6, seed=7)
    if name == "multiblock30":
        return tpu_gen.random_multiblock(n_blocks=1, dim=30, m=20, n_lp=0,
                                         seed=4)
    return tpu_sdpa.read_sdpa(FIX + name + ".dat-s")


@functools.lru_cache(maxsize=None)
def _buckets(name, dtype=np.float64):
    """(lorads_tpu bucket, port bucket, presolved plan)."""
    problem = _problem(name)
    bp = tpu_presolve.presolve(problem, TpuParams()).buckets[0]
    jbk = tpu_pat.build_bucket_data(bp, problem.m, jnp.dtype(dtype))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return jbk, t_pat.build_bucket_data(bp, problem.m, tdt, "cpu"), bp


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x, dtype=np.float64)).to(dtype)


def _abs_bucket(tbk):
    """The f64 bucket with |values|: feeding it |inputs| gives the sum of
    |terms| of every output."""
    return dataclasses.replace(tbk, **{
        f.name: getattr(tbk, f.name).abs().double()
        for f in dataclasses.fields(tbk)
        if isinstance(getattr(tbk, f.name), torch.Tensor)
        and getattr(tbk, f.name).is_floating_point()})


def _close(got, ref, l1, dtype, k=None):
    """got vs ref under the module's tolerances; ``l1`` is sum|terms|
    per output, ``k`` the length of the f32 products (None: a sum)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    l1 = np.asarray(l1, np.float64)
    assert got.shape == ref.shape
    if dtype == "f64":
        np.testing.assert_allclose(got, ref, rtol=1e-11,
                                   atol=4 * F64_PREFIX * l1.sum() + 1e-300)
    else:
        tol = (k if k is not None else 4) * EPS32
        assert np.all(np.abs(got - ref) <= tol * l1 + 1e-30)


def _dtypes(dtype):
    return ((np.float64, jnp.float64, torch.float64) if dtype == "f64"
            else (np.float32, jnp.float32, torch.float32))


def _factors(bp, r, seed, k=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, bp.n, r)) for _ in range(k)]


# ---------------------------------------------------------------------------
# DenseBucketData.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_bucket_fields_match(name, dtype):
    jbk, tbk, bp = _buckets(name, dtype)
    assert tbk.dense and not tbk.split and jbk.dense
    for f in t_pat.DENSE_META_FIELDS:
        assert getattr(tbk, f) == getattr(jbk, f), f
    assert tbk.a_single_dense == (name != "multiblock30")
    fields = t_pat.DENSE_FIELDS + (t_pat.DENSE_DD_FIELDS
                                   if tbk.a_single_dense else ())
    for f in fields:
        a, b = getattr(tbk, f).numpy(), np.asarray(getattr(jbk, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), f)
    if name == "mc_gtoy60":
        assert tbk.nnz_dd == tbk.n and not bool(tbk.a2_full.any())
    n, m = tbk.n, bp.m_loc
    lin = np.asarray(jbk.a_lin[0])
    lin_t = np.asarray(jbk.a_lin_t[0])
    con = np.asarray(jbk.a_con_loc[0])
    val = np.asarray(jbk.a_val[0], np.float64)
    mir = np.asarray(jbk.a_val_mirror[0], np.float64)
    inner = np.asarray(jbk.a_val_inner[0], np.float64)

    def csr(key, S, *cols):
        """The sorted layout's keys (from its bounds) and columns."""
        bnd = key[0].numpy()
        k = np.repeat(np.arange(S), np.diff(bnd))
        assert bnd[0] == 0 and np.all(np.diff(bnd) >= 0)
        return sorted(zip(k, *(c[0].numpy()[:k.size].tolist()
                               for c in cols)))

    def want(key, *cols):
        keep = cols[-1] != 0
        return sorted(zip(key[keep], *(c[keep].tolist() for c in cols)))

    # (i) A(.) by constraint; (ii) A^*(w) by flat slot, with the mirrors
    assert csr(tbk.bnd_a_con_cs, m, tbk.a_lin_cs, tbk.a_val_inner_cs) \
        == want(con, lin, inner.astype(dtype).astype(np.float64))
    assert csr(tbk.bnd_a_lin2, n * n, tbk.a_con2_s, tbk.a_val2_s) == want(
        np.concatenate([lin, lin_t]), np.concatenate([con, con]),
        np.concatenate([val, mir]).astype(dtype).astype(np.float64))
    if tbk.a_single_dense:
        # (iii) the diagonal-only entries by constraint and by row
        dd = [np.asarray(getattr(jbk, f)[0]) for f in ("dd_con", "dd_row",
                                                      "dd_val")]
        dd[2] = dd[2].astype(np.float64)
        assert csr(tbk.bnd_dd_con, m, tbk.dd_row_cs, tbk.dd_val_cs) \
            == want(dd[0], dd[1], dd[2])
        assert csr(tbk.bnd_dd_row, n, tbk.dd_con_rs, tbk.dd_val_rs) \
            == want(dd[1], dd[0], dd[2])
    # interop builds the same bucket from lorads_tpu's arrays
    ibk = interop.bucket_from_numpy(jbk, dtype=tbk.dtype)
    for f in dataclasses.fields(tbk):
        a, b = getattr(ibk, f.name), getattr(tbk, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# The dense ops: plain versions against lorads_tpu.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_dense_products_match(name, dtype):
    """uvt, uvt_pair, obj_inner and w_mul (torch.matmul)."""
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    r = bp.rank
    R, D = _factors(bp, r, 4)
    Rj, Dj, Rt, Dt = (jnp.asarray(R, jdt), jnp.asarray(D, jdt), _t(R, tdt),
                      _t(D, tdt))
    ab = _abs_bucket(tbk)
    _close(t_pat.uvt(tbk, Rt, Dt), tpu_pat.uvt(jbk, Rj, Dj),
           t_pat.uvt(ab, _t(np.abs(R)), _t(np.abs(D))), dtype, k=r)
    (trd, tdd) = t_pat.uvt_pair(tbk, Rt, Dt)
    (jrd, jdd) = tpu_pat.uvt_pair(jbk, Rj, Dj)
    (ard, add) = t_pat.uvt_pair(ab, _t(np.abs(R)), _t(np.abs(D)))
    _close(trd, jrd, ard, dtype, k=r)
    _close(tdd, jdd, add, dtype, k=r)
    X = tpu_pat.uvt(jbk, Rj, Dj)
    _close(t_pat.obj_inner(tbk, _t(np.asarray(X), tdt)),
           tpu_pat.obj_inner(jbk, X),
           t_pat.obj_inner(ab, _t(np.abs(np.asarray(X)))), dtype,
           k=bp.n * bp.n)
    W = np.random.default_rng(5).standard_normal((1, bp.n, bp.n))
    W = W + W.transpose(0, 2, 1)
    _close(t_pat.w_mul(tbk, _t(W, tdt), Rt), tpu_pat.w_mul(
        jbk, jnp.asarray(W, jdt), Rj), t_pat.w_mul(
        ab, _t(np.abs(W)), _t(np.abs(R))), dtype, k=bp.n)
    _close(t_pat.w_mul_cached(tbk, _t(W, tdt), Rt,
                              t_pat.gather_cache(tbk, Rt)),
           tpu_pat.w_mul_cached(jbk, jnp.asarray(W, jdt), Rj,
                                tpu_pat.gather_cache(jbk, Rj)),
           t_pat.w_mul(ab, _t(np.abs(W)), _t(np.abs(R))), dtype, k=bp.n)
    with pytest.raises(ValueError):
        t_pat.densify_w(tbk, _t(W, tdt))


@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_dense_constr_vals_matches(name, dtype):
    """A(.) over the flat n^2 view (kernel K4, layout (i))."""
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    X = np.random.default_rng(6).standard_normal((1, bp.n, bp.n))
    X = 0.5 * (X + X.transpose(0, 2, 1))
    ref = np.asarray(tpu_pat.constr_vals(jbk, jnp.asarray(X, jdt)))
    got = t_pat.constr_vals(tbk, _t(X, tdt)).numpy()
    l1 = t_pat.constr_vals(_abs_bucket(tbk), _t(np.abs(X)))
    _close(got, ref, l1, dtype)
    # a constraint of one entry is that entry's product, exactly
    # (lorads_tpu's prefix-scan difference carries 2^-48 of the prefix)
    bnd = tbk.bnd_a_con_cs[0].numpy()
    one = np.diff(bnd) == 1
    assert one.any() == (name != "multiblock30")
    k = bnd[:-1][one]
    flat = _t(X, tdt).reshape(-1)
    prod = (tbk.a_val_inner_cs[0][k] * flat[tbk.a_lin_cs[0][k].long()])
    np.testing.assert_array_equal(got[0, one], prod.numpy())


@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("include_obj", [True, False])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_dense_build_w_matches(name, include_obj, dtype):
    """C + A^*(w) onto the n^2 slots (kernel K4, layout (ii))."""
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    w = np.random.default_rng(7).standard_normal((1, bp.m_loc))
    ref = tpu_pat.build_w(jbk, jnp.asarray(w, jdt), include_obj=include_obj)
    got = t_pat.build_w(tbk, _t(w, tdt), include_obj=include_obj)
    l1 = t_pat.build_w(_abs_bucket(tbk), _t(np.abs(w)),
                       include_obj=include_obj)
    assert got.shape == (1, bp.n, bp.n)
    _close(got, ref, l1, dtype)


@pytest.mark.parametrize("name", ["theta24", "theta_gtoy60", "mc_gtoy60"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_a_adj_a_dense_matches(name, dtype):
    """A^*(A(.)) of single-entry / diagonal-only constraints: K7a and
    the two dd sums (K4, layout (iii))."""
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    X = np.random.default_rng(8).standard_normal((1, bp.n, bp.n))
    X = 0.5 * (X + X.transpose(0, 2, 1))
    ref = tpu_pat.a_adj_a_dense(jbk, jnp.asarray(X, jdt))
    got = t_pat.a_adj_a_dense(tbk, _t(X, tdt))
    # sum|terms|: the dd composition's two sums, fed |values|
    ab = _abs_bucket(tbk)
    d = torch.diagonal(_t(np.abs(X)), dim1=1, dim2=2).contiguous()
    v = kernels.gather_segsum_plain(d, ab.dd_row_cs, ab.dd_val_cs,
                                    ab.bnd_dd_con)
    W_d = kernels.gather_segsum_plain(v, ab.dd_con_rs, ab.dd_val_rs,
                                      ab.bnd_dd_row)
    l1 = kernels.adj_a_dense_plain(_t(np.abs(X)), ab.a2_full, W_d)
    _close(got, ref, l1, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_diag", [False, True])
def test_adj_a_dense_plain_is_the_formula(dtype, with_diag):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(9)
    X, a2 = rng.standard_normal((2, 1, 17, 17)).astype(npdt)
    W_d = rng.standard_normal((1, 17)).astype(npdt) if with_diag else None
    before = kernels.LAUNCHES["adj_a_dense"]
    got = kernels.adj_a_dense(_t(X, dtype), _t(a2, dtype),
                              None if W_d is None else _t(W_d, dtype))
    want = a2 * X
    if W_d is not None:
        want = want + np.eye(17, dtype=npdt)[None] * W_d[:, :, None]
    np.testing.assert_array_equal(got.numpy(), want)
    assert kernels.LAUNCHES["adj_a_dense"] == before   # CPU: plain version
    with pytest.raises(ValueError):
        kernels.adj_a_dense(_t(X, dtype), _t(a2, dtype)[:, :16, :16])
    with pytest.raises(ValueError):
        kernels.adj_a_dense(_t(X, dtype)[:, :16], _t(a2, dtype)[:, :16])


def test_scale_bucket_scales_c_full():
    problem = _problem("theta_gtoy60")
    ps = tpu_presolve.presolve(problem, TpuParams())
    jpd = tpu_aop.scale_objective(tpu_aop.build_problem_data(
        ps, jnp.float64), 5.0)
    tpd0 = t_aop.build_problem_data(ps, torch.float64, "cpu")
    tpd = t_aop.scale_objective(tpd0, 5.0)
    np.testing.assert_array_equal(tpd.buckets[0].c_full.numpy(),
                                  np.asarray(jpd.buckets[0].c_full))
    np.testing.assert_array_equal(tpd.buckets[0].c_full.numpy(),
                                  5.0 * tpd0.buckets[0].c_full.numpy())
    W = t_pat.build_w(tpd.buckets[0], torch.zeros((1, problem.m),
                                                  dtype=torch.float64))
    np.testing.assert_array_equal(W.numpy(), tpd.buckets[0].c_full.numpy())


# ---------------------------------------------------------------------------
# CG on the dense ADMM operator.
# ---------------------------------------------------------------------------

def _cg_setup(name):
    """(reference op_hi, op_lo, port op_hi, op_lo, x0, b) for the U-side
    operator x + A^*(A(sym(x F^T))) @ F."""
    jbk, tbk, bp = _buckets(name)
    rng = np.random.default_rng(12)
    F = 0.3 * rng.standard_normal((1, bp.n, bp.rank))
    x0 = 0.1 * rng.standard_normal((1, bp.n, bp.rank))
    b = rng.standard_normal((1, bp.n, bp.rank))

    def jop(bk, Fx):
        def op(x):
            uv = tpu_pat.uvt_half_cached(bk, x, Fx, None)
            if bk.a_single_dense:
                Wop = tpu_pat.a_adj_a_dense(bk, uv)
            else:
                Wop = tpu_pat.build_w(bk, tpu_pat.constr_vals(bk, uv),
                                      include_obj=False)
            return x + tpu_pat.w_mul_cached(bk, Wop, Fx, None)
        return op

    Fj = jnp.asarray(F)
    return (jop(jbk, Fj), jop(tpu_pat.cast_floats(jbk), Fj.astype(jnp.float32)),
            t_admm._cg_operator(tbk, _t(F)),
            t_admm._cg_operator(t_pat.cast_floats(tbk, torch.float32),
                                _t(F, torch.float32)), x0, b)


def _solutions_agree(thi, jhi, tx, jx, b, tol):
    """Both stop within the reference criterion, so (op = I + PSD,
    ||op^-1|| <= 1) the two solutions differ by at most the sum of
    their residuals; at tol 1e-10 they agree to rtol 1e-8."""
    jx = np.asarray(jx)
    r_t = float(torch.linalg.vector_norm(_t(b) - thi(tx)))
    r_j = float(np.linalg.norm(np.asarray(b) - np.asarray(
        jhi(jnp.asarray(jx)))))
    l1b = np.abs(b).sum()
    assert r_t / l1b < tol and r_j / l1b < tol
    assert np.linalg.norm(tx.numpy() - jx) <= r_t + r_j
    if tol <= 1e-10:
        np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-8, atol=1e-11)


@pytest.mark.parametrize("name", ["theta_gtoy60", "multiblock30"])
@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_dense_cg_solve_matches(name, tol):
    jhi, _, thi, _, x0, b = _cg_setup(name)
    jx, jk = tpu_cg.cg_solve(jhi, jnp.asarray(x0), jnp.asarray(b), tol, 800)
    tx, tk = t_cg.cg_solve(thi, _t(x0), _t(b), tol, 800)
    assert tk == int(jk) > 0
    _solutions_agree(thi, jhi, tx, jx, b, tol)


@pytest.mark.parametrize("name", ["theta_gtoy60", "multiblock30"])
@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_dense_cg_solve_ir_matches(name, tol):
    """The mixed-precision CG: the same iteration count."""
    jhi, jlo, thi, tlo, x0, b = _cg_setup(name)
    jx, jk = tpu_cg.cg_solve_ir(jhi, jlo, jnp.asarray(x0), jnp.asarray(b),
                                tol, 800)
    tx, tk = t_cg.cg_solve_ir(thi, tlo, _t(x0), _t(b), tol, 800)
    assert tk == int(jk) > 0
    _solutions_agree(thi, jhi, tx, jx, b, tol)


# ---------------------------------------------------------------------------
# ALM and ADMM from the same state; the spectral repair from lorads_tpu's.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gtoy60_solvers():
    problem = _problem("theta_gtoy60")
    return (TpuSolver(problem, TpuParams(verbose=False)),
            TorchSolver(problem, TorchParams(verbose=False), device="cpu"))


def test_first_alm_inner_iterates_match_theta(gtoy60_solvers):
    js, ts = gtoy60_solvers
    np.testing.assert_array_equal(ts.R.cones[0].numpy(),
                                  np.asarray(js.R.cones[0]))
    assert ts.lbfgs_len == js.lbfgs_len == 4          # n = 60 > 20, dense
    assert ts.params.alm_rho_factor == js.params.alm_rho_factor
    rho, p = js.ps.rho0, js.params
    jcs, jg, jcert = tpu_alm.alm_recompute(js.pd, js.R, js.dual, rho)
    tcs, tg, tcert = t_alm.alm_recompute(ts.pd, ts.R, ts.dual, rho)
    np.testing.assert_allclose(tg.cones[0].numpy(), np.asarray(jg.cones[0]),
                               rtol=1e-11, atol=1e-12)
    args = (0.0, 0.0, p.end_tau_tol, p.phase1_tol, False)
    for k in range(1, 6):
        jR, _, _, jcsk, jinfo = tpu_alm.inner_chunk(
            js.pd, js.R, jg, js.hist, js.dual, jcs, jcert, rho, *args, k)
        tR, _, _, tcsk, tinfo, _ = t_alm._inner_loop(
            ts.pd, ts.R, tg, ts.hist, ts.dual, tcs, float(tcert), rho,
            *args, k)
        assert tinfo["local_iter"] == int(jinfo["local_iter"])
        assert tinfo["tau"] == pytest.approx(float(jinfo["tau"]), rel=1e-9)
        np.testing.assert_allclose(tR.cones[0].numpy(),
                                   np.asarray(jR.cones[0]), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(tcsk.numpy(), np.asarray(jcsk),
                                   rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def gtoy60_reference(gtoy60_solvers):
    """lorads_tpu's whole theta_gtoy60 solve, with its state captured
    just before the dual refinement and the spectral repair's outcome."""
    js, _ = gtoy60_solvers
    seen = {}
    refine = js._try_dual_refine
    js.log = _log_into(seen.setdefault("log", []))

    def capture(admm_stats):
        seen["state"] = dict(
            U=js.U, V=js.V, dual=np.asarray(js.dual), scale=js.scale_obj_his,
            pobj=js.pobj, dobj=js.dobj, gap=js.gap,
            dinf=admm_stats.dinf_l1)
        return refine(admm_stats)

    repair = tpu_solver.try_spectral_repair

    def spy(solver, admm_stats):
        seen["repair"] = repair(solver, admm_stats)
        return seen["repair"]

    js._try_dual_refine = capture
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_solver, "try_spectral_repair", spy)
        seen["result"] = js.solve()
    return seen


@pytest.fixture(scope="module")
def gtoy60_post_alm():
    """lorads_tpu's theta_gtoy60 solver right after its ALM phase, and
    the ADMM rho it hands over."""
    ks = TpuSolver(_problem("theta_gtoy60"), TpuParams(verbose=False))
    alm_stats = tpu_alm.ALMStats(rho=ks.ps.rho0)
    ks.alm_phase(alm_stats, time.time())
    admm_stats = tpu_admm.ADMMStats(rho=ks.ps.rho0)
    ks.alm_to_admm(alm_stats, admm_stats)
    return ks, admm_stats.rho


@pytest.mark.parametrize("mixed", [False, True])
def test_admm_cg_sweep_from_lorads_tpu_state_theta(gtoy60_post_alm, mixed):
    """One U-then-V sweep with CG on the K7a operator from lorads_tpu's
    post-ALM state: the same CG count, factors at rtol 1e-8 of their
    scale."""
    ks, rho = gtoy60_post_alm
    jl, jlp, jtot, packed = tpu_admm.admm_init_eval(
        ks.pd, ks.U, ks.V, ks.dual, jnp.asarray(ks.scale_obj_his))
    cg_tol = min(float(packed[2]) * 1e-2, 1e-8)
    jU, jV, jl2, _, jcs, jcg, _, _ = tpu_admm.admm_update_all(
        ks.pd, ks.U, ks.V, jl, jlp, jtot, ks.dual, rho, cg_tol, 800,
        mixed=mixed)
    st = interop.state_from_numpy(U=ks.U, V=ks.V, dual=np.asarray(ks.dual))
    tpd = t_aop.scale_objective(
        t_aop.build_problem_data(ks.ps, torch.float64, "cpu"),
        ks.scale_obj_his)
    tl, ttot, _ = t_admm.admm_init_eval(tpd, st["U"], st["V"], st["dual"],
                                        ks.scale_obj_his)
    np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=1e-10,
                               atol=1e-12)
    lo = (tuple(t_pat.cast_floats(bk, torch.float32)
                for bk in tpd.buckets) if mixed else None)
    tU, tV, tl2, tcs, _, _, tcg = t_admm.admm_update_all(
        tpd, st["U"], st["V"], tl, ttot, st["dual"], rho, cg_tol=cg_tol,
        buckets_lo=lo)
    assert tcg == int(jcg) > 0
    for a, b in ((tU.cones[0], jU.cones[0]), (tV.cones[0], jV.cones[0]),
                 (tl2[0], jl2[0]), (tcs, jcs)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max())


def test_spectral_repair_from_lorads_tpu_state(gtoy60_reference):
    """The port's certificate and spectral repair at lorads_tpu's
    post-ADMM state: the same dinf before, the repair accepted in both
    packages, dinf inside the band after, dObj unchanged (every step is
    b-orthogonal).  Eigenvectors inside theta's clustered spectrum come
    out in other bases from the two libraries, so the rounds are not
    compared."""
    st = gtoy60_reference["state"]
    assert gtoy60_reference["repair"] is True
    problem = _problem("theta_gtoy60")
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    ts.pd = t_aop.scale_objective(ts.pd, st["scale"])
    ts.scale_obj_his = st["scale"]
    ts.dual = _t(st["dual"])
    ts.pobj, ts.dobj, ts.gap = st["pobj"], st["dobj"], st["gap"]
    lp_part, lams = ts._dual_infeas_pass()
    dinf = (lp_part + float(np.sum(np.abs(np.minimum(lams[0], 0.0))))) / (
        st["scale"] * (ts.pd.c_nrm1 + 1.0))
    assert dinf == pytest.approx(st["dinf"], rel=1e-7)
    band = 5 * ts.params.phase2_tol
    assert dinf > band
    stats = ADMMStats(rho=1.0, dobj=st["dobj"], gap=st["gap"],
                      dinf_l1=dinf)
    syncs = t_dev.HOST_SYNCS
    assert t_repair.try_spectral_repair(ts, stats) is True
    assert t_dev.HOST_SYNCS > syncs
    info = ts.spectral_repair_info
    assert info["accepted"] and info["rounds"] >= 2
    assert info["dinf_before"] == dinf
    assert stats.dinf_l1 == info["dinf_after"] <= band
    assert stats.dobj == pytest.approx(st["dobj"], rel=1e-10)
    # the reported dinf is the certificate of the kept dual
    lp_part, lams = ts._dual_infeas_pass()
    again = (lp_part + float(np.sum(np.abs(np.minimum(lams[0], 0.0))))) / (
        st["scale"] * (ts.pd.c_nrm1 + 1.0))
    assert again == pytest.approx(stats.dinf_l1, rel=1e-9)


def test_dense_lanczos_certificate_matches_eigh(monkeypatch):
    """A dense slack above the exact-eigh size takes Lanczos on the
    dense W @ x matvec (torch.matmul at f32, one f64 Rayleigh quotient):
    its lowest eigenvalue agrees with the exact eigh's."""
    problem = _problem("theta_gtoy60")
    ps = tpu_presolve.presolve(problem, TpuParams())
    tpd = t_aop.build_problem_data(ps, torch.float64, "cpu")
    rng = np.random.default_rng(14)
    dual = _t(0.05 * rng.standard_normal(problem.m))
    v0 = [_t(rng.standard_normal((1, tpd.buckets[0].n)))]
    lam_e, res_e, _, _ = t_solver._dual_infeas_device(tpd, dual, v0)
    assert int(res_e[0]) == -1
    monkeypatch.setattr(t_solver, "_DENSE_EIG_DIM", tpd.buckets[0].n - 1)
    lam_l, res_l, _, _ = t_solver._dual_infeas_device(tpd, dual, v0)
    assert int(res_l[0]) >= 0
    exact = float(lam_e[0][0])
    assert abs(float(lam_l[0][0]) - exact) <= 1e-6 * abs(exact)


# ---------------------------------------------------------------------------
# Whole solves.
# ---------------------------------------------------------------------------

def _log_into(lines):
    return lambda *a, **k: lines.append(" ".join(map(str, a)))


def _torch_solve(problem):
    """(solver, result, log lines) of the port's solve on the CPU."""
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    lines = []
    ts.log = _log_into(lines)
    return ts, ts.solve(), lines


def _outer_rows(lines):
    """[(outer, cumulative inner, pObj, dObj, pinf_l1, pinf_inf, gap)]
    of each outer iteration a log reports."""
    rows = []
    for line in lines:
        m = OUTER_LINE.search(line)
        if m:
            g = m.groups()
            rows.append((int(g[0]), int(g[1])) + tuple(map(float, g[2:])))
    return rows


def _assert_common_outer_path(jlog, tlog, n_outer):
    """The first n_outer ALM outer iterations: the same inner counts and
    the same logged pObj, dObj, pinf and gap (six digits, so rtol 1e-5)."""
    jrows, trows = _outer_rows(jlog), _outer_rows(tlog)
    assert len(jrows) >= n_outer and len(trows) >= n_outer
    for j, t in zip(jrows[:n_outer], trows[:n_outer]):
        assert t[:2] == j[:2]
        np.testing.assert_allclose(t[2:], j[2:], rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def gtoy60_torch():
    return _torch_solve(_problem("theta_gtoy60"))


def _assert_outcome(jr, j_repaired, ts, tr):
    p = TorchParams()
    assert jr.status.value == "primal_dual_optimal" and j_repaired
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert ts.spectral_repair_info["accepted"]
    assert abs(tr.pobj - jr.pobj) <= POBJ_RTOL * abs(jr.pobj)
    assert tr.pinf_l1 <= p.phase2_tol
    assert tr.gap <= 5 * p.phase2_tol
    assert tr.dinf_l1 <= 5 * p.phase2_tol
    assert tr.admm_stats.iter > 0 and ts.admm_cg_total > 0
    assert np.all(np.isfinite(tr.dual))
    assert bool(torch.isfinite(tr.R.cones[0]).all())


def test_theta_gtoy60_solve_matches_lorads_tpu(gtoy60_reference,
                                               gtoy60_torch):
    jr = gtoy60_reference["result"]
    ts, tr, _ = gtoy60_torch
    _assert_outcome(jr, gtoy60_reference["repair"], ts, tr)
    assert ts.pd.buckets[0].dense and ts.pd.buckets[0].a_single_dense
    assert "dense(full lower triangle)" in ts.prob_info()


def test_theta_gtoy60_alm_path_matches_lorads_tpu(gtoy60_reference,
                                                  gtoy60_torch):
    """The common path: ALM outer iterations 1-12 (51 inner steps), the
    same counts and logged objectives in both packages."""
    _assert_common_outer_path(gtoy60_reference["log"], gtoy60_torch[2], 12)


def _solve_both(name):
    problem = _problem(name)
    seen = {}
    repair = tpu_solver.try_spectral_repair

    def spy(solver, admm_stats):
        seen["repair"] = repair(solver, admm_stats)
        return seen["repair"]

    js = TpuSolver(problem, TpuParams(verbose=False))
    jlog = []
    js.log = _log_into(jlog)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_solver, "try_spectral_repair", spy)
        jr = js.solve()
    ts, tr, tlog = _torch_solve(problem)
    return (jr, seen.get("repair", False), ts, tr), jlog, tlog


def test_theta40_solve_matches_lorads_tpu():
    """The instance of tests/test_dual_repair.py's theta repair test:
    the common path through ALM outer 11, then the outcome."""
    outcome, jlog, tlog = _solve_both("theta40")
    _assert_common_outer_path(jlog, tlog, 11)
    _assert_outcome(*outcome)


@pytest.mark.slow
def test_theta300_solve_matches_lorads_tpu():
    outcome, jlog, tlog = _solve_both("theta300")
    _assert_common_outer_path(jlog, tlog, 17)
    _assert_outcome(*outcome)


def test_failed_spectral_repair_raises_for_dual_refine(monkeypatch):
    """When the spectral repair is not accepted, the port goes on to the
    CGNR dual refinement, as lorads_tpu does, instead of raising: it
    logs the "dual refine:" line, and a step that lowers no dinf is
    rejected with the dual, dObj and gap left as they were (the caller
    then runs the level-2 reopt)."""
    problem = _problem("theta24")
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    lines = []
    ts.log = _log_into(lines)
    monkeypatch.setattr(t_solver, "try_spectral_repair",
                        lambda solver, stats: False)
    dual0, dobj0, gap0 = ts.dual.clone(), ts.dobj, ts.gap
    # no candidate's dinf can fall below the stats' own
    assert ts._try_dual_refine(ADMMStats(rho=1.0, dinf_l1=0.0)) is False
    assert torch.equal(ts.dual, dual0) and (ts.dobj, ts.gap) == (dobj0,
                                                                 gap0)
    (line,) = [ln for ln in lines if ln.startswith("dual refine:")]
    assert line.endswith("-> rejected")
    info = ts.dual_refine_info
    assert not info["accepted"] and 0 < info["iters"] <= info["n_iter"]
