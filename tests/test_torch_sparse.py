"""lorads_torch's general sparse path vs lorads_tpu on the same inputs.

Two split buckets: tests/fixtures/matcomp500.dat-s (matrix completion:
one off-diagonal entry per constraint, every slot owned by one
constraint) and a seeded hand-built n = 300 problem whose constraints
share slots, hold several entries each, sit on the diagonal, and
include a trace constraint.  Checked here: the BucketData fields, the
plain versions of kernels K3p (uvt_pair), K4 (constr_vals, build_w), K5
(w_mul) and K6 (a_adj_a), the CG solvers on the matcomp500 ADMM
operator, the first ALM inner iterates, one ADMM sweep with CG, and the
Lanczos certificate of matcomp600.

lorads_tpu runs on CPU at f64 (conftest); the port on CPU tensors.
Tolerances:

* f64 sums: rtol 1e-11 plus 4 * 2^-48 * sum|terms| of the whole input:
  lorads_tpu's compensated prefix scan (lorads_tpu/ops/pattern.py:
  138-170) splits each term into two f32 planes (2^-48 of the term) and
  differences two prefix pairs (2^-48 of the prefix each);
* f32 sums: 4 * eps32 * sum|terms| of each output;
* A(.) where every constraint holds one entry (matcomp500): exact at
  either dtype, since lorads_tpu's single_segment_sum is an exact
  gather and K4 sums a one-entry segment exactly.
"""

import dataclasses
import functools
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
from lorads_tpu.core import problem as tpu_problem
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_tpu.ops import pattern as tpu_pat
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import alm as t_alm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import cg as t_cg
from lorads_torch.alg import solver as t_solver
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as t_pat


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIX = "tests/fixtures/"
EPS32 = float(np.finfo(np.float32).eps)
F64_PREFIX = 2.0 ** -48
BUCKETS = ["matcomp500", "hand300"]


def hand_split_problem():
    """n = 300, union density < 0.1: an objective with off entries, a
    trace constraint, 40 single diagonal constraints, 20 constraints
    that mix a diagonal and an off entry, and 120 off constraints of
    1-3 entries drawn from a pool of 150 slots (so slots are shared)."""
    rng = np.random.default_rng(21)
    n = 300
    rows = rng.integers(1, n, 900)
    cols = (rows * rng.random(900)).astype(np.int64)
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)
    pool = pairs[rng.choice(len(pairs), 150, replace=False)]
    obj_pairs = pairs[rng.choice(len(pairs), 500, replace=False)]
    obj_row = np.concatenate([np.arange(n), obj_pairs[:, 0]])
    obj_col = np.concatenate([np.arange(n), obj_pairs[:, 1]])
    obj_val = np.concatenate([2.0 + rng.random(n),
                              rng.standard_normal(len(obj_pairs))])
    con, arow, acol, aval = [], [], [], []

    def add(k, r, c, v):
        con.append(k), arow.append(r), acol.append(c), aval.append(v)

    for i in range(n):                                   # trace
        add(0, i, i, 1.0)
    diag_rows = rng.choice(n, 60, replace=False)
    for k, i in enumerate(diag_rows[:40], start=1):      # X_ii
        add(k, i, i, 0.5 + rng.random())
    for k, i in enumerate(diag_rows[40:], start=41):     # diag + off
        add(k, i, i, 1.0)
        r, c = pool[rng.integers(len(pool))]
        add(k, r, c, rng.standard_normal())
    for k in range(61, 181):                             # off only
        for s in rng.choice(len(pool), rng.integers(1, 4), replace=False):
            add(k, pool[s][0], pool[s][1], rng.standard_normal())
    m = 181
    blk = tpu_problem.SDPBlockData(
        dim=n, m=m, obj_row=obj_row.astype(np.int32),
        obj_col=obj_col.astype(np.int32), obj_val=obj_val,
        a_con=np.asarray(con, np.int32), a_row=np.asarray(arow, np.int32),
        a_col=np.asarray(acol, np.int32), a_val=np.asarray(aval))
    return tpu_problem.SDPProblem(m=m, rhs=rng.standard_normal(m),
                                  blocks=[blk])


def _problem(name):
    if name == "matcomp500":
        return tpu_sdpa.read_sdpa(FIX + "matcomp500.dat-s")
    return hand_split_problem()


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
    """The f64 bucket with |values|: feeding it |inputs| gives the sum
    of |terms| of every output."""
    return dataclasses.replace(tbk, **{
        f: getattr(tbk, f).abs().double() for f in t_pat.ALL_FLOAT_FIELDS})


def _close(got, ref, l1, dtype, exact=None):
    """got vs ref under the module's tolerances; ``l1`` is sum|terms|
    per output; ``exact`` marks outputs that must agree bit for bit."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    l1 = np.asarray(l1, np.float64)
    assert got.shape == ref.shape
    if dtype == "f64":
        np.testing.assert_allclose(got, ref, rtol=1e-11,
                                   atol=4 * F64_PREFIX * l1.sum() + 1e-300)
    else:
        assert np.all(np.abs(got - ref) <= 4 * EPS32 * l1 + 1e-30)
    if exact is not None:
        np.testing.assert_array_equal(got[exact], ref[exact])


def _dtypes(dtype):
    return ((np.float64, jnp.float64, torch.float64) if dtype == "f64"
            else (np.float32, jnp.float32, torch.float32))


# ---------------------------------------------------------------------------
# BucketData.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_bucket_fields_match(name, dtype):
    jbk, tbk, bp = _buckets(name, dtype)
    for f in t_pat.META_FIELDS:
        if f != "Ks":
            assert getattr(tbk, f) == getattr(jbk, f), f
    assert not tbk.diag_ident and tbk.split and not tbk.dense
    if name == "matcomp500":
        assert (tbk.has_diag_a, tbk.has_off_a, tbk.a_off_unique) == (
            False, True, True)
    else:
        assert (tbk.has_diag_a, tbk.has_off_a, tbk.a_off_unique) == (
            True, True, False)
    for f in t_pat.INT_FIELDS:
        np.testing.assert_array_equal(getattr(tbk, f).numpy(),
                                      np.asarray(getattr(jbk, f)), f)
        assert getattr(tbk, f).dtype == torch.int32
    for f in t_pat.FLOAT_FIELDS:
        a, b = getattr(tbk, f).numpy(), np.asarray(getattr(jbk, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the port-only entry list rebuilds the dense off pattern, with C's
    # values and, through the slots, with any W_o's
    n, Ko = tbk.n, tbk.Ko
    rng = np.random.default_rng(1)
    W_o = rng.standard_normal(Ko)
    want_c, want_w = np.zeros((n, n)), np.zeros((n, n))
    r, c = tbk.off_rows[0].numpy(), tbk.off_cols[0].numpy()
    for M, v in ((want_c, tbk.c_off[0].double().numpy()), (want_w, W_o)):
        np.add.at(M, (r, c), v)
        np.add.at(M, (c, r), v)
    sr, sc = tbk.sym_rows_rs[0].numpy(), tbk.sym_cols_rs[0].numpy()
    slot = tbk.sym_slot_rs[0].numpy()
    assert tbk.Ks == 2 * Ko and np.all(slot >= 0) and np.all(np.diff(sr) >= 0)
    got_c, got_w = np.zeros((n, n)), np.zeros((n, n))
    np.add.at(got_c, (sr, sc), tbk.c_sym_rs[0].double().numpy())
    np.add.at(got_w, (sr, sc), W_o[slot])
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(tbk.bnd_sym_rows[0].numpy(),
                                  np.searchsorted(sr, np.arange(n + 1)))
    # the constraint-sorted off entries: the same entries, CSR-bounded
    con = tbk.a_con_o_cs[0].numpy()
    assert np.all(np.diff(con) >= 0)
    np.testing.assert_array_equal(tbk.bnd_a_con_o_cs[0].numpy(),
                                  np.searchsorted(con, np.arange(bp.m_loc + 1)))
    key = lambda c_, p_, v_: sorted(zip(c_, p_, v_))  # noqa: E731
    assert key(con, tbk.a_pos_o_cs[0].numpy(), tbk.a_val_o_cs[0].numpy()) \
        == key(np.asarray(jbk.a_con_o[0]), np.asarray(jbk.a_pos_o[0]),
               np.asarray(jbk.a_val_o[0]))
    # interop builds the same bucket from lorads_tpu's arrays
    ibk = interop.bucket_from_numpy(jbk, dtype=tbk.dtype)
    for f in t_pat.META_FIELDS:
        assert getattr(ibk, f) == getattr(tbk, f), f
    for f in t_pat.ALL_INT_FIELDS + t_pat.ALL_FLOAT_FIELDS:
        assert torch.equal(getattr(ibk, f), getattr(tbk, f)), f


# ---------------------------------------------------------------------------
# K3p, K4, K5, K6: plain versions against lorads_tpu.
# ---------------------------------------------------------------------------

def _factors(bp, r, seed, k=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, bp.n, r)) for _ in range(k)]


@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("r", ["1", "rank"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_uvt_pair_matches(name, r, dtype):
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    R, D = _factors(bp, 1 if r == "1" else bp.rank, 4)
    (jrd, jdd) = tpu_pat.uvt_pair(jbk, jnp.asarray(R, jdt),
                                  jnp.asarray(D, jdt))
    (trd, tdd) = t_pat.uvt_pair(tbk, _t(R, tdt), _t(D, tdt))
    (ard, add) = t_pat.uvt_pair(_abs_bucket(tbk), _t(np.abs(R)),
                                _t(np.abs(D)))
    for got, ref, l1 in zip(trd + tdd, jrd + jdd, ard + add):
        _close(got, ref, l1, dtype)


@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_constr_vals_matches(name, dtype):
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    rng = np.random.default_rng(6)
    d = rng.standard_normal((1, bp.n))
    o = rng.standard_normal((1, tbk.Ko))
    ref = tpu_pat.constr_vals(jbk, (jnp.asarray(d, jdt), jnp.asarray(o, jdt)))
    got = t_pat.constr_vals(tbk, (_t(d, tdt), _t(o, tdt)))
    l1 = t_pat.constr_vals(_abs_bucket(tbk), (_t(np.abs(d)), _t(np.abs(o))))
    # where lorads_tpu sums by single_segment_sum (every constraint of
    # one entry, matcomp500) both sides are exact
    single = jbk.a_con_o_single and not jbk.has_diag_a
    assert single == (name == "matcomp500")
    _close(got, ref, l1, dtype, exact=single or None)


@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("include_obj", [True, False])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_build_w_matches(name, include_obj, dtype):
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    w = np.random.default_rng(7).standard_normal((1, bp.m_loc))
    jW = tpu_pat.build_w(jbk, jnp.asarray(w, jdt), include_obj=include_obj)
    tW = t_pat.build_w(tbk, _t(w, tdt), include_obj=include_obj)
    aW = t_pat.build_w(_abs_bucket(tbk), _t(np.abs(w)),
                       include_obj=include_obj)
    for got, ref, l1 in zip(tW, jW[:2], aW):
        _close(got, ref, l1, dtype)


@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("r", ["1", "rank"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_w_mul_matches(name, r, dtype):
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    rng = np.random.default_rng(8)
    w = rng.standard_normal((1, bp.m_loc))
    (X,) = _factors(bp, 1 if r == "1" else bp.rank, 9, k=1)
    jW = tpu_pat.build_w(jbk, jnp.asarray(w, jdt))
    tW = tuple(_t(np.asarray(a), tdt) for a in jW[:2])   # the same W
    Xj = jnp.asarray(X, jdt)
    ref = tpu_pat.w_mul(jbk, jW, Xj)
    got = t_pat.w_mul(tbk, tW, _t(X, tdt))
    l1 = t_pat.w_mul(_abs_bucket(tbk), tuple(a.abs().double() for a in tW),
                     _t(np.abs(X)))
    _close(got, ref, l1, dtype)
    ref_c = tpu_pat.w_mul_cached(jbk, jW, Xj, tpu_pat.gather_cache(jbk, Xj))
    got_c = t_pat.w_mul_cached(tbk, tW, _t(X, tdt),
                               t_pat.gather_cache(tbk, _t(X, tdt)))
    _close(got_c, ref_c, l1, dtype)


@pytest.mark.parametrize("name", BUCKETS)
@pytest.mark.parametrize("r", ["1", "rank"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_a_adj_a_matches(name, r, dtype):
    npdt, jdt, tdt = _dtypes(dtype)
    jbk, tbk, bp = _buckets(name, npdt)
    X, F = _factors(bp, 1 if r == "1" else bp.rank, 10)
    Xj, Fj = jnp.asarray(X, jdt), jnp.asarray(F, jdt)
    ref = tpu_pat.a_adj_a(jbk, tpu_pat.uvt_half_cached(
        jbk, Xj, Fj, tpu_pat.gather_cache(jbk, Fj)))
    got = t_pat.a_adj_a(tbk, _t(X, tdt), _t(F, tdt))
    l1 = t_pat.a_adj_a(_abs_bucket(tbk), _t(np.abs(X)), _t(np.abs(F)))
    if tbk.has_diag_a:
        # two compositions: the first one's |terms| bound feeds the second
        ab = _abs_bucket(tbk)
        d1 = torch.sum(_t(np.abs(X)) * _t(np.abs(F)), -1)
        v1 = kernels.gather_segsum_plain(d1, ab.a_row_d, ab.a_val_d,
                                         ab.bnd_a_con_d)
        l1 = (kernels.gather_segsum_plain(v1, ab.a_con_d_s, ab.a_val_d_s,
                                          ab.bnd_a_row_d_s), l1[1])
    for g, e, a in zip(got, ref[:2], l1):
        _close(g, e, a, dtype)


def test_kernel_wrappers_check_inputs():
    i32 = torch.zeros((1, 3), dtype=torch.int32)
    x = torch.zeros((1, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels.gather_segsum(x[0], i32, x[:, :3], i32)
    with pytest.raises(TypeError):
        kernels.gather_segsum(x, i32.long(), x[:, :3], i32)
    with pytest.raises(TypeError):
        kernels.gather_segsum(x, i32, x[:, :3].float(), i32)
    X = torch.zeros((1, 4, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels.wmul_csr(X, x[:, :3], x, i32, i32,
                         torch.zeros((1, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.uvt_pair_split(X, X[:, :3], i32, i32)
    with pytest.raises(ValueError):
        kernels.adj_a_offdiag(X, X, i32, i32, x)


# ---------------------------------------------------------------------------
# CG on the matcomp500 ADMM operator.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mc500_cg():
    """(reference op_hi, op_lo, port op_hi, op_lo, x0, b) for the U-side
    operator x + A^*(A(sym(x F^T))) @ F of matcomp500."""
    jbk, tbk, bp = _buckets("matcomp500")
    rng = np.random.default_rng(12)
    F = 0.3 * rng.standard_normal((1, bp.n, bp.rank))
    x0 = 0.1 * rng.standard_normal((1, bp.n, bp.rank))
    b = rng.standard_normal((1, bp.n, bp.rank))

    def jop(bk, Fx):
        fc = tpu_pat.gather_cache(bk, Fx)

        def op(x):
            Wop = tpu_pat.a_adj_a(bk, tpu_pat.uvt_half_cached(bk, x, Fx, fc))
            return x + tpu_pat.w_mul_cached(bk, Wop, Fx, fc)
        return op

    Fj = jnp.asarray(F)
    jhi = jop(jbk, Fj)
    jlo = jop(tpu_pat.cast_floats(jbk), Fj.astype(jnp.float32))
    thi = t_admm._cg_operator(tbk, _t(F))
    tlo = t_admm._cg_operator(t_pat.cast_floats(tbk, torch.float32),
                              _t(F, torch.float32))
    return jhi, jlo, thi, tlo, x0, b


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_cg_solve_matches(mc500_cg, tol):
    jhi, _, thi, _, x0, b = mc500_cg
    jx, jk = tpu_cg.cg_solve(jhi, jnp.asarray(x0), jnp.asarray(b), tol, 800)
    tx, tk = t_cg.cg_solve(thi, _t(x0), _t(b), tol, 800)
    assert tk == int(jk) > 0
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_cg_solve_ir_matches(mc500_cg, tol):
    jhi, jlo, thi, tlo, x0, b = mc500_cg
    jx, jk = tpu_cg.cg_solve_ir(jhi, jlo, jnp.asarray(x0), jnp.asarray(b),
                                tol, 800)
    tx, tk = t_cg.cg_solve_ir(thi, tlo, _t(x0), _t(b), tol, 800)
    assert tk == int(jk) > 0
    # the f32 sweeps round differently in the two packages, so the two
    # solutions differ by what the stopping rule leaves: op = I + (a
    # PSD map) has ||op^-1|| <= 1, so ||x_t - x_j|| <= ||r_t|| + ||r_j||
    # -- and at tol 1e-10 they agree to rtol 1e-9
    jx = np.asarray(jx)
    r_t = _t(b) - thi(tx)
    r_j = np.asarray(b) - np.asarray(jhi(jnp.asarray(jx)))
    l1b = np.abs(b).sum()
    assert float(torch.linalg.vector_norm(r_t)) / l1b < tol
    assert np.linalg.norm(r_j) / l1b < tol
    assert np.linalg.norm(tx.numpy() - jx) <= (
        float(torch.linalg.vector_norm(r_t)) + np.linalg.norm(r_j))
    if tol <= 1e-10:
        np.testing.assert_allclose(tx.numpy(), jx, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# ALM and ADMM on matcomp500; the Lanczos certificate on matcomp600.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mc500_solvers():
    problem = _problem("matcomp500")
    return (TpuSolver(problem, TpuParams(verbose=False)),
            TorchSolver(problem, TorchParams(verbose=False), device="cpu"))


def test_first_alm_inner_iterates_match_matcomp(mc500_solvers):
    js, ts = mc500_solvers
    np.testing.assert_array_equal(ts.R.cones[0].numpy(),
                                  np.asarray(js.R.cones[0]))
    assert ts.params.alm_rho_factor == js.params.alm_rho_factor == 2.0
    rho, p = js.ps.rho0, js.params
    jcs, jg, jcert = tpu_alm.alm_recompute(js.pd, js.R, js.dual, rho)
    tcs, tg, tcert = t_alm.alm_recompute(ts.pd, ts.R, ts.dual, rho)
    np.testing.assert_allclose(tg.cones[0].numpy(), np.asarray(jg.cones[0]),
                               rtol=1e-11, atol=1e-12)
    # certificate and pinf exits off (cert_tol = end_sub_tol = 0,
    # gap_ok False): matcomp500's first pass exits after 2 iterations
    args = (0.0, 0.0, p.end_tau_tol, p.phase1_tol, False)
    for k in range(1, 6):
        jR, _, _, jcsk, jinfo = tpu_alm.inner_chunk(
            js.pd, js.R, jg, js.hist, js.dual, jcs, jcert, rho, *args, k)
        tR, _, _, tcsk, tinfo, _ = t_alm._inner_loop(
            ts.pd, ts.R, tg, ts.hist, ts.dual, tcs, float(tcert), rho,
            *args, k)
        assert tinfo["local_iter"] == int(jinfo["local_iter"]) == k
        assert tinfo["tau"] == pytest.approx(float(jinfo["tau"]), rel=1e-9)
        np.testing.assert_allclose(tR.cones[0].numpy(),
                                   np.asarray(jR.cones[0]), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(tcsk.numpy(), np.asarray(jcsk),
                                   rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def mc500_post_alm(mc500_solvers):
    """lorads_tpu's matcomp500 solver right after its ALM phase, and the
    ADMM rho it hands over."""
    js, _ = mc500_solvers
    alm_stats = tpu_alm.ALMStats(rho=js.ps.rho0)
    js.alm_phase(alm_stats, time.time())
    admm_stats = tpu_admm.ADMMStats(rho=js.ps.rho0)
    js.alm_to_admm(alm_stats, admm_stats)
    return js, admm_stats.rho


@pytest.mark.parametrize("mixed", [False, True])
def test_admm_cg_sweep_from_lorads_tpu_state(mc500_post_alm, mixed):
    """One U-then-V sweep with CG: the same CG counts, and the factors
    at rtol 1e-8 of the factor's scale (the CG solves stop at a residual
    of cg_tol, so elementwise agreement of small entries is not what
    either side guarantees)."""
    js, rho = mc500_post_alm
    jl, jlp, jtot, packed = tpu_admm.admm_init_eval(
        js.pd, js.U, js.V, js.dual, jnp.asarray(1.0))
    cg_tol = min(float(packed[2]) * 1e-2, 1e-8)
    jU, jV, jl2, _, jcs, jcg, _, _ = tpu_admm.admm_update_all(
        js.pd, js.U, js.V, jl, jlp, jtot, js.dual, rho, cg_tol, 800,
        mixed=mixed)

    st = interop.state_from_numpy(U=js.U, V=js.V, dual=np.asarray(js.dual))
    tpd = t_aop.build_problem_data(js.ps, torch.float64, "cpu")
    tl, ttot, vals = t_admm.admm_init_eval(tpd, st["U"], st["V"],
                                           st["dual"], 1.0)
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


def test_lanczos_certificate_matches_matcomp600():
    """n = 1200 > 1024: Lanczos with the W @ X matvec (kernel K5) at f32,
    refined by one f64 Rayleigh quotient."""
    problem = tpu_gen.matrix_completion(n1=600, n2=600, true_rank=3,
                                        frac_obs=0.12, seed=3)
    ps = tpu_presolve.presolve(problem, TpuParams())
    jpd = tpu_aop.build_problem_data(ps, jnp.float64)
    tpd = t_aop.build_problem_data(ps, torch.float64, "cpu")
    bk = tpd.buckets[0]
    assert bk.n > t_solver._DENSE_EIG_DIM and not bk.diag_ident
    rng = np.random.default_rng(13)
    dual = 0.05 * rng.standard_normal(problem.m)
    v0 = rng.standard_normal((1, bk.n))
    _, jl, jr, _, _ = tpu_solver._dual_infeas_device(
        jpd, jnp.asarray(dual), (jnp.asarray(v0),))
    tl, tr, _, _ = t_solver._dual_infeas_device(tpd, _t(dual), [_t(v0)])
    assert int(tr[0]) == int(jr[0]) >= 0
    lam_j, lam_t = float(jl[0][0]), float(tl[0][0])
    assert abs(lam_t - lam_j) <= 1e-6 * abs(lam_j)


@pytest.mark.parametrize("name", BUCKETS)
def test_identity_directions_and_repair_plan_match(name):
    """The dual repair's identity directions (hand300: the trace
    constraint; matcomp500: none) and the repair plan for a negative
    slack eigenvalue, on buckets without diagonal-identity constraints."""
    problem = _problem(name)
    js = TpuSolver(problem, TpuParams(verbose=False))
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    jd, td = js._identity_directions(), ts._identity_directions()
    assert len(jd) == len(td) == 1
    assert (jd[0] is None) == (td[0] is None) == (name == "matcomp500")
    if td[0] is not None:
        for a, b in zip(td[0], jd[0]):
            np.testing.assert_array_equal(a, b)
    js.pobj = ts.pobj = 1.0
    lams = [np.array([-0.25])]
    jp, tp = js._repair_plan(0.0, lams), ts._repair_plan(0.0, lams)
    assert (jp is None) == (tp is None)
    if tp is not None:
        np.testing.assert_array_equal(tp, jp)
