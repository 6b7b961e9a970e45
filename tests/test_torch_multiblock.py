"""lorads_torch's buckets of several blocks vs lorads_tpu on the same inputs.

Buckets with B > 1: merge_problems of lovasz_theta(n=40) and
lovasz_theta(n=60) (one dense bucket of two blocks, the first padded
from dim 40 to 60), merge_problems of three maxcut(n=300) (one split
diag-identity bucket of three blocks on disjoint slots) and
random_multiblock(3 blocks of dim 15, 4 LP columns) (one dense bucket
whose blocks share their constraints).  Checked here: the bucket
fields, the products, scatter_constr / gather_w on local slots and the
block slices of the bucket Gauss-Seidel scan, batched CG with blocks
that converge apart, one ADMM sweep with the scan and one with the
Jacobi sweep, whole solves, per-instance objectives of a merged batch,
and the multi-file CLI.

lorads_tpu runs on CPU at f64 (conftest); the port on CPU tensors.
Tolerances: fields bit for bit; products at rtol 1e-11 plus 2^-44 times
the output's sum |value| (lorads_tpu's compensated prefix scans carry
2^-48 of each prefix over the whole batch); the ADMM sweeps at the CG
tolerance's scale (stated in each test); whole solves as stated in
each test.
"""

import dataclasses
import functools
import math
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import alm as tpu_alm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg import cg as tpu_cg
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.core.problem import merge_problems as tpu_merge
from lorads_tpu.core.problem import split_objectives_factors as tpu_split
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.ops import pattern as tpu_pat
from lorads_torch import interop
from lorads_torch.__main__ import main as t_main
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import cg as t_cg
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.config import SolverStatus
from lorads_torch.core.problem import split_objectives as t_split_x
from lorads_torch.core.problem import split_objectives_factors as t_split
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as t_pat

FIX = "tests/fixtures/"
OUTER_LINE = re.compile(
    r"ALM Outer:(\d+) Inner:(\d+) pObj:(\S+) dObj:(\S+) pInf\(1\):(\S+) "
    r"pInf\(Inf\):(\S+) pdGap:(\S+)")


@functools.lru_cache(maxsize=None)
def _problem(name):
    if name == "theta40+60":
        return tpu_merge([tpu_gen.lovasz_theta(n=40, avg_degree=8, seed=1),
                          tpu_gen.lovasz_theta(n=60, avg_degree=8, seed=2)])
    if name == "maxcut300x3":
        return tpu_merge(_maxcut300s())
    return tpu_gen.random_multiblock(n_blocks=3, dim=15, m=12, n_lp=4,
                                     seed=13)


@functools.lru_cache(maxsize=None)
def _maxcut300s():
    return tuple(tpu_gen.maxcut(n=300, avg_degree=4, seed=s)
                 for s in (3, 4, 5))


@functools.lru_cache(maxsize=None)
def _buckets(name):
    """(lorads_tpu bucket, port bucket, presolved plan) at f64."""
    problem = _problem(name)
    ps = tpu_presolve.presolve(problem, TpuParams())
    assert len(ps.buckets) == 1
    bp = ps.buckets[0]
    return (tpu_pat.build_bucket_data(bp, problem.m, jnp.float64),
            t_pat.build_bucket_data(bp, problem.m, torch.float64, "cpu"), bp)


def _close(got, ref, rtol=1e-11):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=2.0 ** -44 * np.abs(ref).sum() + 1e-300)


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _factors(bp, r, seed):
    """Random [B, n, r] factors, each block's padded rows zeroed."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((bp.B, bp.n, r))
    for b, d in enumerate(bp.dims):
        X[b, d:] = 0.0
    return X


# ---------------------------------------------------------------------------
# Bucket fields and products at B > 1.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["theta40+60", "maxcut300x3", "rmb3"])
def test_bucket_fields_match(name):
    jbk, tbk, bp = _buckets(name)
    want = {"theta40+60": (True, 2, 60, [40, 60]),
            "maxcut300x3": (False, 3, 300, [300] * 3),
            "rmb3": (True, 3, 15, [15] * 3)}[name]
    assert (tbk.dense, tbk.B, tbk.n, list(bp.dims)) == want
    assert not tbk.glob_ident and not jbk.glob_ident
    if tbk.dense:
        metas = t_pat.DENSE_META_FIELDS
        fields = t_pat.DENSE_FIELDS + (t_pat.DENSE_DD_FIELDS
                                       if tbk.a_single_dense else ())
    else:
        assert tbk.diag_ident
        metas = t_pat.META_FIELDS + ("split", "dense")
        fields = (t_pat.INT_FIELDS + t_pat.FLOAT_FIELDS
                  + t_pat.SYM_INT_FIELDS + t_pat.SYM_FLOAT_FIELDS)
    for f in metas:
        assert getattr(tbk, f) == getattr(jbk, f), f
    for f in fields:
        a, b = getattr(tbk, f).numpy(), np.asarray(getattr(jbk, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    # the padded block's rows and columns of C are zero
    if name == "theta40+60":
        C = tbk.c_full[0].numpy()
        assert not C[40:].any() and not C[:, 40:].any() and C[:40].any()
    # the port's scatter list: every real (block, local slot), sorted
    # by its global slot, with CSR bounds over m
    g = np.asarray(jbk.glob_idx)
    flat = tbk.scat_idx[0].numpy()
    real = np.sort(np.nonzero(g.reshape(-1) < tbk.m_glob)[0])
    np.testing.assert_array_equal(np.sort(flat), real)
    gs = g.reshape(-1)[flat]
    assert np.all(np.diff(gs) >= 0)
    np.testing.assert_array_equal(tbk.bnd_scat[0].numpy(),
                                  np.searchsorted(gs, np.arange(
                                      tbk.m_glob + 1)))
    # interop builds the same bucket from lorads_tpu's arrays
    ibk = interop.bucket_from_numpy(jbk)
    for f in dataclasses.fields(tbk):
        a, b = getattr(ibk, f.name), getattr(tbk, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_sorted_prefix_bounds_leave_tail_padding_out():
    """A block with fewer diagonal constraint entries than the bucket's
    widest is padded at its tail with (constraint 0, value 0), which
    breaks the sort; its bounds cover the sorted prefix only, and the
    constraint sums equal a scatter by id."""
    ids = np.array([[0, 1, 1, 3, 0, 0], [0, 0, 2, 2, 3, 3]])
    bnd = t_pat.sorted_prefix_bounds(ids, 4)
    np.testing.assert_array_equal(bnd, [[0, 1, 3, 3, 4], [0, 2, 2, 4, 6]])
    rng = np.random.default_rng(11)
    vals = rng.standard_normal(ids.shape)
    vals[0, 4:] = 0.0
    x = rng.standard_normal((2, 6))
    got = kernels.gather_segsum(
        _t(x), torch.tensor(np.tile(np.arange(6), (2, 1)), dtype=torch.int32),
        _t(vals), torch.tensor(bnd, dtype=torch.int32))
    want = np.zeros((2, 4))
    for b in range(2):
        np.add.at(want[b], ids[b], vals[b] * x[b])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("name", ["theta40+60", "maxcut300x3", "rmb3"])
def test_products_match(name):
    """uvt, constr_vals, obj_inner, scatter_constr, gather_w, build_w
    and w_mul of the whole bucket."""
    jbk, tbk, bp = _buckets(name)
    U, V = _factors(bp, 3, 1), _factors(bp, 3, 2)
    juv = tpu_pat.uvt(jbk, jnp.asarray(U), jnp.asarray(V))
    tuv = t_pat.uvt(tbk, _t(U), _t(V))
    for a, b in zip(jax.tree.leaves(tuv), jax.tree.leaves(juv)):
        _close(a, b)
    jvals = tpu_pat.constr_vals(jbk, juv)
    tvals = t_pat.constr_vals(tbk, tuv)
    _close(tvals, jvals)
    _close(t_pat.obj_inner(tbk, tuv), tpu_pat.obj_inner(jbk, juv))
    _close(t_pat.scatter_constr(tbk, tvals), tpu_pat.scatter_constr(
        jbk, jvals))
    w = np.random.default_rng(3).standard_normal(tbk.m_glob)
    jw = tpu_pat.gather_w(jbk, jnp.asarray(w))
    tw = t_pat.gather_w(tbk, _t(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    JW = tpu_pat.build_w(jbk, jw)
    TW = t_pat.build_w(tbk, tw)
    for a, b in zip(jax.tree.leaves(TW), jax.tree.leaves(JW)):
        _close(a, b)
    _close(t_pat.w_mul(tbk, TW, _t(U)), tpu_pat.w_mul(jbk, JW,
                                                      jnp.asarray(U)))


@pytest.mark.parametrize("name", ["theta40+60", "rmb3"])
def test_bucket_slice_is_the_block(name):
    """bucket_slice(bk, b): block b as a B = 1 bucket whose A(.) and
    scatter agree with lorads_tpu's slice of the same block (the body
    of its bucket Gauss-Seidel scan)."""
    jbk, tbk, bp = _buckets(name)
    U = _factors(bp, 2, 4)
    w = np.random.default_rng(5).standard_normal(tbk.m_glob)
    for b in range(tbk.B):
        jb = jax.tree.map(lambda x: x[b:b + 1], jbk)
        tb = t_pat.bucket_slice(tbk, b)
        assert tb.B == 1 and tb.glob_idx.data_ptr() == (
            tbk.glob_idx.data_ptr() + b * tbk.m_loc * 4)
        juv = tpu_pat.uvt(jb, jnp.asarray(U[b:b + 1]),
                          jnp.asarray(U[b:b + 1]))
        tuv = t_pat.uvt(tb, _t(U[b:b + 1]), _t(U[b:b + 1]))
        jv = tpu_pat.constr_vals(jb, juv)
        tv = t_pat.constr_vals(tb, tuv)
        _close(tv, jv)
        _close(t_pat.scatter_constr(tb, tv), tpu_pat.scatter_constr(jb, jv))
        np.testing.assert_array_equal(
            t_pat.gather_w(tb, _t(w)).numpy(),
            np.asarray(tpu_pat.gather_w(jb, jnp.asarray(w))))


def test_cg_blocks_converge_apart():
    """Batched CG over B = 3 blocks of different conditioning (one of
    them a zero right-hand side, like an empty padded block): each
    block's iterate is the one it reaches alone, the count is the
    slowest block's, and lorads_tpu's batched CG takes the same count."""
    rng = np.random.default_rng(6)
    n, r = 12, 2
    mats = []
    for cond in (1.0, 30.0, 5.0):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        mats.append(Q @ np.diag(np.linspace(1.0, cond, n)) @ Q.T)
    M = np.stack(mats)
    b = rng.standard_normal((3, n, r))
    b[2] = 0.0

    def top(x):
        return torch.matmul(_t(M), x)

    x, k = t_cg.cg_solve(top, torch.zeros(3, n, r, dtype=torch.float64),
                         _t(b), 1e-10, 200)
    jx, jk = tpu_cg.cg_solve(lambda y: jnp.matmul(jnp.asarray(M), y),
                             jnp.zeros((3, n, r)), jnp.asarray(b), 1e-10, 200)
    assert k == int(jk)
    _close(x, jx, rtol=1e-9)
    ks = []
    for i in range(3):
        xi, ki = t_cg.cg_solve(lambda y, i=i: torch.matmul(_t(M[i:i + 1]), y),
                               torch.zeros(1, n, r, dtype=torch.float64),
                               _t(b[i:i + 1]), 1e-10, 200)
        ks.append(ki)
        np.testing.assert_array_equal(x[i:i + 1].numpy(), xi.numpy())
    assert k == max(ks) and ks[2] == 0 and ks[0] < ks[1]
    assert not x[2].any()


@pytest.mark.parametrize("name", ["theta40+60", "maxcut300x3"])
def test_certificate_matches_lorads_tpu(name):
    """The dual-infeasibility pass at B > 1 (a padded block included):
    each block's lowest slack eigenvalue and the pass's kind (exact
    eigh: restarts -1) as lorads_tpu finds them, at rtol 1e-8."""
    problem = _problem(name)
    dual = 0.5 * np.random.default_rng(10).standard_normal(problem.m)
    js = TpuSolver(problem, TpuParams(verbose=False))
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    js.dual = jnp.asarray(dual)
    ts.dual = _t(dual)
    jlp, jlams = js._dual_infeas_pass()
    tlp, tlams = ts._dual_infeas_pass()
    assert tlp == jlp == 0.0
    assert ts.last_cert_restarts == [int(r) for r in js.last_cert_restarts]
    assert len(tlams) == len(jlams) == 1 and tlams[0].shape == (
        ts.pd.buckets[0].B,)
    assert np.any(tlams[0] < 0)
    np.testing.assert_allclose(tlams[0], jlams[0], rtol=1e-8,
                               atol=1e-10 * np.abs(jlams[0]).max())


# ---------------------------------------------------------------------------
# One ADMM sweep.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _post_alm_rmb3():
    """lorads_tpu's random_multiblock(3, 15, 12, n_lp=4) solver right
    after its ALM phase, and the ADMM rho it hands over."""
    ks = TpuSolver(_problem("rmb3"), TpuParams(verbose=False))
    alm_stats = tpu_alm.ALMStats(rho=ks.ps.rho0)
    ks.alm_phase(alm_stats, time.time())
    admm_stats = tpu_admm.ADMMStats(rho=ks.ps.rho0)
    ks.alm_to_admm(alm_stats, admm_stats)
    return ks, admm_stats.rho


@pytest.mark.parametrize("lp_gs", [False, True])
def test_admm_sweep_bucket_scan_from_lorads_tpu_state(lp_gs):
    """The bucket Gauss-Seidel scan over three blocks that share their
    constraints, then the LP columns, from lorads_tpu's post-ALM state
    (mixed-precision CG, the default): the same CG count, factors and
    constraint values at 1e-6 of their scale (the CG stops at a
    relative residual of 1e-8 on systems whose condition number is in
    the hundreds)."""
    ks, rho = _post_alm_rmb3()
    jl, jlp, jtot, packed = tpu_admm.admm_init_eval(
        ks.pd, ks.U, ks.V, ks.dual, jnp.asarray(ks.scale_obj_his))
    cg_tol = min(float(packed[2]) * 1e-2, 1e-8)
    jU, jV, jl2, jlp2, jcs, jcg, _, _ = tpu_admm.admm_update_all(
        ks.pd, ks.U, ks.V, jl, jlp, jtot, ks.dual, rho, cg_tol, 800,
        mixed=True, lp_gs=lp_gs)
    st = interop.state_from_numpy(U=ks.U, V=ks.V, dual=np.asarray(ks.dual))
    tpd = t_aop.build_problem_data(ks.ps, torch.float64, "cpu")
    tl, ttot, _ = t_admm.admm_init_eval(tpd, st["U"], st["V"], st["dual"],
                                        ks.scale_obj_his)
    np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(tl[-1].numpy(), np.asarray(jlp), rtol=1e-10,
                               atol=1e-12)
    lo, slices, slices_lo = t_admm.sweep_plan(tpd, (False,), mixed=True)
    assert slices[0] is not None and len(slices[0]) == 3
    tU, tV, tl2, tcs, _, _, tcg = t_admm.admm_update_all(
        tpd, st["U"], st["V"], tl, ttot, st["dual"], rho, cg_tol=cg_tol,
        buckets_lo=lo, slices=slices, slices_lo=slices_lo, lp_gs=lp_gs)
    assert tcg == int(jcg) > 0
    for a, b in ((tU.cones[0], jU.cones[0]), (tV.cones[0], jV.cones[0]),
                 (tU.lp, jU.lp), (tV.lp, jV.lp), (tl2[0], jl2[0]),
                 (tl2[1], jlp2), (tcs, jcs)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("name", ["theta40+60", "maxcut300x3"])
def test_admm_sweep_jacobi_matches(name):
    """Blocks on disjoint constraint slots update at once (the solver's
    per-bucket Jacobi flag): CG over both theta blocks in one batch
    (the padded one included), the Max-Cut closed form over three
    blocks; from the same random state in both packages, the same CG
    count and factors at 1e-8 of their scale."""
    problem = _problem(name)
    ps = tpu_presolve.presolve(problem, TpuParams())
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    assert ts._bucket_jacobi == (True,)
    jpd = tpu_aop.build_problem_data(ps, jnp.float64)
    bp = ps.buckets[0]
    U, V = _factors(bp, 2, 7), _factors(bp, 2, 8)
    dual = np.random.default_rng(9).standard_normal(problem.m)
    jU = tpu_aop.FactorVec((jnp.asarray(U),), jnp.zeros(0))
    jV = tpu_aop.FactorVec((jnp.asarray(V),), jnp.zeros(0))
    jl, jlp, jtot, _ = tpu_admm.admm_init_eval(jpd, jU, jV,
                                               jnp.asarray(dual),
                                               jnp.asarray(1.0))
    rho = 2.0
    jU2, jV2, jl2, _, jcs, jcg, _, _ = tpu_admm.admm_update_all(
        jpd, jU, jV, jl, jlp, jtot, jnp.asarray(dual), rho, 1e-8, 800,
        jacobi=(True,), mixed=False)
    tpd = ts.pd
    st = interop.state_from_numpy(U=jU, V=jV, dual=dual)
    tl, ttot, _ = t_admm.admm_init_eval(tpd, st["U"], st["V"], st["dual"],
                                        1.0)
    lo, slices, slices_lo = t_admm.sweep_plan(tpd, ts._bucket_jacobi)
    assert slices == (None,)
    tU, tV, tl2, tcs, _, _, tcg = t_admm.admm_update_all(
        tpd, st["U"], st["V"], tl, ttot, st["dual"], rho, cg_tol=1e-8,
        slices=slices)
    assert tcg == int(jcg)
    assert (tcg > 0) == (name == "theta40+60")
    for a, b in ((tU.cones[0], jU2.cones[0]), (tV.cones[0], jV2.cones[0]),
                 (tl2[0], jl2[0]), (tcs, jcs)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max())
    # the padded rows stay zero
    for b, d in enumerate(bp.dims):
        assert not tU.cones[0][b, d:].any() and not tV.cones[0][b, d:].any()


# ---------------------------------------------------------------------------
# Whole solves.
# ---------------------------------------------------------------------------

def _log_into(lines):
    return lambda *a, **k: lines.append(" ".join(map(str, a)))


def _outer_rows(lines):
    rows = []
    for line in lines:
        m = OUTER_LINE.search(line)
        if m:
            g = m.groups()
            rows.append((int(g[0]), int(g[1])) + tuple(map(float, g[2:])))
    return rows


def _solve_both(problem, **params):
    jlog, tlog = [], []
    js = TpuSolver(problem, TpuParams(verbose=False, **params))
    js.log = _log_into(jlog)
    jr = js.solve()
    ts = TorchSolver(problem, TorchParams(verbose=False, **params),
                     device="cpu")
    ts.log = _log_into(tlog)
    tr = ts.solve()
    return js, jr, jlog, ts, tr, tlog


def test_random_multiblock_solve_matches_lorads_tpu():
    """Three dense blocks sharing their constraints (the bucket scan)
    and an LP block: both packages log the same ALM path through its
    exit (4 outer iterations, 69 inner steps: inner counts and logged
    objectives), then ADMM diverges in both and each restores its entry
    state and retries at the same rho; the divergence's own iterates
    carry no digits, and from there the packages take other counts to
    the same optimum.  pObj within 1e-5 (CPU: 2.0e-6)."""
    js, jr, jlog, ts, tr, tlog = _solve_both(_problem("rmb3"))
    assert jr.status.value == "primal_dual_optimal"
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    jrows, trows = _outer_rows(jlog), _outer_rows(tlog)
    assert len(jrows) >= 5 and len(trows) >= 5
    for j, t in zip(jrows[:5], trows[:5]):
        assert t[:2] == j[:2]
        np.testing.assert_allclose(t[2:], j[2:], rtol=1e-5, atol=0)
    retry = [ln for ln in tlog if ln.startswith("ADMM diverged")]
    assert retry and retry[0] in jlog
    assert abs(tr.pobj - jr.pobj) <= 1e-5 * abs(jr.pobj)
    assert tr.pinf_l1 <= 1e-5 and tr.gap <= 5e-5 and tr.dinf_l1 <= 5e-5
    assert ts.admm_cg_total > 0
    fs, lp_vals = ts.factor_blocks()
    assert [F.shape for F in fs] == [(15, 5)] * 3
    assert lp_vals.shape == (4,) and np.all(lp_vals >= 0)


def test_merged_maxcut_batch_matches_lorads_tpu_and_each_instance():
    """Three maxcut(300) instances merged into one split diag-identity
    bucket of three blocks: the batch takes lorads_tpu's path (pObj at
    rtol 1e-12, per-instance objectives at 1e-9), and each instance's
    objective is within 2e-5 of the instance solved alone (each solve
    stops at a gap of 5e-5; the spread seen on the CPU, in both
    packages: 9.4e-7, 7.8e-7 and 7.5e-6)."""
    probs = list(_maxcut300s())
    js, jr, _, ts, tr, _ = _solve_both(_problem("maxcut300x3"))
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert ts.pd.buckets[0].B == 3 and ts.pd.buckets[0].diag_ident
    assert tr.pobj == pytest.approx(jr.pobj, rel=1e-12)
    fs, lp_vals = ts.factor_blocks()
    assert lp_vals is None
    objs = t_split(probs, fs, lp_vals)
    jobjs = tpu_split(probs, *js.factor_blocks())
    np.testing.assert_allclose(objs, jobjs, rtol=1e-9)
    # the dense X_i = F_i F_i^T read-back gives the same objectives
    np.testing.assert_allclose(t_split_x(probs, *ts.x_blocks()), objs,
                               rtol=1e-12)
    assert sum(objs) == pytest.approx(tr.pobj, rel=1e-6)
    for p, obj in zip(probs, objs):
        alone = TorchSolver(p, TorchParams(verbose=False),
                            device="cpu").solve()
        assert alone.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
        assert obj == pytest.approx(alone.pobj, rel=2e-5)


def test_cli_solves_several_files_as_one_batch(capsys):
    """Two input files merge into one batch (two buckets, an LP block)
    and each instance's objective is reported at the end."""
    files = [FIX + "mc_gtoy60.dat-s", FIX + "hand_multiblock.dat-s"]
    assert t_main(files + ["--device", "cpu", "--quiet"]) == 0
    out = capsys.readouterr().out
    assert "merged 2 instances into one batch" in out
    assert "End Program with status `primal_dual_optimal`" in out
    objs = dict(re.findall(r"^\t(\S+): (\S+)$", out, re.M))
    assert list(objs) == files
    hand = ((1.0 - math.sqrt(2.0)) + (1.0 - math.sqrt(1.25)) + 0.75)
    assert float(objs[files[1]]) == pytest.approx(hand, abs=5e-4)
    alone = TorchSolver(tpu_gen.maxcut_from_graph(FIX + "g_toy60.rudy"),
                        TorchParams(verbose=False), device="cpu").solve()
    assert float(objs[files[0]]) == pytest.approx(alone.pobj, rel=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["multiblock22", "multiblock_lp"])
def test_multiblock_solves_match_lorads_tpu(name):
    """chip_smoke's multi-block instances on the CPU: both packages
    reach primal_dual_optimal; pObj within 1e-5 (CPU: 4.4e-7 and
    5.1e-7).  Both take ADMM's divergence recovery."""
    problem = (tpu_gen.random_multiblock(n_blocks=22, dim=12, m=40,
                                         density=0.3, seed=21)
               if name == "multiblock22" else
               tpu_gen.random_multiblock(n_blocks=8, dim=40, m=120,
                                         density=0.05, n_lp=400, seed=5))
    js, jr, jlog, ts, tr, tlog = _solve_both(problem)
    assert jr.status.value == "primal_dual_optimal"
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert abs(tr.pobj - jr.pobj) <= 1e-5 * abs(jr.pobj)
    assert ts.admm_retries >= 1
    assert any(ln.startswith("ADMM diverged") for ln in jlog)


@pytest.mark.slow
def test_merged_maxcut_batch_parts_by_summation_order(monkeypatch):
    """merge_problems of maxcut(n=10000, deg 8) seeds 7-10, the smallest
    merged Max-Cut batch seen to part (merged maxcut(2000)x4 and
    maxcut(5000)x4 keep the quartic within 1e-6; chip_smoke's
    maxcut(20000)x4 parts faster): the port and lorads_tpu part in ALM
    outer 1 from summation order alone, not from a port fault.

    - C @ R differs only within lorads_tpu's compensated prefix-scan
      contract, 2^-48 * |prefix| (lorads_tpu/ops/pattern.py:138-170),
      taken here as 2^-46 * sum |C| |R| of each block;
    - the line search sees the same quartic at inner step 0 (relative
      differences ~5e-15) and takes the same branch of its cubic (the
      same number of real roots) at every step of outer 1; the
      differences then grow geometrically with the L-BFGS steps at the
      batch's rho of 1/sqrt(40000): 1e-9 by step 15, 1e-6 by step 40,
      1e-3 by step 79 on the CPU, with no step where a root changes
      branch;
    - both whole solves are certified and each instance lies within
      2e-5 of lorads_tpu's solve of that instance alone (its solo
      spread)."""
    from lorads_tpu.alg import linesearch as tpu_ls
    from lorads_torch.alg import alm as t_alm
    from lorads_torch.alg import linesearch as t_ls

    probs = [tpu_gen.maxcut(n=10000, avg_degree=8, seed=s)
             for s in (7, 8, 9, 10)]
    problem = tpu_merge(probs)
    bp = tpu_presolve.presolve(problem, TpuParams()).buckets[0]
    assert (bp.B, bp.n) == (4, 10000)
    jbk = tpu_pat.build_bucket_data(bp, problem.m, jnp.float64)
    tbk = t_pat.build_bucket_data(bp, problem.m, torch.float64, "cpu")
    R = _factors(bp, 20, 7)
    jcr = np.asarray(tpu_pat.cmul(jbk, jnp.asarray(R)))
    tcr = t_pat.cmul(tbk, _t(R)).numpy()
    l1 = kernels.cmul_csr_plain(_t(np.abs(R)), tbk.c_diag.abs(),
                                tbk.sym_cols_rs, tbk.c_sym_rs.abs(),
                                tbk.bnd_sym_rows).numpy()
    bound = 2.0 ** -46 * l1.sum(axis=(1, 2))[:, None, None]
    assert np.all(np.abs(tcr - jcr) <= bound)

    # the line search's quartic at each inner step of both solves
    jrec, trec = [], []

    def j_line_search(rho, lam, p1, p2, q0, q1, q2):
        tau, num = tpu_ls.alm_line_search(rho, lam, p1, p2, q0, q1, q2)
        q0s = q0 + lam / rho
        coeffs = (rho * jnp.vdot(q2, q2) / 2.0, rho * jnp.vdot(q1, q2),
                  p2 - rho * jnp.vdot(q0s, q2) + rho * jnp.vdot(q1, q1)
                  / 2.0, p1 - rho * jnp.vdot(q0s, q1))
        jax.debug.callback(lambda *v: jrec.append(np.array(v, np.float64)),
                           *coeffs, tau, num, ordered=True)
        return tau, num

    def t_line_search(rho, lam, p1, p2, q0, q1, q2):
        c = t_ls.quartic_coeffs(rho, lam, p1, p2, q0, q1, q2)
        tau, num = t_ls.line_search_from_coeffs(c)
        trec.append(np.array([*c.tolist(), tau, num], np.float64))
        return tau, num

    monkeypatch.setattr(tpu_alm, "alm_line_search", j_line_search)
    monkeypatch.setattr(t_alm, "alm_line_search", t_line_search)
    js, jr, jlog, ts, tr, tlog = _solve_both(problem)
    outer1 = _outer_rows(tlog)[0][1]
    assert _outer_rows(jlog)[0][1] == outer1
    J, T = np.array(jrec[:outer1]), np.array(trec[:outer1])
    rel = (np.abs(J[:, :4] - T[:, :4])
           / np.maximum(np.abs(J[:, :4]), np.abs(T[:, :4]))).max(axis=1)
    assert rel[0] <= 1e-13 and rel[:16].max() <= 1e-7
    assert rel.max() >= 1e-3                          # parted in outer 1
    np.testing.assert_array_equal(J[:, 5], T[:, 5])   # same cubic branch

    assert jr.status.value == "primal_dual_optimal"
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    solo = [TpuSolver(p, TpuParams(verbose=False)).solve().pobj
            for p in probs]
    for objs in (t_split(probs, *ts.factor_blocks()),
                 tpu_split(probs, *js.factor_blocks())):
        np.testing.assert_allclose(objs, solo, rtol=2e-5)
