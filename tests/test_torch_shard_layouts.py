"""lorads_torch's shard layouts on the CPU, in one process, held to
lorads_tpu's own unplaced shard buckets.

A summed bucket (sp: one sparse cone's union pattern cut into D slot
ranges, parallel/pattern_sharded.py) and a rowshard bucket (tp: one dense
cone's n x n intermediates as [D, n_loc, n] row slabs,
parallel/row_sharded.py) compute, unplaced, what the unsharded bucket
computes (lorads_tpu's tests/test_sharded.py:129-201, :331-396).  Here
the port's builders are held to lorads_tpu's field by field (bit for bit;
the port-only fields to NumPy recomputations), the operations on them to
lorads_tpu's on the same inputs at test_sharded.py's tolerances, and
whole solves from the swapped layouts to lorads_tpu's unsharded status
and pObj.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.ops import pattern as tpu_pat
from lorads_tpu.parallel.pattern_sharded import (
    build_pattern_shards as tpu_pattern_shards)
from lorads_tpu.parallel.row_sharded import (
    build_rowshard_bucket as tpu_rowshard)
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.ops import pattern as pat
from lorads_torch.parallel.pattern_sharded import build_pattern_shards
from lorads_torch.parallel.row_sharded import build_rowshard_bucket

D = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _pair(problem, **kw):
    """(lorads_tpu solver, the port's solver on the CPU) of one instance."""
    return (TpuSolver(problem, TpuParams(verbose=False, **kw)),
            TorchSolver(problem, TorchParams(verbose=False, **kw),
                        device="cpu"))


def _same_buckets(a, b):
    """Every field of two port buckets equal, bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def _sym_entries_np(off_rows, off_cols, c_off):
    """NumPy recomputation of a block's full-symmetric row-sorted off
    entries: sorted (row, col, value, slot) tuples."""
    k = int(np.count_nonzero(off_rows != off_cols))
    r, c, v = off_rows[:k], off_cols[:k], c_off[:k]
    ent = list(zip(np.r_[r, c], np.r_[c, r], np.r_[v, v],
                   np.r_[np.arange(k), np.arange(k)]))
    return sorted(ent)


@pytest.fixture(scope="module")
def summed():
    problem = tpu_gen.maxcut(n=300, avg_degree=4, seed=4)
    ts, ps = _pair(problem)
    plan_t = ts.ps.buckets[0].plans[0]
    plan_p = ps.ps.buckets[0].plans[0]
    bk_t = tpu_pattern_shards(plan_t, problem.m, D, ts.dtype, summed=True)
    bk_p = build_pattern_shards(plan_p, problem.m, D, torch.float64,
                                summed=True, device="cpu")
    return problem, ts, ps, bk_t, bk_p


def test_summed_bucket_matches_lorads_tpu_field_by_field(summed):
    _, _, _, bk_t, bk_p = summed
    assert bk_p.summed and bk_p.diag_parent and bk_p.B == D
    assert bk_t.summed and bk_t.diag_parent
    assert not bk_p.diag_ident and not bk_p.glob_ident
    for k in pat.INT_FIELDS + pat.FLOAT_FIELDS:
        if k == "bnd_a_con_d":      # the port's own bounds (below)
            continue
        np.testing.assert_array_equal(_np(getattr(bk_p, k)),
                                      _np(getattr(bk_t, k)), err_msg=k)
    for k in pat.SYM_INT_FIELDS + pat.SYM_FLOAT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(bk_p, k)),
                                      _np(getattr(bk_t, k)), err_msg=k)
    np.testing.assert_array_equal(_np(bk_p.a_val_d_full),
                                  _np(bk_t.a_val_d_full))
    for k in ("n", "K", "m_loc", "m_glob", "Ko", "nnz_d", "nnz_o",
              "has_off", "has_diag_a", "has_off_a", "a_off_unique"):
        assert getattr(bk_p, k) == getattr(bk_t, k), k
    # the same bucket carried across from lorads_tpu's
    _same_buckets(interop.bucket_from_numpy(bk_t), bk_p)


def test_summed_port_fields_against_numpy(summed):
    """Each shard's port-only fields, recomputed with NumPy from the
    shard's own lorads_tpu-layout entries."""
    _, _, _, _, bk = summed
    off_rows, off_cols, c_off = (_np(getattr(bk, k)) for k in
                                 ("off_rows", "off_cols", "c_off"))
    for b in range(D):
        want = _sym_entries_np(off_rows[b], off_cols[b], c_off[b])
        slot = _np(bk.sym_slot_rs)[b]
        keep = slot >= 0
        got = sorted(zip(_np(bk.sym_rows_rs)[b][keep],
                         _np(bk.sym_cols_rs)[b][keep],
                         _np(bk.c_sym_rs)[b][keep], slot[keep]))
        assert got == want
        rows = _np(bk.sym_rows_rs)[b]
        assert np.all(np.diff(rows) >= 0)
        np.testing.assert_array_equal(
            _np(bk.bnd_sym_rows)[b], np.searchsorted(rows, np.arange(
                bk.n + 1)))
        con = _np(bk.a_con_o)[b]
        o = np.argsort(con, kind="stable")
        np.testing.assert_array_equal(_np(bk.a_con_o_cs)[b], con[o])
        np.testing.assert_array_equal(_np(bk.a_pos_o_cs)[b],
                                      _np(bk.a_pos_o)[b][o])
        np.testing.assert_array_equal(
            _np(bk.bnd_a_con_o_cs)[b],
            np.searchsorted(con[o], np.arange(bk.m_loc + 1)))
    # the scatter of every (shard, slot) by global slot, shard by shard,
    # and the diag-parent's scatter of shard 0's slots alone
    g = _np(bk.glob_idx).reshape(-1)
    keep = np.nonzero(g < bk.m_glob)[0]
    flat = keep[np.argsort(g[keep], kind="stable")]
    np.testing.assert_array_equal(_np(bk.scat_idx)[0, :flat.size], flat)
    np.testing.assert_array_equal(
        _np(bk.bnd_scat)[0], np.searchsorted(g[flat], np.arange(
            bk.m_glob + 1)))
    g0 = _np(bk.glob_idx)[0]
    np.testing.assert_array_equal(_np(bk.diag_scat_idx)[0],
                                  np.argsort(g0, kind="stable"))


def test_summed_operations_match_lorads_tpu(summed):
    problem, ts, ps, bk_t, bk_p = summed
    pd_t = dataclasses.replace(ts.pd, buckets=(bk_t,))
    pd_p = dataclasses.replace(ps.pd, buckets=(bk_p,))
    R_t = ts.R
    R = interop.factor_from_numpy([np.asarray(R_t.cones[0])],
                                  np.asarray(R_t.lp))
    _, tot_t = tpu_aop.auv(pd_t, R_t, R_t)
    _, tot = t_aop.auv(pd_p, R, R)
    np.testing.assert_allclose(_np(tot), _np(tot_t), rtol=1e-12,
                               atol=1e-12)
    _, tot0 = t_aop.auv(ps.pd, R, R)
    np.testing.assert_allclose(_np(tot), _np(tot0), rtol=1e-12,
                               atol=1e-12)
    assert float(t_aop.obj_only(pd_p, R, R)) == pytest.approx(
        float(tpu_aop.obj_only(pd_t, R_t, R_t)), rel=1e-12)
    w_np = np.random.default_rng(0).standard_normal(problem.m)
    g_t = tpu_aop.grad(pd_t, R_t, jnp.asarray(w_np))
    g = t_aop.grad(pd_p, R, _t(w_np))
    np.testing.assert_allclose(_np(g.cones[0]), _np(g_t.cones[0]),
                               rtol=1e-11, atol=1e-11)
    # the diag-parent cache path: C @ R summed over the shards
    ca = t_aop.gather_caches(pd_p, R)
    assert isinstance(ca[0], t_aop.CRCache)
    np.testing.assert_allclose(_np(t_aop.auv_cached(pd_p, R, ca)),
                               _np(tot_t), rtol=1e-12, atol=1e-12)
    g2 = t_aop.grad_cached(pd_p, R, _t(w_np), ca)
    np.testing.assert_allclose(_np(g2.cones[0]), _np(g_t.cones[0]),
                               rtol=1e-11, atol=1e-11)
    # one ADMM double sweep (the closed form on the parent's diagonal)
    rng = np.random.default_rng(1)
    dual_np = rng.standard_normal(problem.m)
    outs = []
    for pdx in (pd_t, ts.pd):
        locals_, lpc, total, *_ = tpu_admm.admm_init_eval(
            pdx, ts.U, ts.V, jnp.asarray(dual_np), jnp.asarray(1.0))
        out = tpu_admm.admm_update_all(
            pdx, ts.U, ts.V, locals_, lpc, total, jnp.asarray(dual_np),
            jnp.asarray(2.0), jnp.asarray(1e-10), 50)
        outs.append((_np(out[0].cones[0]), _np(out[4])))
    for pdx in (pd_p, ps.pd):
        locals_, total, _ = t_admm.admm_init_eval(
            pdx, R, R, _t(dual_np), 1.0)
        out = t_admm.admm_update_all(pdx, R, R, locals_, total,
                                     _t(dual_np), 2.0, cg_tol=1e-10)
        outs.append((_np(out[0].cones[0]), _np(out[3])))
    for u, cs in outs[1:]:
        np.testing.assert_allclose(u, outs[0][0], rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(cs, outs[0][1], rtol=1e-8, atol=1e-8)


def test_summed_general_pattern_matches_unsharded():
    """A summed bucket of a general sparse cone (matrix completion: K3,
    K3p, K4, K5 and the generic CG operator at B = D with cone_total):
    its operations against the unsharded bucket's."""
    problem = tpu_gen.matrix_completion(n1=40, n2=36, true_rank=2,
                                        frac_obs=0.05, seed=3)
    ps = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    bk0 = ps.pd.buckets[0]
    assert bk0.B == 1 and not bk0.dense and not bk0.diag_ident
    assert bk0.a_off_unique
    bk = build_pattern_shards(ps.ps.buckets[0].plans[0], problem.m, D,
                              torch.float64, summed=True, device="cpu")
    assert bk.summed and not bk.diag_parent
    pd = dataclasses.replace(ps.pd, buckets=(bk,))
    rng = np.random.default_rng(2)
    n, r = bk0.n, 3
    U, V, X = (_t(rng.standard_normal((1, n, r))) for _ in range(3))
    v0 = pat.constr_vals(bk0, pat.uvt(bk0, U, V))
    v1 = pat.cone_total(bk, pat.constr_vals(bk, pat.uvt(bk, U, V)))
    np.testing.assert_allclose(_np(v1[2]), _np(v0[0]), rtol=1e-12,
                               atol=1e-12)
    (a0, b0), (a1, b1) = pat.uvt_pair(bk0, U, V), pat.uvt_pair(bk, U, V)
    for x0, x1 in ((a0, a1), (b0, b1)):
        s0 = pat.scatter_constr(bk0, pat.constr_vals(bk0, x0))
        s1 = pat.scatter_constr(bk, pat.constr_vals(bk, x1))
        np.testing.assert_allclose(_np(s1), _np(s0), rtol=1e-12,
                                   atol=1e-12)
    w = _t(rng.standard_normal(problem.m))
    W0 = pat.build_w(bk0, pat.gather_w(bk0, w))
    W1 = pat.build_w(bk, pat.gather_w(bk, w))
    np.testing.assert_allclose(_np(pat.w_mul(bk, W1, X)),
                               _np(pat.w_mul(bk0, W0, X)), rtol=1e-11,
                               atol=1e-12)
    op0 = t_admm._cg_operator(bk0, V)
    op1 = t_admm._cg_operator(bk, V)
    np.testing.assert_allclose(_np(op1(X)), _np(op0(X)), rtol=1e-11,
                               atol=1e-12)
    R = ps.R
    _, t0 = t_aop.auv(ps.pd, R, R)
    _, t1 = t_aop.auv(pd, R, R)
    np.testing.assert_allclose(_np(t1), _np(t0), rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def rowshard():
    problem = tpu_gen.lovasz_theta(n=30, avg_degree=8, seed=5)
    ts, ps = _pair(problem, dtype="f64")
    bk_t = tpu_rowshard(ts.ps.plans[0], problem.m, D, jnp.float64)
    bk_p = build_rowshard_bucket(ps.ps.plans[0], problem.m, D,
                                 torch.float64, device="cpu")
    return problem, ts, ps, bk_t, bk_p


def test_rowshard_bucket_matches_lorads_tpu_field_by_field(rowshard):
    _, _, _, bk_t, bk = rowshard
    assert bk.rowshard and bk.dense and bk.B == D
    assert bk.n_loc == bk_t.n_loc == -(-bk.n // D)
    assert bk.c_full.shape == (D, bk.n_loc, bk.n)
    for k in pat.DENSE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(bk, k)),
                                      _np(getattr(bk_t, k)), err_msg=k)
    for k in ("n", "K", "m_loc", "m_glob", "nnz_a"):
        assert getattr(bk, k) == getattr(bk_t, k), k
    _same_buckets(interop.bucket_from_numpy(bk_t), bk)


def test_rowshard_port_fields_against_numpy(rowshard):
    """The slab layouts (i) and (ii), recomputed with NumPy from each
    shard's own entries: by constraint for A(.), by slab slot for W."""
    _, _, _, _, bk = rowshard
    lin, con, val = (_np(getattr(bk, k)) for k in ("a_lin", "a_con_loc",
                                                   "a_val"))
    S = bk.n_loc * bk.n
    for b in range(D):
        keep = (val[b] != 0) & (con[b] < bk.m_loc)
        o = np.argsort(con[b][keep], kind="stable")
        L = o.size
        np.testing.assert_array_equal(_np(bk.a_lin_cs)[b, :L],
                                      lin[b][keep][o])
        np.testing.assert_array_equal(_np(bk.a_val_inner_cs)[b, :L],
                                      val[b][keep][o])
        np.testing.assert_array_equal(
            _np(bk.bnd_a_con_cs)[b],
            np.searchsorted(con[b][keep][o], np.arange(bk.m_loc + 1)))
        o2 = np.argsort(lin[b][keep], kind="stable")
        np.testing.assert_array_equal(_np(bk.a_con2_s)[b, :L],
                                      con[b][keep][o2])
        np.testing.assert_array_equal(_np(bk.a_val2_s)[b, :L],
                                      val[b][keep][o2])
        np.testing.assert_array_equal(
            _np(bk.bnd_a_lin2)[b],
            np.searchsorted(lin[b][keep][o2], np.arange(S + 1)))


def test_rowshard_operations_match_lorads_tpu(rowshard):
    problem, ts, ps, bk_t, bk = rowshard
    bk0 = ps.pd.buckets[0]
    n, r = bk.n, 5
    rng = np.random.default_rng(0)
    U_np, V_np, X_np = (rng.standard_normal((1, n, r)) for _ in range(3))
    U, V, X = _t(U_np), _t(V_np), _t(X_np)
    uv_t = tpu_pat.uvt(bk_t, jnp.asarray(U_np), jnp.asarray(V_np))
    uv = pat.uvt(bk, U, V)
    np.testing.assert_allclose(_np(uv), _np(uv_t), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(uv).reshape(-1, n)[:n],
                               _np(pat.uvt(bk0, U, V))[0], rtol=1e-12,
                               atol=1e-12)
    cv_t = tpu_pat.constr_vals(bk_t, uv_t)
    cv = pat.constr_vals(bk, uv)
    np.testing.assert_allclose(_np(cv), _np(cv_t), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(pat.scatter_constr(bk, cv)),
                               _np(tpu_pat.scatter_constr(bk_t, cv_t)),
                               rtol=1e-12, atol=1e-12)
    assert float(pat.shard_sum(bk, pat.obj_inner(bk, uv), "obj")) == \
        pytest.approx(float(jnp.sum(tpu_pat.obj_inner(bk_t, uv_t))),
                      rel=1e-12)
    w_np = rng.standard_normal(problem.m)
    W_t = tpu_pat.build_w(bk_t, tpu_pat.gather_w(bk_t, jnp.asarray(w_np)))
    W = pat.build_w(bk, pat.gather_w(bk, _t(w_np)))
    np.testing.assert_allclose(_np(W), _np(W_t), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        _np(pat.w_mul(bk, W, X)),
        _np(tpu_pat.w_mul(bk_t, W_t, jnp.asarray(X_np))), rtol=1e-11,
        atol=1e-12)
    # a whole ADMM sweep (the subproblem's builder and CG on slabs)
    dual_np = rng.standard_normal(problem.m)
    pd_t = dataclasses.replace(ts.pd, buckets=(bk_t,))
    from lorads_tpu.alg.state import FactorVec as TpuFV
    fU = TpuFV((jnp.asarray(U_np),), jnp.zeros((0,)))
    fV = TpuFV((jnp.asarray(V_np),), jnp.zeros((0,)))
    loc, total = tpu_aop.auv(pd_t, fU, fV)
    U1, V1, _, _, csum, _, _, _ = tpu_admm.admm_update_all(
        pd_t, fU, fV, loc, jnp.zeros_like(total), total,
        jnp.asarray(dual_np), jnp.asarray(1.3), jnp.asarray(1e-12), 200)
    pd = dataclasses.replace(ps.pd, buckets=(bk,))
    pU = interop.factor_from_numpy([U_np], np.zeros(0))
    pV = interop.factor_from_numpy([V_np], np.zeros(0))
    loc, total = t_aop.auv(pd, pU, pV)
    out = t_admm.admm_update_all(pd, pU, pV, loc, total, _t(dual_np), 1.3,
                                 cg_tol=1e-12)
    np.testing.assert_allclose(_np(out[0].cones[0]), _np(U1.cones[0]),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(_np(out[1].cones[0]), _np(V1.cones[0]),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(_np(out[3]), _np(csum), rtol=1e-8,
                               atol=1e-9)


# pObj tolerance against lorads_tpu's unsharded solve (tp:
# test_sharded.py:415)
REF_RTOL = {"sp": 1e-4, "tp": 1e-3, "dp": 1e-4}


def ref_problem(case):
    """The instance of each whole-solve check (lorads_tpu's generators)."""
    if case == "sp":
        return tpu_gen.maxcut(n=240, avg_degree=4, seed=6)
    if case == "tp":
        return tpu_gen.random_multiblock(n_blocks=1, dim=32, m=24,
                                         density=0.3, seed=7)
    return tpu_gen.random_multiblock(n_blocks=8, dim=14, m=12, seed=6)


@functools.lru_cache(maxsize=None)
def tpu_reference(case):
    """lorads_tpu's unsharded solve of ref_problem(case), run here on the
    CPU (seconds each): (status, pObj)."""
    res = TpuSolver(ref_problem(case), TpuParams(verbose=False)).solve()
    return res.status.value, res.pobj


@pytest.mark.parametrize("case", ["sp", "tp"])
def test_whole_solve_from_swapped_layout(case):
    """A whole solve with the shard layout swapped into the port's
    ProblemData (unplaced): lorads_tpu's unsharded status, and its pObj
    within 1e-4 (1e-3 for tp), from lorads_tpu's solve of the same
    instance."""
    problem = ref_problem(case)
    ps = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    plan = ps.ps.buckets[0].plans[0]
    bk = (build_pattern_shards(plan, problem.m, D, torch.float64,
                               summed=True, device="cpu") if case == "sp"
          else build_rowshard_bucket(plan, problem.m, D, torch.float64,
                                     device="cpu"))
    ps.pd = dataclasses.replace(ps.pd, buckets=(bk,))
    assert "sharded" in ps.prob_info()
    res = ps.solve()
    status, pobj = tpu_reference(case)
    assert res.status.value == status
    assert res.pobj == pytest.approx(pobj, rel=REF_RTOL[case])
    assert res.R.cones[0].shape[0] == 1
