"""lorads_torch's CUDA kernels on the card (marker ``cuda``).

Each kernel against its plain PyTorch version on CUDA tensors, one
Max-Cut, one matrix-completion, one Lovász theta and one multi-block
LP solve (both LP sweeps) on cuda.  Imports no JAX, so it also runs
where JAX is not installed; without a GPU every test skips.  On a GPU
machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" \
        --noconftest -q

Tolerances: both sides sum at most a few dozen terms per output in
another order, so f64 outputs agree within 64 eps64 * sum|terms|; at
f32 the kernels' compensated sums and the plain versions' f64
accumulation agree within 4 eps32 * sum|terms|.
"""

import os

import numpy as np
import pytest
import torch

from lorads_torch import LoradsParams, LoradsSolver, SolverStatus
from lorads_torch.core.presolve import presolve
from lorads_torch.io import generators
from lorads_torch.io.sdpa import read_sdpa
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as pat

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _bucket(dtype):
    problem = read_sdpa(os.path.join(FIX, "maxcut2000.dat-s"))
    bp = presolve(problem, LoradsParams()).buckets[0]
    return pat.build_bucket_data(bp, problem.m, dtype, "cuda"), bp


def _tol(dtype):
    return (64 if dtype == torch.float64 else 4) * torch.finfo(dtype).eps


def _close(got, ref, l1, dtype):
    return bool(((got - ref).abs() <= _tol(dtype) * l1 + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 16, 40])
def test_cmul_kernel_matches_plain(dtype, r):
    _need_cuda()
    bk, bp = _bucket(dtype)
    rng = np.random.default_rng(r)
    X = torch.as_tensor(rng.standard_normal((1, bp.n, r)), dtype=dtype,
                        device="cuda")
    for cd in (bk.c_diag, None):
        args = (X, cd, bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
        before = kernels.LAUNCHES["cmul_csr"]
        got = kernels.cmul_csr(*args)
        assert kernels.LAUNCHES["cmul_csr"] == before + 1
        ref = kernels.cmul_csr_plain(*args)
        l1 = kernels.cmul_csr_plain(
            X.abs(), None if cd is None else cd.abs(), bk.sym_cols_rs,
            bk.c_sym_rs.abs(), bk.bnd_sym_rows)
        assert _close(got, ref, l1, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 16, 40])
def test_uvt_kernel_matches_plain(dtype, r):
    _need_cuda()
    bk, bp = _bucket(dtype)
    rng = np.random.default_rng(r)
    U, V = (torch.as_tensor(rng.standard_normal((1, bp.n, r)),
                            dtype=dtype, device="cuda") for _ in range(2))
    got = kernels.uvt_split(U, V, bk.off_rows, bk.off_cols)
    ref = kernels.uvt_split_plain(U, V, bk.off_rows, bk.off_cols)
    l1 = kernels.uvt_split_plain(U.abs(), V.abs(), bk.off_rows,
                                 bk.off_cols)
    for g, e, a in zip(got, ref, l1):
        assert _close(g, e, a, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(2, 1543), (2, 1543, 3), (2, 1543, 40)])
def test_segment_sum_kernel_matches_plain(dtype, shape):
    _need_cuda()
    rng = np.random.default_rng(3)
    S = 97
    ids = np.sort(rng.integers(0, S, shape[:2]), axis=1)
    ids[1, shape[1] // 2:] = S             # padded block tail
    bounds = torch.as_tensor(pat._bounds_np(ids, S), device="cuda")
    data = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device="cuda")
    got = kernels.segment_sum(data, bounds)
    ref = kernels.segment_sum_plain(data, bounds)
    l1 = kernels.segment_sum_plain(data.abs(), bounds)
    assert _close(got, ref, l1, dtype)


def _mc_bucket(dtype):
    problem = read_sdpa(os.path.join(FIX, "matcomp500.dat-s"))
    bp = presolve(problem, LoradsParams()).buckets[0]
    return pat.build_bucket_data(bp, problem.m, dtype, "cuda"), bp


def _rand(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device="cuda")


def _abs(bk):
    return {f: getattr(bk, f).abs() for f in pat.ALL_FLOAT_FIELDS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 14, 40])
def test_uvt_pair_kernel_matches_plain(dtype, r):
    _need_cuda()
    bk, bp = _mc_bucket(dtype)
    rng = np.random.default_rng(r)
    R, D = _rand(rng, (1, bp.n, r), dtype), _rand(rng, (1, bp.n, r), dtype)
    args = (bk.off_rows, bk.off_cols)
    before = kernels.LAUNCHES["uvt_pair_split"]
    got = kernels.uvt_pair_split(R, D, *args)
    assert kernels.LAUNCHES["uvt_pair_split"] == before + 1
    ref = kernels.uvt_pair_split_plain(R, D, *args)
    l1 = kernels.uvt_pair_split_plain(R.abs(), D.abs(), *args)
    for g, e, a in zip(got, ref, l1):
        assert _close(g, e, a, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gather_segsum_kernel_matches_plain(dtype):
    """A(.) (one entry per segment: exact), A^*(w) onto the slots with
    the objective as base, and long segments (warp per segment)."""
    _need_cuda()
    bk, bp = _mc_bucket(dtype)
    rng = np.random.default_rng(5)
    o = _rand(rng, (1, bk.Ko), dtype)
    w = _rand(rng, (1, bp.m_loc), dtype)
    cases = [
        ((o, bk.a_pos_o_cs, bk.a_val_o_cs, bk.bnd_a_con_o_cs), None, 2.0),
        ((w, bk.a_con_o_s, bk.a_val_o_s, bk.bnd_a_pos_o_s), bk.c_off, 1.0),
    ]
    S, N = 97, 5000                      # ~52 entries per segment
    ids = np.sort(rng.integers(0, S, (2, N)), axis=1)
    ids[1, N // 2:] = S
    x = _rand(rng, (2, 300), dtype)
    idx = torch.as_tensor(rng.integers(0, 300, (2, N)), dtype=torch.int32,
                          device="cuda")
    bnd = torch.as_tensor(pat._bounds_np(ids, S), device="cuda")
    cases.append(((x, idx, _rand(rng, (2, N), dtype), bnd),
                  _rand(rng, (2, S), dtype), 0.5))
    for k, (args, base, alpha) in enumerate(cases):
        got = kernels.gather_segsum(*args, base=base, alpha=alpha)
        ref = kernels.gather_segsum_plain(*args, base, alpha)
        x_, i_, v_, b_ = args
        l1 = kernels.gather_segsum_plain(
            x_.abs(), i_, v_.abs(), b_,
            None if base is None else base.abs(), alpha)
        assert _close(got, ref, l1, dtype)
        if k == 0:
            assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 14, 40])
def test_wmul_kernel_matches_plain(dtype, r):
    _need_cuda()
    bk, bp = _mc_bucket(dtype)
    rng = np.random.default_rng(r)
    X = _rand(rng, (1, bp.n, r), dtype)
    W_d, W_o = _rand(rng, (1, bp.n), dtype), _rand(rng, (1, bk.Ko), dtype)
    args = (bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows)
    got = kernels.wmul_csr(X, W_d, W_o, *args)
    ref = kernels.wmul_csr_plain(X, W_d, W_o, *args)
    l1 = kernels.wmul_csr_plain(X.abs(), W_d.abs(), W_o.abs(), *args)
    assert _close(got, ref, l1, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("want_diag", [False, True])
def test_adj_a_kernel_matches_plain(dtype, want_diag):
    _need_cuda()
    bk, bp = _mc_bucket(dtype)
    rng = np.random.default_rng(6)
    X, F = (_rand(rng, (1, bp.n, bp.rank), dtype) for _ in range(2))
    args = (bk.off_rows, bk.off_cols)
    got = kernels.adj_a_offdiag(X, F, *args, bk.a2_off, want_diag)
    ref = kernels.adj_a_offdiag_plain(X, F, *args, bk.a2_off, want_diag)
    l1 = kernels.adj_a_offdiag_plain(X.abs(), F.abs(), *args, bk.a2_off,
                                     True)
    assert (got[0] is None) == (not want_diag)
    if want_diag:
        assert _close(got[0], ref[0], l1[0], dtype)
    assert _close(got[1], ref[1], l1[1], dtype)


@pytest.mark.cuda
def test_matcomp500_solve_on_cuda():
    _need_cuda()
    kernels.reset_launches()
    solver = LoradsSolver(read_sdpa(os.path.join(FIX, "matcomp500.dat-s")),
                          LoradsParams(verbose=False), device="cuda")
    res = solver.solve()
    assert res.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert solver.admm_cg_total > 0
    # lorads_tpu on CPU at f64 gives 3021.053389491232
    assert abs(res.pobj - 3021.053389491232) <= 1e-4 * 3021.05
    for k in ("uvt_pair_split", "gather_segsum", "wmul_csr",
              "adj_a_offdiag"):
        assert kernels.LAUNCHES[k] > 0, k


@pytest.mark.cuda
def test_maxcut300_solve_on_cuda():
    _need_cuda()
    res = LoradsSolver(generators.maxcut(n=300, avg_degree=4, seed=3),
                       LoradsParams(verbose=False), device="cuda").solve()
    assert res.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    # lorads_tpu on CPU at f64 gives -504.660555953274
    assert abs(res.pobj + 504.660555953274) <= 1e-4 * 504.66


def _theta_bucket(dtype):
    problem = read_sdpa(os.path.join(FIX, "theta300.dat-s"))
    bp = presolve(problem, LoradsParams()).buckets[0]
    return pat.build_bucket_data(bp, problem.m, dtype, "cuda"), bp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_diag", [False, True])
def test_adj_a_dense_kernel_matches_plain(dtype, with_diag):
    """K7a rounds its product and its diagonal sum separately, as the
    plain version does: bit for bit."""
    _need_cuda()
    bk, bp = _theta_bucket(dtype)
    rng = np.random.default_rng(7)
    X = pat.uvt(bk, _rand(rng, (1, bp.n, bp.rank), dtype),
                _rand(rng, (1, bp.n, bp.rank), dtype))
    W_d = _rand(rng, (1, bp.n), dtype) if with_diag else None
    before = kernels.LAUNCHES["adj_a_dense"]
    got = kernels.adj_a_dense(X, bk.a2_full, W_d)
    assert kernels.LAUNCHES["adj_a_dense"] == before + 1
    assert torch.equal(got, kernels.adj_a_dense_plain(X, bk.a2_full, W_d))
    # an odd n and a view that starts one element into its storage
    Y = _rand(rng, (1, 37 * 37 + 1), dtype)[:, 1:].reshape(1, 37, 37)
    a2 = _rand(rng, (1, 37, 37), dtype)
    wd = _rand(rng, (1, 37), dtype) if with_diag else None
    assert torch.equal(kernels.adj_a_dense(Y, a2, wd),
                       kernels.adj_a_dense_plain(Y, a2, wd))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gather_segsum_dense_layouts_match_plain(dtype):
    """K4 on the dense layouts: A(.) over the flat n^2 view (exact on
    the single-entry constraints), C + A^*(w) onto the n^2 slots, and
    the two dd sums."""
    _need_cuda()
    bk, bp = _theta_bucket(dtype)
    rng = np.random.default_rng(8)
    n, m = bk.n, bp.m_loc
    flat = _rand(rng, (1, n * n), dtype)
    w = _rand(rng, (1, m), dtype)
    d = _rand(rng, (1, n), dtype)
    base = bk.c_full.reshape(1, n * n)
    cases = [((flat, bk.a_lin_cs, bk.a_val_inner_cs, bk.bnd_a_con_cs), None),
             ((w, bk.a_con2_s, bk.a_val2_s, bk.bnd_a_lin2), base),
             ((d, bk.dd_row_cs, bk.dd_val_cs, bk.bnd_dd_con), None),
             ((w, bk.dd_con_rs, bk.dd_val_rs, bk.bnd_dd_row), None)]
    for k, (args, b) in enumerate(cases):
        got = kernels.gather_segsum(*args, base=b)
        ref = kernels.gather_segsum_plain(*args, b)
        x_, i_, v_, s_ = args
        l1 = kernels.gather_segsum_plain(
            x_.abs(), i_, v_.abs(), s_, None if b is None else b.abs())
        assert _close(got, ref, l1, dtype)
        if k == 0:
            single = (s_[0, 1:] - s_[0, :-1]) == 1
            assert torch.equal(got[:, single], ref[:, single])


def _skewed_lengths(layout, rng):
    """[2, S] segment lengths: one-entry segments (10 % empty) with one of
    800, 5000 and 70000 entries among them (one lane per segment, the
    long ones taken by whole warps); 0-6 entries with one of 800 and
    thirty of 33-40 (four lanes per segment); 0-120 entries (a warp per
    segment).  The second row is a permutation of the first, its longest
    segment cut so that its bounds end before N."""
    if layout == "one":
        lengths = (rng.random(80000) >= 0.1).astype(np.int64)
        lengths[[100, 40000, 79999]] = (800, 5000, 70000)
    elif layout == "mid":
        lengths = rng.integers(0, 7, 2000)
        lengths[rng.choice(2000, 30, replace=False)] = rng.integers(33, 41,
                                                                    30)
        lengths[1000] = 800
    else:
        lengths = rng.integers(0, 121, 400)
    second = rng.permutation(lengths)
    second[np.argmax(second)] -= min(1000, int(second.max()))
    return np.stack([lengths, second])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["one", "mid", "wide"])
@pytest.mark.parametrize("with_base", [False, True])
def test_gather_segsum_skewed_segments_match_plain(dtype, layout, with_base):
    """K4 on skewed segment lengths, B = 2, empty segments, with and
    without base and alpha: within the stated tolerance, bit for bit on
    one-entry segments."""
    _need_cuda()
    rng = np.random.default_rng(11)
    lengths = _skewed_lengths(layout, rng)
    B, S = lengths.shape
    N, Nx = int(lengths.sum(axis=1).max()), 20000
    bnd = np.zeros((B, S + 1), np.int32)
    bnd[:, 1:] = np.cumsum(lengths, axis=1)
    bnd = torch.as_tensor(bnd, device="cuda")
    idx = torch.as_tensor(rng.integers(0, Nx, (B, N)).astype(np.int32),
                          device="cuda")
    x, val = _rand(rng, (B, Nx), dtype), _rand(rng, (B, N), dtype)
    base = _rand(rng, (B, S), dtype) if with_base else None
    alpha = -0.75 if with_base else 1.0
    before = kernels.LAUNCHES["gather_segsum"]
    got = kernels.gather_segsum(x, idx, val, bnd, base, alpha)
    assert kernels.LAUNCHES["gather_segsum"] == before + 1
    ref = kernels.gather_segsum_plain(x, idx, val, bnd, base, alpha)
    l1 = kernels.gather_segsum_plain(x.abs(), idx, val.abs(), bnd,
                                     None if base is None else base.abs(),
                                     abs(alpha))
    assert _close(got, ref, l1, dtype)
    single = torch.as_tensor(lengths == 1, device="cuda")
    assert torch.equal(got[single], ref[single])


@pytest.mark.cuda
@pytest.mark.parametrize("fixture", ["theta_gtoy60.dat-s",
                                     "matcomp500.dat-s"])
def test_dual_ls_refine_on_cuda_matches_cpu(fixture):
    """The CGNR refinement (alg/dualrefine.py) on the card against its
    CPU run from the same random factors and dual, 30 iterations: the
    step and both LS norms within rtol 1e-8.  On theta's dense bucket
    each iteration runs K4 (dense A(.) and build_w)."""
    _need_cuda()
    from lorads_torch.alg.dualrefine import dual_ls_refine
    from lorads_torch.alg.state import FactorVec
    problem = read_sdpa(os.path.join(FIX, fixture))
    out = {}
    for dev in ("cpu", "cuda"):
        solver = LoradsSolver(problem, LoradsParams(verbose=False),
                              device=dev)
        rng = np.random.default_rng(5)
        R = FactorVec(tuple(torch.as_tensor(
            rng.standard_normal(tuple(c.shape)), device=dev)
            for c in solver.R.cones), solver.R.lp)
        dual = torch.as_tensor(0.1 * rng.standard_normal(problem.m),
                               device=dev)
        before = kernels.LAUNCHES["gather_segsum"]
        out[dev] = [t.cpu() for t in dual_ls_refine(solver.pd, R, dual, 30)]
        if dev == "cuda":
            assert kernels.LAUNCHES["gather_segsum"] > before
    (cs, c0, c1, cits), (gs, g0, g1, gits) = out["cpu"], out["cuda"]
    assert int(cits) == int(gits) > 0
    for a, b in ((g0, c0), (g1, c1)):
        assert float(a) == pytest.approx(float(b), rel=1e-8)
    assert float((gs - cs).abs().max()) <= 1e-8 * float(cs.abs().max())


@pytest.mark.cuda
def test_theta_gtoy60_solve_on_cuda():
    _need_cuda()
    kernels.reset_launches()
    solver = LoradsSolver(read_sdpa(os.path.join(FIX, "theta_gtoy60.dat-s")),
                          LoradsParams(verbose=False), device="cuda")
    res = solver.solve()
    assert res.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert solver.admm_cg_total > 0
    # lorads_tpu on CPU at f64 gives -24.209496946891917
    assert abs(res.pobj + 24.209496946891917) <= 1e-4 * 24.21
    for k in ("gather_segsum", "adj_a_dense"):
        assert kernels.LAUNCHES[k] > 0, k


def _lp_problem():
    return generators.random_multiblock(n_blocks=3, dim=12, m=30,
                                        density=0.1, n_lp=200, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("rho", [3.5, 0.25])
def test_lp_gs_sweep_kernel_matches_plain_bit_for_bit(rho):
    """K8c sums each column's terms in the plain version's lane order
    with explicitly rounded operations: bit for bit at f64."""
    _need_cuda()
    from lorads_torch.ops import lp as lp_ops
    problem = _lp_problem()
    lpd = lp_ops.build_lp_data(problem.lp, torch.float64, "cuda")
    rng = np.random.default_rng(11)
    n, m = lpd.n_cols, lpd.m_glob
    u, v = (_rand(rng, (n,), torch.float64) for _ in range(2))
    csum, rhs, dual = (_rand(rng, (m,), torch.float64) for _ in range(3))
    csum0 = csum.clone()
    args = (lpd.pc_con, lpd.pc_val, lpd.obj, lpd.col_nrm2sq, u, v, csum,
            rhs, dual, rho)
    before = kernels.LAUNCHES["lp_gs_sweep"]
    got = kernels.lp_gs_sweep(*args)
    assert kernels.LAUNCHES["lp_gs_sweep"] == before + 1
    ref = kernels.lp_gs_sweep_plain(*args)
    for g, e in zip(got, ref):
        assert torch.equal(g, e)
    assert torch.equal(csum, csum0) and not torch.equal(got[1], csum)


@pytest.mark.cuda
def test_lp_sums_and_scatter_match_plain():
    """K8a / K8b (K4 on the LP's sorted entries, with c as the base and
    alpha -1 for the certificate) and K4's scatter of a bucket of
    several blocks into the global m-vector."""
    _need_cuda()
    from lorads_torch.ops import lp as lp_ops
    problem = _lp_problem()
    lpd = lp_ops.build_lp_data(problem.lp, torch.float64, "cuda")
    bp = presolve(problem, LoradsParams()).buckets[0]
    bk = pat.build_bucket_data(bp, problem.m, torch.float64, "cuda")
    assert bk.B == 3 and not bk.glob_ident
    rng = np.random.default_rng(12)
    uv = _rand(rng, (lpd.n_cols,), torch.float64)
    w = _rand(rng, (lpd.m_glob,), torch.float64)
    vals = _rand(rng, (bk.B, bk.m_loc), torch.float64)
    a8 = (lpd.a_col_cs[None], lpd.a_val_cs[None], lpd.bnd_con[None])
    b8 = (lpd.a_con_ls[None], lpd.a_val_ls[None], lpd.bnd_col[None])
    sc = (bk.scat_idx, bk.scat_val, bk.bnd_scat)
    cases = [
        (lp_ops.constr_vals(lpd, uv),
         kernels.gather_segsum_plain(uv[None], *a8)[0],
         kernels.gather_segsum_plain(uv.abs()[None], a8[0], a8[1].abs(),
                                     a8[2])[0]),
        (lp_ops.adjoint_cols(lpd, w, base=lpd.obj, alpha=-1.0),
         kernels.gather_segsum_plain(w[None], *b8, lpd.obj[None], -1.0)[0],
         kernels.gather_segsum_plain(w.abs()[None], b8[0], b8[1].abs(),
                                     b8[2], lpd.obj.abs()[None])[0]),
        (pat.scatter_constr(bk, vals),
         kernels.gather_segsum_plain(vals.reshape(1, -1), *sc)[0],
         kernels.gather_segsum_plain(vals.abs().reshape(1, -1), *sc)[0]),
    ]
    for got, ref, l1 in cases:
        assert _close(got, ref, l1, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("lp_gs", [False, True])
def test_hand_multiblock_solve_on_cuda(lp_gs):
    """Two dense buckets on local slots and an LP block; with lp_gs the
    LP columns sweep in order through K8c."""
    _need_cuda()
    kernels.reset_launches()
    res = LoradsSolver(read_sdpa(os.path.join(FIX, "hand_multiblock.dat-s")),
                       LoradsParams(verbose=False, lp_gauss_seidel=lp_gs),
                       device="cuda").solve()
    assert res.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    # lorads_tpu on CPU at f64: 0.21774877836010853 (Jacobi) and
    # 0.21774893891060546 (Gauss-Seidel LP sweeps)
    assert abs(res.pobj - 0.2177488) <= 1e-4 * 0.2177488
    assert kernels.LAUNCHES["gather_segsum"] > 0
    assert (kernels.LAUNCHES["lp_gs_sweep"] > 0) == lp_gs


# ---------------------------------------------------------------------------
# The probes' kernels (lorads_torch.probes): P1-P4 against their plain
# versions at a small shape with the edge cases (a CT tile with no ids, a
# segment of 100 rows -- wider than a 16-row k-chunk --, n not a multiple
# of the tile, ids padded with n_pad + 7) and at a probe shape.
# ---------------------------------------------------------------------------

def _probe_ids(shape, sort=True):
    from numpy.random import default_rng
    n, K = shape
    rng = default_rng(n)
    ids = rng.integers(0, n, K)
    if n < 20000:
        ids = ids[(ids < 256) | (ids >= 512)]          # an empty tile
        ids = np.concatenate([ids, np.full(100, 700)])  # a wide segment
    return (np.sort(ids) if sort else ids).astype(np.int32)


def _f32(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 5000), (20000, 80000)])
@pytest.mark.parametrize("r", [1, 24, 128])
@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16x2"])
@pytest.mark.parametrize("layout", ["kr", "rk"])
def test_onehot_scatter_kernel_matches_plain(shape, r, mode, layout):
    _need_cuda()
    from lorads_torch.probes import onehot as oh
    ids = _probe_ids(shape)
    n, K = shape[0], ids.size
    plan = oh.plan_sorted_scatter(ids, n, CT=256, device="cuda")
    assert plan.ok and plan.K_pad > K and plan.n_pad > n
    rng = np.random.default_rng(r)
    vals = _f32(rng, K, r) if layout == "kr" else _f32(rng, r, K)
    got = oh.sorted_scatter(vals, plan, mode, layout)
    ref = oh.sorted_scatter_plain(vals, plan, mode, layout)
    l1 = oh.sorted_scatter_plain(vals.abs(), plan, "f32", layout)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _close(got.double(), ref.double(), l1.double(), torch.float32)
    if n < 20000:
        empty = got[:, 256:512] if layout == "rk" else got[256:512]
        assert not bool(empty.any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 5000), (20000, 80000)])
@pytest.mark.parametrize("r", [1, 24, 128])
@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16x2"])
def test_onehot_gather_kernel_matches_plain(shape, r, mode):
    _need_cuda()
    from lorads_torch.probes import onehot as oh
    ids = _probe_ids(shape)
    plan = oh.plan_sorted_gather(ids, shape[0], KT=256, device="cuda")
    assert plan.ok
    X = _f32(np.random.default_rng(r), shape[0], r)
    got = oh.sorted_gather(X, plan, mode)
    ref = oh.sorted_gather_plain(X, plan, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)          # one row's planes per output
    if mode != "bf16x2":
        assert torch.equal(got, X[torch.as_tensor(ids, device="cuda").long()])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 5000), (20000, 100000)])
@pytest.mark.parametrize("form", ["kr1", "kr20", "kr128", "rk24", "1-D"])
def test_row_gather_kernel_matches_plain(shape, form):
    _need_cuda()
    from lorads_torch.probes import gather
    n, _ = shape
    ids = torch.as_tensor(_probe_ids(shape, sort=False), device="cuda")
    rng = np.random.default_rng(7)
    if form == "1-D":
        X, layout = _f32(rng, n), "kr"
    elif form.startswith("rk"):
        X, layout = _f32(rng, int(form[2:]), n), "rk"
    else:
        X, layout = _f32(rng, n, int(form[2:])), "kr"
    got = gather.row_gather(X, ids, layout)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.row_gather_plain(X, ids, layout))
    with pytest.raises(IndexError):
        gather.row_gather(X, torch.full_like(ids, n), layout)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 5000), (20000, 160000)])
@pytest.mark.parametrize("r", [0, 1, 24, 128])
def test_scatter_add_kernel_matches_plain(shape, r):
    _need_cuda()
    from lorads_torch.probes import gather
    n, _ = shape
    ids = torch.as_tensor(_probe_ids(shape, sort=False), device="cuda")
    rng = np.random.default_rng(r)
    vals = _f32(rng, ids.shape[0]) if r == 0 else _f32(rng, ids.shape[0], r)
    got = gather.scatter_add(vals, ids, n)
    ref = gather.scatter_add_plain(vals, ids, n)
    l1 = gather.scatter_add_plain(vals.abs(), ids, n)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _close(got.double(), ref.double(), l1.double(), torch.float32)
