"""lorads_torch's CUDA kernels on the card (marker ``cuda``).

Each kernel against its plain PyTorch version on CUDA tensors (K3's
one-dot path for U is V also bit for bit against its two-dot path), one
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
import time
import types

import numpy as np
import pytest
import torch

from lorads_torch import LoradsParams, LoradsSolver, SolverStatus
from lorads_torch.core.presolve import presolve
from lorads_torch.io import generators
from lorads_torch.io.sdpa import read_sdpa
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as pat


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _segment_ids(layout, B, N, S, rng):
    """Sorted segment ids [B, N'] for K1's run schedule: random lengths;
    "long": one segment of 70000 more entries (longer than any run's
    staging buffer); "empty_runs": segments 10-89 empty (whole runs of
    empty segments).  Block 1's second half is a padded tail (id S)."""
    ids = np.sort(rng.integers(0, S, (B, N)), axis=1)
    if layout == "long":
        ids = np.sort(np.concatenate(
            [ids, np.full((B, 70000), S // 2)], axis=1), axis=1)
    elif layout == "empty_runs":
        ids = np.where((ids >= 10) & (ids < 90), 9, ids)
    ids[1, ids.shape[1] // 2:] = S
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(2, 1543), (2, 1543, 3), (2, 1543, 40),
                                   (2, 1543, 20), (2, 1543, 24)])
@pytest.mark.parametrize("layout", ["random", "long", "empty_runs",
                                    "odd_offset"])
def test_segment_sum_kernel_matches_plain(dtype, shape, layout):
    """K1 on B = 2 with a padded block tail, r covering the 16-byte
    copies' tails (1, 3, 20, 24, 40), and the run schedule's cases:
    a segment longer than the buffer, all-empty runs, and data one
    element past an aligned address (every staged span's head
    unaligned)."""
    _need_cuda()
    rng = np.random.default_rng(3)
    S = 97
    ids = _segment_ids(layout, shape[0], shape[1], S, rng)
    bounds = torch.as_tensor(pat._bounds_np(ids, S), device="cuda")
    full = ids.shape + shape[2:]
    flat = torch.as_tensor(rng.standard_normal(1 + int(np.prod(full))),
                           dtype=dtype, device="cuda")
    data = (flat[1:] if layout == "odd_offset" else flat[:-1]).view(full)
    before = kernels.LAUNCHES["segment_sum"]
    got = kernels.segment_sum(data, bounds)
    assert kernels.LAUNCHES["segment_sum"] == before + 1
    ref = kernels.segment_sum_plain(data, bounds)
    l1 = kernels.segment_sum_plain(data.abs(), bounds)
    assert _close(got, ref, l1, dtype)
    if layout == "empty_runs":
        assert not bool(got[:, 10:90].any())


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


def _merged_bucket(dtype):
    """A merged batch of two matrix completions: one split bucket of
    B = 2 blocks with their own padding."""
    from lorads_torch.core.problem import merge_problems
    problem = merge_problems([
        generators.matrix_completion(n1=60, n2=60, frac_obs=0.05, seed=1),
        generators.matrix_completion(n1=40, n2=50, frac_obs=0.05, seed=2)])
    bp = presolve(problem, LoradsParams()).buckets[0]
    return pat.build_bucket_data(bp, problem.m, dtype, "cuda")


def _skewed_pattern():
    """Two blocks on n = 300 (as tests/test_torch_tiles.py): block 0 a
    hub row against every column and a band of short rows, block 1 only
    rows 200..230, its padding alone in tile (0, 0).  Returns n, the
    off (rows, cols) and the port fields (sym list, schedules built on
    the card) on cuda."""
    rng = np.random.default_rng(5)
    n = 300
    band = {(int(r), int(rng.integers(0, r)))
            for r in rng.integers(100, 140, 150)}
    pats = [sorted({(299, c) for c in range(299)} | band),
            sorted({(int(r), int(rng.integers(64, r)))
                    for r in rng.integers(200, 231, 120)})]
    Ko = max(len(p) for p in pats)
    rows, cols = np.zeros((2, Ko), np.int64), np.zeros((2, Ko), np.int64)
    for b, p in enumerate(pats):
        rows[b, :len(p)] = [e[0] for e in p]
        cols[b, :len(p)] = [e[1] for e in p]
    z = np.zeros((2, 1))
    port = pat.port_fields(n, 1, rows, cols, np.ones((2, Ko)),
                           z.astype(np.int64), z.astype(np.int64), z)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32),  # noqa: E731
                                    device="cuda")
    f = {k: i32(v) for k, v in port.items()
         if np.asarray(v).dtype.kind in "iu"}
    f.update(pat.tile_fields(n, i32(rows), i32(cols), f["sym_slot_rs"],
                             f["sym_cols_rs"], f["bnd_sym_rows"]))
    return n, i32(rows), i32(cols), f


def _k5_k6_inputs(pattern, dtype):
    """(B, n, Ko, K5 args, K5 tiles, K6 (rows, cols), K6 tiles, pad
    slots) of a test pattern on cuda (merged_b2_slice: block 0 of the
    merged bucket as bucket_slice gives it)."""
    if pattern == "skewed":
        n, rows, cols, f = _skewed_pattern()
        ns = types.SimpleNamespace(**f)
        t5, t6 = pat.bucket_tiles(ns, "sym"), pat.bucket_tiles(ns, "off")
        a5 = (f["sym_slot_rs"], f["sym_cols_rs"], f["bnd_sym_rows"])
        return 2, n, rows.shape[1], a5, t5, (rows, cols), t6, rows == cols
    bk = (_mc_bucket(dtype)[0] if pattern == "matcomp500"
          else _bucket(dtype)[0] if pattern == "maxcut2000"
          else _merged_bucket(dtype))
    if pattern == "merged_b2_slice":  # the bucket Gauss-Seidel scan's view
        bk = pat.bucket_slice(bk, 0)
    a5 = (bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows)
    return (bk.B, bk.n, bk.Ko, a5, bk.sym_tiles,
            (bk.off_rows, bk.off_cols), bk.off_tiles,
            bk.off_rows == bk.off_cols)


# r: 1 (K5's segment-sum schedule), 2 .. 65, 130 (K5 staged at f32,
# from L2 at f64, in launches over 64-column blocks from r = 65 on; K6
# from L2 at both: above its staging limit, as K6 is at r = 65 in f64)
# and, for K5, 300 (five column blocks)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 2, 17, 33, 65, 130, 300])
@pytest.mark.parametrize("pattern", ["matcomp500", "merged_b2",
                                     "merged_b2_slice", "skewed"])
def test_wmul_kernel_matches_plain(dtype, r, pattern):
    _need_cuda()
    B, n, Ko, a5, t5, _, _, pad = _k5_k6_inputs(pattern, dtype)
    rng = np.random.default_rng(r)
    X = _rand(rng, (B, n, r), dtype)
    W_d, W_o = _rand(rng, (B, n), dtype), _rand(rng, (B, Ko), dtype)
    W_o[pad] = 0.0
    before = kernels.LAUNCHES["wmul_csr"]
    got = kernels.wmul_csr(X, W_d, W_o, *a5, tiles=t5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wmul_csr"] == before + 1
    ref = kernels.wmul_csr_plain(X, W_d, W_o, *a5)
    l1 = kernels.wmul_csr_plain(X.abs(), W_d.abs(), W_o.abs(), *a5)
    assert _close(got, ref, l1, dtype)
    # the wrapper's own schedule (built on the card) is the bucket's
    assert torch.equal(kernels.wmul_csr(X, W_d, W_o, *a5), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("want_diag", [False, True])
@pytest.mark.parametrize("r", [1, 2, 17, 33, 65, 130])
@pytest.mark.parametrize("pattern", ["matcomp500", "merged_b2",
                                     "merged_b2_slice", "skewed"])
def test_adj_a_kernel_matches_plain(dtype, want_diag, r, pattern):
    _need_cuda()
    B, n, Ko, _, _, args, t6, pad = _k5_k6_inputs(pattern, dtype)
    rng = np.random.default_rng(6)
    X, F = (_rand(rng, (B, n, r), dtype) for _ in range(2))
    a2 = _rand(rng, (B, Ko), dtype).abs()
    a2[pad] = 0.0
    before = kernels.LAUNCHES["adj_a_offdiag"]
    got = kernels.adj_a_offdiag(X, F, *args, a2, want_diag, tiles=t6)
    assert kernels.LAUNCHES["adj_a_offdiag"] == before + 1
    ref = kernels.adj_a_offdiag_plain(X, F, *args, a2, want_diag)
    l1 = kernels.adj_a_offdiag_plain(X.abs(), F.abs(), *args, a2, True)
    assert (got[0] is None) == (not want_diag)
    if want_diag:
        assert _close(got[0], ref[0], l1[0], dtype)
    assert _close(got[1], ref[1], l1[1], dtype)
    assert torch.equal(kernels.adj_a_offdiag(X, F, *args, a2)[1], got[1])


# K3 and K3p on the off slots' schedule: staged tiles (matcomp500, the
# merged batch, the skewed pattern's hub strip) and the warp path (sparse
# tiles; maxcut2000, where nearly every tile is sparse; r = 65 and 130 at
# f64, r = 130 at f32, where the two-factor arrays pass the staging limit)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 2, 17, 33, 65, 130])
@pytest.mark.parametrize("pattern", ["matcomp500", "maxcut2000", "merged_b2",
                                     "merged_b2_slice", "skewed"])
def test_tiled_uvt_kernels_match_plain(dtype, r, pattern):
    _need_cuda()
    B, n, Ko, _, _, args, t6, _ = _k5_k6_inputs(pattern, dtype)
    rng = np.random.default_rng(9)
    U, V = (_rand(rng, (B, n, r), dtype) for _ in range(2))
    # K3, U != V
    before = dict(kernels.LAUNCHES), dict(kernels.ONE_DOT_LAUNCHES)
    got = kernels.uvt_split(U, V, *args, tiles=t6)
    ref = kernels.uvt_split_plain(U, V, *args)
    l1 = kernels.uvt_split_plain(U.abs(), V.abs(), *args)
    for g, e, a in zip(got, ref, l1):
        assert _close(g, e, a, dtype)
    # K3, U is V: one dot an entry, bit for bit the two-dot path on a copy
    one = kernels.uvt_split(U, U, *args, tiles=t6)
    two = kernels.uvt_split(U, U.clone(), *args, tiles=t6)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["uvt_split"] == before[0]["uvt_split"] + 3
    assert kernels.ONE_DOT_LAUNCHES["uvt_split"] == \
        before[1]["uvt_split"] + 1
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    ref = kernels.uvt_split_plain(U, U, *args)
    l1 = kernels.uvt_split_plain(U.abs(), U.abs(), *args)
    for g, e, a in zip(one, ref, l1):
        assert _close(g, e, a, dtype)
    # K3p
    got_p = kernels.uvt_pair_split(U, V, *args, tiles=t6)
    assert kernels.LAUNCHES["uvt_pair_split"] == \
        before[0]["uvt_pair_split"] + 1
    ref = kernels.uvt_pair_split_plain(U, V, *args)
    l1 = kernels.uvt_pair_split_plain(U.abs(), V.abs(), *args)
    for g, e, a in zip(got_p, ref, l1):
        assert _close(g, e, a, dtype)
    # the wrappers' own schedule (built on the card) is the bucket's
    assert torch.equal(kernels.uvt_split(U, V, *args)[1], got[1])
    assert torch.equal(kernels.uvt_pair_split(U, V, *args)[1], got_p[1])


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
        out[dev] = [t.cpu() if isinstance(t, torch.Tensor) else t
                    for t in dual_ls_refine(solver.pd, R, dual, 30)]
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
@pytest.mark.parametrize("rho", [3.5, 0.25])
def test_lp_gs_sweep_kernel_f32_matches_plain(rho):
    """K8c at f32 (the f32 solve's LP sweep): the same rounded steps as
    its plain version; within 64 eps32 of each output's largest
    magnitude, a rounding's difference reaching the later columns through
    csum."""
    _need_cuda()
    from lorads_torch.ops import lp as lp_ops
    problem = _lp_problem()
    lpd = lp_ops.build_lp_data(problem.lp, torch.float32, "cuda")
    rng = np.random.default_rng(11)
    n, m = lpd.n_cols, lpd.m_glob
    u, v = (_rand(rng, (n,), torch.float32) for _ in range(2))
    csum, rhs, dual = (_rand(rng, (m,), torch.float32) for _ in range(3))
    args = (lpd.pc_con, lpd.pc_val, lpd.obj, lpd.col_nrm2sq, u, v, csum,
            rhs, dual, rho)
    before = kernels.F32_LAUNCHES["lp_gs_sweep"]
    got = kernels.lp_gs_sweep(*args)
    assert kernels.F32_LAUNCHES["lp_gs_sweep"] == before + 1
    ref = kernels.lp_gs_sweep_plain(*args)
    for g, e in zip(got, ref):
        assert g.dtype == torch.float32
        tol = 64 * torch.finfo(torch.float32).eps * float(e.abs().max())
        assert float((g - e).abs().max()) <= tol


@pytest.mark.cuda
def test_lp_sums_f32_match_plain():
    """K8a / K8b at f32 (the f32 solve's LP block) against their plain
    versions, within 4 eps32 * sum|terms|."""
    _need_cuda()
    from lorads_torch.ops import lp as lp_ops
    dt = torch.float32
    lpd = lp_ops.build_lp_data(_lp_problem().lp, dt, "cuda")
    rng = np.random.default_rng(12)
    uv = _rand(rng, (lpd.n_cols,), dt)
    w = _rand(rng, (lpd.m_glob,), dt)
    a8 = (lpd.a_col_cs[None], lpd.a_val_cs[None], lpd.bnd_con[None])
    b8 = (lpd.a_con_ls[None], lpd.a_val_ls[None], lpd.bnd_col[None])
    before = kernels.F32_LAUNCHES["gather_segsum"]
    cases = [
        (lp_ops.constr_vals(lpd, uv),
         kernels.gather_segsum_plain(uv[None], *a8)[0],
         kernels.gather_segsum_plain(uv.abs()[None], a8[0], a8[1].abs(),
                                     a8[2])[0]),
        (lp_ops.adjoint_cols(lpd, w, base=lpd.obj, alpha=-1.0),
         kernels.gather_segsum_plain(w[None], *b8, lpd.obj[None], -1.0)[0],
         kernels.gather_segsum_plain(w.abs()[None], b8[0], b8[1].abs(),
                                     b8[2], lpd.obj.abs()[None])[0]),
    ]
    assert kernels.F32_LAUNCHES["gather_segsum"] == before + 2
    for got, ref, l1 in cases:
        assert got.dtype == dt and _close(got, ref, l1, dt)


@pytest.mark.cuda
def test_graph_replay_after_escalation_matches_eager():
    """An auto solve started at f32: its ALM phase at f32, then the
    escalation to f64 (the f32 graphs dropped), then ADMM chunks at f64
    captured anew on the f64 data, each replay bit for bit the same
    chunk run eagerly from the same carry."""
    _need_cuda()
    import time as _time

    from lorads_torch.alg import admm, devloop
    from lorads_torch.alg.admm import ADMMStats
    from lorads_torch.alg.alm import ALMStats
    s = LoradsSolver(read_sdpa(os.path.join(FIX, "hand_multiblock.dat-s")),
                     LoradsParams(verbose=False, dtype="f32",
                                  lp_gauss_seidel=True), device="cuda")
    s._auto_dtype = True
    alm_stats = ALMStats(rho=s.ps.rho0)
    s.alm_phase(alm_stats, _time.time())
    stats = ADMMStats(rho=s.ps.rho0)
    s.alm_to_admm(alm_stats, stats)
    assert s.pd.rhs.dtype == torch.float32
    assert s.maybe_escalate_f64("test")
    assert s.pd.rhs.dtype == torch.float64 and not devloop._LOOPS
    captured = kernels.GRAPHS["captured"]
    with devloop.phase():
        locals_, total, vals = admm.admm_init_eval(
            s.pd, s.U, s.V, s.dual, s.scale_obj_his)
        s._set_admm_stats(stats, vals)
        c = s._admm_start(stats, locals_, total)
        for n in (1, 2):
            c, loop = admm.prepare_chunk(
                s.params, s.pd, c, s.scale_obj_his, s.params.max_admm_iter,
                n, jacobi=s._bucket_jacobi, S=s.S)
            eager = devloop.eager_chunk(loop)
            want = loop.pack(loop.inputs, eager).tolist()
            got_state, got = devloop.run(loop)
            assert got == want
            for g, e in zip(devloop.flatten(got_state)[0],
                            devloop.flatten(eager)[0]):
                assert torch.equal(g, e)
            assert got_state.U.cones[0].dtype == torch.float64
            c["carry"] = got_state
    assert kernels.GRAPHS["captured"] > captured


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

def _probe_ids(shape, sort=True, edge=False):
    """edge: 200 more ids at 767 and at 768, the last segment of a CT =
    256 tile and the first of the next (sub-tiles of 13+ k-chunks on
    either side of the tile boundary)."""
    from numpy.random import default_rng
    n, K = shape
    rng = default_rng(n)
    ids = rng.integers(0, n, K)
    if n < 20000:
        ids = ids[(ids < 256) | (ids >= 512)]          # an empty tile
        ids = np.concatenate([ids, np.full(100, 700)])  # a wide segment
    if edge:
        ids = np.concatenate([ids, np.full(200, 767), np.full(200, 768)])
    return (np.sort(ids) if sort else ids).astype(np.int32)


def _f32(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 5000), (20000, 80000)])
@pytest.mark.parametrize("r", [1, 24, 128])
@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16x2"])
@pytest.mark.parametrize("layout", ["kr", "rk"])
@pytest.mark.parametrize("edge", [False, True])
def test_onehot_scatter_kernel_matches_plain(shape, r, mode, layout, edge):
    """Sub-tiles of more than the ring's three k-chunks (the 100-row
    segment; with edge, 400 rows across a CT tile boundary), odd r (no
    16-byte copies in [K, r]) and K % 4 != 0 (none in [r, K])."""
    _need_cuda()
    from lorads_torch.probes import onehot as oh
    ids = _probe_ids(shape, edge=edge)
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
@pytest.mark.parametrize("shape", [(1000, 5000), (20000, 80000),
                                   (5000, 1237)])
@pytest.mark.parametrize("r", [1, 3, 24, 40, 128])
@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16x2"])
@pytest.mark.parametrize("offset", [0, 1])
def test_onehot_gather_kernel_matches_plain(shape, r, mode, offset):
    """r = 3 and odd (4-byte copies, scalar stores), 40 (two column
    groups); K not a multiple of 16 and 16-id spans of ~60 rows, past a
    16-row chunk (5000, 1237: the ring turns); offset 1: X 4 bytes into
    its storage (not 16-byte aligned: 4-byte copies)."""
    _need_cuda()
    from lorads_torch.probes import onehot as oh
    ids = _probe_ids(shape)
    n, K = shape[0], ids.size
    plan = oh.plan_sorted_gather(ids, n, KT=256, device="cuda")
    assert plan.ok
    store = torch.zeros(n * r + offset, device="cuda")
    X = store[offset:].view(n, r)
    X.copy_(_f32(np.random.default_rng(r), n, r))
    assert (X.data_ptr() % 16 == 0) == (offset == 0)
    got = oh.sorted_gather(X, plan, mode)
    ref = oh.sorted_gather_plain(X, plan, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)          # one row's planes per output
    if mode != "bf16x2":
        assert torch.equal(got, X[torch.as_tensor(ids, device="cuda").long()])
    if n == 5000:
        assert K % 16 and np.max(ids[15::16] - ids[::16][:K // 16]) > 16


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 5000), (20000, 100000), (20000, 1),
                                   (20000, 99997), (60000, 50000),
                                   (5000, 3), (5000, 6), (100000, 20000)])
@pytest.mark.parametrize("form", ["kr1", "kr20", "kr128", "rk1", "rk3",
                                  "rk24", "rk40", "1-D"])
def test_row_gather_kernel_matches_plain(shape, form):
    """Ids at 0 and n - 1, repeated; the transposed layout under every
    schedule whose rows fit (the L2 schedule, 1 and 2 staged rows a
    block): K = 1, K not a multiple of 4 or of a block's slice, R = 1, 3
    (a group of one row at 2 rows a block), 24 and 40, and n = 60000,
    past the shared memory of a block (the L2 schedule alone).  Width 1
    ([n], [n, 1], [1, n]): K = 1, 3, 6 and 99997 (no 4-id vector), ids
    4 bytes into their storage, gE's [100000] table by 20000 ids, under
    each way that fits (rb 0: the direct kernel; 1, 2: the table
    staged)."""
    _need_cuda()
    from lorads_torch.probes import gather
    n, _ = shape
    ids_np = _probe_ids(shape, sort=False)
    ids_np[:3] = [0, n - 1, n - 1][:ids_np.size]
    ids = torch.as_tensor(ids_np, device="cuda")
    rng = np.random.default_rng(7)
    if form == "1-D":
        X, layout = _f32(rng, n), "kr"
    elif form.startswith("rk"):
        X, layout = _f32(rng, int(form[2:]), n), "rk"
    else:
        X, layout = _f32(rng, n, int(form[2:])), "kr"
    plain = gather.row_gather_plain(X, ids, layout)
    got = gather.row_gather(X, ids, layout)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    fit = gather._smem_optin(torch.cuda.current_device()) // (
        -(-n // 4) * 16)
    if layout == "rk":
        assert (fit == 0) == (n >= 60000)
    if layout == "rk" or form in ("1-D", "kr1"):
        for rb in (0, 1, 2)[:fit + 1]:
            got = gather.row_gather(X, ids, layout, rb=rb)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), rb
    if form in ("1-D", "kr1", "rk1") and ids.numel() > 1:
        tail = ids[1:]                      # not 16-byte aligned
        assert tail.data_ptr() % 16
        for rb in (0, 1, 2)[:fit + 1]:
            got = gather.row_gather(X, tail, layout, rb=rb)
            torch.cuda.synchronize()
            assert torch.equal(got, gather.row_gather_plain(X, tail,
                                                            layout)), rb
    with pytest.raises(IndexError):
        gather.row_gather(X, torch.full_like(ids, n), layout)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 0), (1000, 1), (1000, 7),
                                   (1000, 5000), (20000, 160000)])
@pytest.mark.parametrize("r", [0, 1, 2, 5, 24, 128])
@pytest.mark.parametrize("case", ["unsorted", "hub", "offset"])
def test_scatter_add_kernel_matches_plain(shape, r, case):
    """r = 0: 1-D values; r = 2 (float2 reductions), 5 (scalar), 24 and
    128 (float4); K = 0, 1 and 7; "hub": sorted ids, min(K, 5000) of them
    equal; "offset": the values 4 bytes into their storage (scalar
    reductions).  Ids in [0, 3n/4): the rows past them, which no id
    touches, come out exactly 0 from an output whose memory held NaN."""
    _need_cuda()
    from lorads_torch.probes import gather
    n, K = shape
    rng = np.random.default_rng(K + r)
    ids_np = rng.integers(0, 3 * n // 4, K)
    if case == "hub":
        ids_np[:min(K, 5000)] = n // 3
        ids_np = np.sort(ids_np)
    ids = torch.as_tensor(ids_np.astype(np.int32), device="cuda")
    vshape = (K,) if r == 0 else (K, r)
    offset = int(case == "offset")
    store = _f32(rng, int(np.prod(vshape)) + offset)
    vals = store[offset:].view(vshape)
    assert K == 0 or (vals.data_ptr() % 16 == 0) == (offset == 0)
    # the output takes this block: freed, it is the caching allocator's
    # fit for the next request of its size, and nothing asks in between
    garbage = torch.full((n * max(r, 1),), float("nan"), device="cuda")
    at = garbage.data_ptr()
    del garbage
    got = gather.scatter_add(vals, ids, n, check=False)
    assert got.data_ptr() == at
    ref = gather.scatter_add_plain(vals, ids, n)
    l1 = gather.scatter_add_plain(vals.abs(), ids, n)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _close(got.double(), ref.double(), l1.double(), torch.float32)
    idle = slice(3 * n // 4, None)
    assert torch.equal(got[idle], ref[idle])
    assert not bool(got[idle].any())


def _skewed_rows(rng, B, n=6000):
    """A row-sorted entry list [B, Ks] with skewed row lengths: 10 % empty
    rows, one-entry rows, rows of 2-8 entries, 5 % of 9-40 entries (past
    one lane group's load, past K2's long-row threshold of 32) and one
    hub row of 5000 entries (the second block a permutation of the
    first's lengths with its hub cut by 1000, so its bounds end before
    Ks)."""
    lengths = rng.integers(1, 9, n)
    lengths[rng.random(n) < 0.3] = 1
    mid = rng.random(n) < 0.05
    lengths[mid] = rng.integers(9, 41, int(mid.sum()))
    lengths[rng.random(n) < 0.1] = 0
    lengths[n // 3] = 5000
    rows = [lengths]
    for _ in range(B - 1):
        second = rng.permutation(lengths)
        second[np.argmax(second)] -= 1000
        rows.append(second)
    lengths = np.stack(rows)
    Ks = int(lengths.sum(axis=1).max())
    bnd = np.zeros((B, n + 1), np.int32)
    bnd[:, 1:] = np.cumsum(lengths, axis=1)
    cols = rng.integers(0, n, (B, Ks)).astype(np.int32)
    return (torch.as_tensor(cols, device="cuda"),
            torch.as_tensor(bnd, device="cuda"), Ks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 2, 17, 20, 33, 65, 130])
@pytest.mark.parametrize("B", [1, 2])
def test_cmul_kernel_skewed_rows_match_plain(B, r, dtype):
    """K2 on empty rows, one-entry rows, rows of 9-40 entries and a
    5000-entry hub row, with and without the diagonal, at ranks up to
    r = 130 (two and three column tiles of 64): within the stated
    tolerance."""
    _need_cuda()
    rng = np.random.default_rng(100 * B + r)
    cols, bnd, Ks = _skewed_rows(rng, B)
    n = bnd.shape[1] - 1
    vals = _rand(rng, (B, Ks), dtype)
    X = _rand(rng, (B, n, r), dtype)
    for cd in (_rand(rng, (B, n), dtype), None):
        args = (X, cd, cols, vals, bnd)
        before = kernels.LAUNCHES["cmul_csr"]
        got = kernels.cmul_csr(*args)
        assert kernels.LAUNCHES["cmul_csr"] == before + 1
        ref = kernels.cmul_csr_plain(*args)
        l1 = kernels.cmul_csr_plain(X.abs(), None if cd is None else cd.abs(),
                                    cols, vals.abs(), bnd)
        torch.cuda.synchronize()
        assert _close(got, ref, l1, dtype)


def _lp_sweep_case(case, dtype, rng):
    """Synthetic K8c inputs on the CPU: (pc_con, pc_val, obj, nrm2, u, v,
    csum, rhs, dual, rho).  Columns hold increasing ids, padded with m,
    except where the case says otherwise."""
    # m = 60000 lies past the shared-memory room of both dtypes (23596
    # sums at f64, 51860 at f32)
    n, L, m = {"global_m": (300, 40, 60000),
               "repeated_id": (200, 40, 50), "odd_L": (150, 45, 60),
               "one_column": (1, 10, 20), "past_ring": (1000, 74, 120),
               "long_10_rounds": (60, 300, 400),
               "long_35_rounds": (20, 1100, 1500)}[case]
    pc_con = np.full((n, L), m, np.int32)
    for j in range(n):
        k = int(rng.integers(1, L + 1))
        pc_con[j, :k] = np.sort(rng.choice(m, k, replace=False))
    if case == "repeated_id":
        # a repeat inside one round, one across rounds, an unsorted column
        pc_con[3, :6] = (7, 7, 9, 7, 11, 12)
        pc_con[4, [0, 33]] = 5
        pc_con[5, :L] = rng.integers(0, m, L)
    # entries of size 1 / sqrt(L) and fixed values v in [0, 0.5), so that
    # a sweep of 1000 columns stays finite at f32 (NaN != NaN bitwise)
    pc_val = np.where(pc_con < m, rng.standard_normal((n, L)) / np.sqrt(L),
                      0.0)
    nrm2 = (pc_val ** 2).sum(axis=1)

    def vec(k):
        return rng.standard_normal(k)

    arrays = (pc_con, pc_val, vec(n), nrm2, vec(n), 0.5 * rng.random(n),
              vec(m), vec(m), vec(m))
    out = [torch.as_tensor(a) if a.dtype == np.int32
           else torch.as_tensor(a, dtype=dtype) for a in arrays]
    return (*out, 3.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["global_m", "repeated_id", "odd_L",
                                  "one_column", "past_ring",
                                  "long_10_rounds", "long_35_rounds"])
def test_lp_gs_sweep_kernel_cases_bit_for_bit(case, dtype):
    """K8c against its plain version on the CPU (index_add_ there applies
    a repeated id's deltas in order of k, as the kernel does), bit for
    bit: csum in global memory past the shared-memory limit, repeated
    ids, L not a multiple of 32, one column, more columns than the ring
    holds, columns of 10 and of 35 rounds."""
    _need_cuda()
    rng = np.random.default_rng(21)
    cpu = _lp_sweep_case(case, dtype, rng)
    m = cpu[6].shape[0]
    from lorads_torch.ops import build
    smem_max_m = build.load().lt_lp_gs_smem_max_m(int(dtype == torch.float64),
                                                  0)
    assert (m <= smem_max_m) == (case != "global_m")
    dev = tuple(t.to("cuda") for t in cpu[:-1]) + (cpu[-1],)
    before = kernels.LAUNCHES["lp_gs_sweep"]
    got = kernels.lp_gs_sweep(*dev)
    assert kernels.LAUNCHES["lp_gs_sweep"] == before + 1
    ref = kernels.lp_gs_sweep_plain(*cpu)
    for g, e in zip(got, ref):
        assert torch.equal(g.cpu(), e)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["global_m", "repeated_id", "odd_L",
                                  "one_column", "past_ring",
                                  "long_10_rounds"])
def test_lp_gs_sweep_kernel_with_s_bit_for_bit(case, dtype):
    """K8c with the DUAL_U_V term s (a random signed [n]) against its
    plain version on the CPU, bit for bit, in both csum instantiations
    (the s kernel's shared-memory room is its own); and s moves the
    result."""
    _need_cuda()
    rng = np.random.default_rng(23)
    cpu = _lp_sweep_case(case, dtype, rng)
    n, m = cpu[0].shape[0], cpu[6].shape[0]
    s = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
    from lorads_torch.ops import build
    lib = build.load()
    is64 = int(dtype == torch.float64)
    assert lib.lt_lp_gs_smem_max_m(is64, 1) < lib.lt_lp_gs_smem_max_m(is64, 0)
    assert (m <= lib.lt_lp_gs_smem_max_m(is64, 1)) == (case != "global_m")
    dev = tuple(t.to("cuda") for t in cpu[:-1]) + (cpu[-1],)
    before = kernels.LAUNCHES["lp_gs_sweep"]
    got = kernels.lp_gs_sweep(*dev, s=s.to("cuda"))
    assert kernels.LAUNCHES["lp_gs_sweep"] == before + 1
    ref = kernels.lp_gs_sweep_plain(*cpu, s)
    for g, e in zip(got, ref):
        assert torch.equal(g.cpu(), e)
    without = kernels.lp_gs_sweep(*dev)
    assert not torch.equal(without[0].cpu(), ref[0])


# ---------------------------------------------------------------------------
# Device-resident loops (alg/devloop.py): graphed chunks on the card.
# ---------------------------------------------------------------------------

def _mc_cg_loop(dtype):
    """The CG loop of matcomp500's operator (K6, K5) at ``dtype``: a
    device-decided loop (its whole solve one replay)."""
    from lorads_torch.alg import admm, cg, devloop
    bk, bp = _mc_bucket(dtype)
    rng = np.random.default_rng(4)
    F = 0.3 * _rand(rng, (1, bp.n, bp.rank), dtype)
    b = _rand(rng, (1, bp.n, bp.rank), dtype)
    op = cg.Bound(admm._cg_operator(bk), (F,), devloop.ident(bk))
    return cg.cg_loop(op, torch.zeros_like(b), b, 1e-8, 800)


def _mc_alm_solver():
    """(solver, the ALM outer loop of matcomp500 (K3, K3p, K4, K5) from
    its phase's start, two outers a run)."""
    from lorads_torch.alg import alm
    problem = read_sdpa(os.path.join(FIX, "matcomp500.dat-s"))
    s = LoradsSolver(problem, LoradsParams(verbose=False), device="cuda")
    p = s.params
    carry, fixed = alm.alm_start(
        s.pd, p, s.R, s.dual, s.hist, alm.ALMStats(rho=s.ps.rho0),
        s.scale_obj_his, s.is_rank_max(), p.alm_rho_factor,
        s.max_alm_sub_iter, 2, p.max_alm_iter)
    dev = torch.device("cuda")
    inputs = alm.ALMInputs(
        budget=torch.full((), 2 ** 30, device=dev),
        grind_armed=torch.zeros((), dtype=torch.bool, device=dev), **fixed)
    return s, alm.outer_loop(s.pd, inputs, carry)


def _mc_alm_loop(which):
    """matcomp500's ALM outer loop, or its inner L-BFGS loop alone from
    the phase's start (a WHILE node with the refresh's IF node)."""
    from lorads_torch.alg import alm
    s, loop = _mc_alm_solver()
    if which == "alm_outer":
        return loop
    c = loop.state
    rho, p = s.ps.rho0, s.params
    return alm.inner_loop(s.pd, c.R, c.grad, c.hist, c.dual, c.constr_sum,
                          c.cert_val, rho, 0.1 / rho, p.end_alm_sub_tol,
                          p.end_tau_tol, p.phase1_tol, True, 801,
                          caches=c.caches)


def _flat(tree):
    from lorads_torch.alg import devloop
    return devloop.flatten(tree)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cg_f64", "cg_f32", "alm_inner",
                                   "alm_outer"])
def test_graphed_chunk_equals_eager_chunk(which):
    """A device-decided loop replayed from its CUDA graph (WHILE nodes;
    the ALM's refresh an IF node) runs its whole run in one replay and
    equals the same run decided by host reads on the card from the same
    state, bit for bit."""
    _need_cuda()
    from lorads_torch.alg import devloop
    with devloop.phase():
        loop = (_mc_cg_loop(torch.float64 if which == "cg_f64"
                            else torch.float32)
                if which.startswith("cg") else _mc_alm_loop(which))
        eager = _flat(devloop.eager_chunk(loop))
        graph, load, bufs = devloop.graph_chunk(loop)
        load()
        graph.replay()
        got = _flat(bufs.tree("state"))
        for g, e in zip(got, eager):
            assert torch.equal(g, e)


@pytest.mark.cuda
def test_host_read_inside_capture_raises():
    """A step that reads the host fails its capture loudly; the loop does
    not go on eagerly."""
    _need_cuda()
    from lorads_torch import device as tdev
    from lorads_torch.alg import devloop
    calls = []

    def step(inp, st, kind):
        calls.append(kind)
        x = st[0] + inp[0]
        tdev.host_read(x.sum(), "other")
        return (x,)

    loop = devloop.Loop(
        key=("reads",), step=step,
        pack=lambda inp, st: torch.ones(1, dtype=torch.float64,
                                        device="cuda"),
        inputs=(torch.ones(3, device="cuda"),),
        state=(torch.zeros(3, device="cuda"),), label="other",
        running=lambda inp, st: st[0].sum() < 30)
    with devloop.phase():
        with pytest.raises(RuntimeError):
            devloop.run(loop)
    # the warm-up's step (kind(0)), then the capture's (kind None)
    assert calls == [None, None]


@pytest.mark.cuda
def test_launches_count_per_replay():
    """kernels.LAUNCHES after 3 replays of an ALM run's graph from the
    same state, each read: 3 times one replay's, none at its capture."""
    _need_cuda()
    from lorads_torch.alg import devloop
    with devloop.phase():
        _, loop = _mc_alm_solver()
        devloop.eager_chunk(loop)            # build, set attributes
        kernels.reset_launches()
        graph, load, _ = devloop.graph_chunk(loop)
        assert not any(kernels.LAUNCHES.values())
        load()
        graph.replay()
        graph.read("alm")
        once = dict(kernels.LAUNCHES)
        assert once["uvt_pair_split"] > 0 and once["loop_cond"] > 0
        for _ in range(2):
            load()
            graph.replay()
            graph.read("alm")
        assert kernels.LAUNCHES == {k: 3 * n for k, n in once.items()}
        assert kernels.GRAPHS["replayed"] == 3


# ---------------------------------------------------------------------------
# Device-decided loops: WHILE nodes, the graphed ADMM chunk.
# ---------------------------------------------------------------------------

def _count_loop(n):
    """A device-decided loop that adds 1 until its count reaches n."""
    from lorads_torch.alg import devloop
    dev = torch.device("cuda")
    return devloop.Loop(
        key=("count",), step=lambda inp, st, kind: (st[0] + 1, st[1] * 2),
        pack=lambda inp, st: st[0].to(torch.float64).reshape(1),
        inputs=(torch.full((), n, dtype=torch.int64, device=dev),),
        state=(torch.zeros((), dtype=torch.int64, device=dev),
               torch.ones((), dtype=torch.float64, device=dev)),
        K=None, label="other", running=lambda inp, st: st[0] < inp[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 37])
def test_while_node_runs_to_its_device_exit(n):
    """One replay runs a WHILE node's body until the device's exit test
    fails (also never, at n = 0); its closing kernel counts each run."""
    _need_cuda()
    from lorads_torch.alg import devloop
    with devloop.phase():
        loop = _count_loop(n)
        graph, load, bufs = devloop.graph_chunk(loop)
        load()
        kernels.reset_launches()
        graph.replay()
        assert graph.read("other") == [float(n)]
        st = bufs.tree("state")
        assert int(st[0]) == n and float(st[1]) == 2.0 ** n
        # the condition set before the node, and the body's closing
        # kernel once a run
        assert kernels.LAUNCHES["loop_cond"] == 1 + n


@pytest.mark.cuda
def test_captures_logs_warm_up_and_capture_once_a_key():
    """devloop.captures: a key's first run logs its warm-up and its
    capture, each with its start and seconds; a replay logs nothing, and
    nothing is logged outside the context."""
    _need_cuda()
    from lorads_torch.alg import devloop
    with devloop.phase():
        with devloop.captures() as caps:
            t0 = time.time()
            devloop.run(_count_loop(5))
            assert [k for k, _, _ in caps] == ["warm_up", "capture"]
            assert all(t >= t0 and sec >= 0.0 for _, t, sec in caps)
            devloop.run(_count_loop(7))
            assert len(caps) == 2
        devloop.run(_count_loop(3))
        assert len(caps) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("acts", [("CPU",), ("CPU", "CUDA")])
def test_device_decided_graph_under_a_trace(acts):
    """Under torch.profiler a device-decided loop runs eagerly (a graph
    of WHILE nodes replayed under a CUDA trace hit an illegal address on
    the card: ROADMAP F4): with CUDA activity its kernels are in the
    trace, one event a launch at least, and its result equals the
    untraced graph's run bit for bit."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from lorads_torch.alg import devloop
    with devloop.phase():
        loop = _mc_cg_loop(torch.float64)
        graph_state, graph_out = devloop.run(loop)    # warm-up, capture
        captured = kernels.GRAPHS["captured"]
        kernels.reset_launches()
        with profile(activities=[getattr(ProfilerActivity, a)
                                 for a in acts]) as prof:
            assert devloop.tracing()
            state, out = devloop.run(loop)
            torch.cuda.synchronize()
        assert not devloop.tracing()
        launches = dict(kernels.LAUNCHES)
    assert out == graph_out
    for g, e in zip(_flat(state), _flat(graph_state)):
        assert torch.equal(g, e)
    assert kernels.GRAPHS["captured"] == 0 and captured > 0
    assert launches["loop_cond"] == 0
    # K6 (SDDMM kernels) and K5 launched eagerly, each an event
    assert launches["adj_a_offdiag"] > 0 and launches["wmul_csr"] > 0
    events = {e.key: e.count for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU}
    sddmm = sum(n for k, n in events.items() if "sddmm_" in k)
    if "CUDA" in acts:
        assert sddmm >= launches["adj_a_offdiag"]
    else:
        assert not events


def _admm_solver(name):
    """A solver right after its ALM phase on the card, and the ADMM
    stats it hands over."""
    import time

    from lorads_torch.alg.admm import ADMMStats
    from lorads_torch.alg.alm import ALMStats
    problems = {
        "theta_gtoy60": lambda: read_sdpa(os.path.join(
            FIX, "theta_gtoy60.dat-s")),
        "hand_multiblock": lambda: read_sdpa(os.path.join(
            FIX, "hand_multiblock.dat-s")),
        "matcomp500": lambda: read_sdpa(os.path.join(
            FIX, "matcomp500.dat-s")),
        "maxcut300": lambda: generators.maxcut(n=300, avg_degree=4, seed=3),
        "rmb2": lambda: generators.random_multiblock(
            n_blocks=2, dim=8, m=6, n_lp=4, seed=2)}
    key = name.split(":")[0]
    params = LoradsParams(verbose=False,
                          lp_gauss_seidel=name.endswith(":lp_gs"))
    s = LoradsSolver(problems[key](), params, device="cuda")
    alm_stats = ALMStats(rho=s.ps.rho0)
    s.alm_phase(alm_stats, time.time())
    stats = ADMMStats(rho=s.ps.rho0)
    s.alm_to_admm(alm_stats, stats)
    return s, stats


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["theta_gtoy60", "hand_multiblock:lp_gs",
                                  "rmb2", "maxcut300", "matcomp500"])
def test_graphed_admm_chunks_equal_eager(name):
    """Three ADMM chunks as the solver runs them (``devloop.run``: a
    warm-up and the capture of one graph, a WHILE node of ADMM
    iterations with the CG and refinement loops WHILE nodes inside and
    the restart an IF node; then replays of it with each chunk's inputs)
    against the same chunks run eagerly on the card from the same carry:
    the pack and every state tensor bit for bit (both sides launch the
    same kernels on the same inputs in the same order), and a replay's
    launches, counted from its pack, equal to the eager run's but for
    the conditional nodes' own kernel."""
    _need_cuda()
    from lorads_torch.alg import admm, devloop
    s, stats = _admm_solver(name)
    with devloop.phase():
        locals_, total, vals = admm.admm_init_eval(
            s.pd, s.U, s.V, s.dual, s.scale_obj_his)
        s._set_admm_stats(stats, vals)
        c = s._admm_start(stats, locals_, total)
        cg = 0
        for j, n in enumerate((10, 20, 40)):
            c, loop = admm.prepare_chunk(
                s.params, s.pd, c, s.scale_obj_his, s.params.max_admm_iter,
                n, jacobi=s._bucket_jacobi, S=s.S)
            kernels.reset_launches()
            eager = devloop.eager_chunk(loop)
            torch.cuda.synchronize()
            eager_launches = dict(kernels.LAUNCHES)
            want = loop.pack(loop.inputs, eager).tolist()
            kernels.reset_launches()
            got_state, got = devloop.run(loop)
            replay_launches = dict(kernels.LAUNCHES)
            assert got == want
            for g, e in zip(devloop.flatten(got_state)[0],
                            devloop.flatten(eager)[0]):
                assert torch.equal(g, e)
            assert eager_launches.pop("loop_cond") == 0
            assert replay_launches.pop("loop_cond") > 0
            if j:                    # the first also warms up
                assert replay_launches == eager_launches
            c["carry"] = got_state
            cg += int(got[7])        # the pack's cg_iter
    # Max-Cut's closed form runs no CG
    assert (cg > 0) == (name != "maxcut300")


@pytest.mark.cuda
def test_admm_chunk_reads_once():
    """A solve's ADMM phases on the card: each chunk replays its graph
    (the first of a key after a warm-up that reads nothing) and reads
    the host once (label admm); the CG inside makes no read."""
    _need_cuda()
    from lorads_torch import device as tdev
    from lorads_torch.alg import admm
    problem = read_sdpa(os.path.join(FIX, "theta_gtoy60.dat-s"))
    s = LoradsSolver(problem, LoradsParams(verbose=False), device="cuda")
    chunks = []
    run = admm.admm_chunk

    def counted(*a, **k):
        before = dict(tdev.HOST_SYNCS_BY)
        out = run(*a, **k)
        chunks.append({key: n - before[key]
                       for key, n in tdev.HOST_SYNCS_BY.items()
                       if n > before[key]})
        return out

    admm.admm_chunk = counted
    try:
        res = s.solve()
    finally:
        admm.admm_chunk = run
    assert res.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert len(chunks) > 2 and s.admm_cg_total > 0
    assert all(c == {"admm": 1} for c in chunks), chunks
    assert not s.admm_reads_by.get("cg") and not s.admm_reads_by.get("cg_ir")


# ---------------------------------------------------------------------------
# K9 and the certificate's and the repair's device loops.
# ---------------------------------------------------------------------------

# K9 against torch.linalg.eigh on the same card, in units of n eps of the
# matrix's type: eigenvalues within SYM_EIG_C n eps ||A||_2, residual
# columns ||A v - lambda v|| within SYM_EIG_C n eps ||A||_2, V^T V within
# SYM_EIG_C n eps of I, and the lowest eigenvectors' angle within their
# backward errors over the lowest gap (Davis-Kahan): sin(angle) * gap
# within SYM_EIG_C n eps ||A||_2 (a cluster's basis and a vector's sign
# are free; a fixed 1 - |<v_0, v_0 plain>| bound fails near a gap of
# 1e-9, where both solvers' vectors move by n eps ||A|| / gap); measured
# on an H100 at most 2.0 n eps for the others
SYM_EIG_C = 8


def _sym_eig_input(case, B, n, dtype, rng):
    """[B, n, n] symmetric: ``random`` (Gaussian), ``lanczos_T`` (the
    tridiagonal of a k = n Lanczos sweep of a random symmetric 200 x 200
    matrix, as the certificate builds it), ``clustered`` (a masked
    projected slack: n // 2 real dims with eigenvalues in clusters 1e-9
    apart under a random rotation, the rest ``big`` on the diagonal),
    ``masked`` (the repair's projected slack built as
    spectral_repair.py:179-188 builds it: a symmetric P masked to the real
    basis width, big = delta + |delta| + 1 on the padded diagonal, delta =
    0.5; real widths n // 2, 1 and n in turn over the batch),
    ``decoupled`` (rows 0, n // 2 and n - 1 with exactly-zero off-diagonal
    entries, their diagonal row 1's, as Lanczos breakdown slots)."""
    if case in ("masked", "decoupled"):
        X = rng.standard_normal((B, n, n))
        A = X + np.swapaxes(X, 1, 2)
        if case == "masked":
            big = 0.5 + abs(0.5) + 1.0
            for b in range(B):
                m = (np.arange(n) < (n // 2, 1, n)[b % 3]).astype(float)
                m2 = m[:, None] * m[None, :]
                A[b] = A[b] * m2 + big * (1.0 - m2) * np.eye(n)
        else:
            for i in {0, n // 2, n - 1}:
                d = A[:, 1 % n, 1 % n].copy()
                A[:, i, :] = 0.0
                A[:, :, i] = 0.0
                A[:, i, i] = d
        return torch.as_tensor(A, dtype=dtype, device="cuda")
    if case == "random":
        X = rng.standard_normal((B, n, n))
        return torch.as_tensor(X + np.swapaxes(X, 1, 2), dtype=dtype,
                               device="cuda")
    if case == "lanczos_T":
        from lorads_torch.alg import lanczos
        X = rng.standard_normal((B, 200, 200))
        M = torch.as_tensor(X + np.swapaxes(X, 1, 2), dtype=dtype,
                            device="cuda")
        v0 = torch.as_tensor(rng.standard_normal((B, 200)), dtype=dtype,
                             device="cuda")
        al, be, _ = lanczos._sweep(
            lambda x: (M @ x[:, :, None])[:, :, 0], (), v0, n)
        al, be = al.T, be.T[:, :n - 1]
        return (torch.diag_embed(al) + torch.diag_embed(be, 1)
                + torch.diag_embed(be, -1)).contiguous()
    p = max(n // 2, 1)
    A = np.zeros((B, n, n))
    for b in range(B):
        lam = np.repeat(rng.standard_normal(-(-p // 3)), 3)[:p]
        lam = lam + 1e-9 * rng.standard_normal(p)
        Q, _ = np.linalg.qr(rng.standard_normal((p, p)))
        A[b, :p, :p] = (Q * lam) @ Q.T
        A[b, p:, p:] = np.eye(n - p) * (np.abs(lam).max() + 1.0)
    return torch.as_tensor(A, dtype=dtype, device="cuda")


def _sym_eig_errors(A, got, ref):
    B, n, _ = A.shape
    ne = n * torch.finfo(A.dtype).eps
    (w, V), (wp, Vp) = ((x.double() for x in pair) for pair in (got, ref))
    scale = wp.abs().amax(dim=1).clamp(min=1e-300)
    Ad = A.double()
    ev = float(((w - wp).abs().amax(dim=1) / scale).max()) / ne
    res = torch.linalg.vector_norm(Ad @ V - V * w[:, None, :], dim=1)
    res = float((res.amax(dim=1) / scale).max()) / ne
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    orth = float((V.transpose(1, 2) @ V - eye).abs().max()) / ne
    align = 0.0
    if n > 1:
        # the lowest vectors' angle against the lowest gap (Davis-Kahan:
        # sin <= backward error / gap), where the gap is not 0
        gap = wp[:, 1] - wp[:, 0]
        gapped = gap > 0
        if bool(gapped.any()):
            v, u = V[:, :, 0], Vp[:, :, 0]
            dots = (v * u).sum(dim=1, keepdim=True)
            sin = torch.linalg.vector_norm(v - dots * u, dim=1)
            align = float((sin * gap / scale)[gapped].max()) / ne
    return ev, res, orth, align


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 4, 22])
@pytest.mark.parametrize("n", [1, 2, 12, 36, 48, 64])
@pytest.mark.parametrize("case", ["random", "lanczos_T", "clustered",
                                  "masked", "decoupled"])
def test_sym_eig_small_kernel_matches_plain(case, n, B, dtype):
    """K9 against its plain version (torch.linalg.eigh) on the card within
    SYM_EIG_C n eps; eigenvalues ascending; one launch counted; the
    sweeps written where asked, within the cap; an index whose
    off-diagonal row is exactly zero keeps its diagonal as an eigenvalue
    and e_i as that eigenvalue's column, exactly."""
    _need_cuda()
    A = _sym_eig_input(case, B, n, dtype, np.random.default_rng(n + B))
    sweeps = torch.zeros(B, dtype=torch.int32, device="cuda")
    before = kernels.LAUNCHES["sym_eig_small"]
    got = kernels.sym_eig_small(A, sweeps)
    assert kernels.LAUNCHES["sym_eig_small"] == before + 1
    ref = kernels.sym_eig_small_plain(A)
    torch.cuda.synchronize()
    assert got[0].shape == (B, n) and got[1].shape == (B, n, n)
    assert bool((got[0][:, 1:] >= got[0][:, :-1]).all())
    assert max(_sym_eig_errors(A, got, ref)) <= SYM_EIG_C
    assert 0 <= int(sweeps.min()) and int(sweeps.max()) <= 32
    w, V = got
    off = A.tril(-1) != 0
    free = ~(off.any(dim=1) | off.any(dim=2))
    for b, i in free.nonzero().tolist():
        cols = (V[b, i] == 1).nonzero().flatten().tolist()
        assert len(cols) == 1 and bool(w[b, cols[0]] == A[b, i, i])
        e = torch.zeros_like(V[b, :, 0])
        e[i] = 1
        assert torch.equal(V[b, :, cols[0]], e)


def _cert_loop_of(name):
    """The certificate's Lanczos loop of ``name``'s bucket at a seeded
    dual and start (the f32 sweeps, K9, the f64 refinement in the pack)."""
    from lorads_torch.alg import solver as solver_mod
    if name == "maxcut2000":
        problem = read_sdpa(os.path.join(FIX, "maxcut2000.dat-s"))
    else:
        problem = generators.matrix_completion(n1=600, n2=600, true_rank=3,
                                               frac_obs=0.12, seed=3)
    s = LoradsSolver(problem, LoradsParams(verbose=False), device="cuda")
    bk = s.pd.buckets[0]
    rng = np.random.default_rng(5)
    dual = torch.as_tensor(0.05 * rng.standard_normal(s.pd.m), device="cuda")
    v0 = torch.as_tensor(rng.standard_normal((bk.B, bk.n)), device="cuda")
    return solver_mod._certificate(bk, pat.gather_w(bk, -dual), v0,
                                   torch.float64)[1]


def _active_set_loop_of():
    """theta_gtoy60's active-set loop at its repair state's dual, over a
    seeded 6-column orthonormal basis."""
    from lorads_torch.alg import spectral_repair as rep
    problem = read_sdpa(os.path.join(FIX, "theta_gtoy60.dat-s"))
    s = LoradsSolver(problem, LoradsParams(verbose=False), device="cuda")
    bk = s.pd.buckets[0]
    dual = np.load(os.path.join(FIX, "cert_states.npz"))["theta_gtoy60_dual"]
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.standard_normal((bk.n, 6)))
    Bm = np.zeros((1, bk.n, rep.P_CAP))
    Bm[0, :, :6] = Q
    pm = np.zeros((1, rep.P_CAP))
    pm[0, :6] = 1.0
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return rep.active_set_loop(bk, t(Bm), t(pm), t(dual), s.pd.rhs, 0.5,
                               1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["maxcut2000", "matcomp600", "active_set"])
def test_cert_and_repair_loops_graph_equals_eager(which):
    """The certificate's Lanczos loop (K2 or K5 at r = 1, K9 at f32) and
    the repair's active set (K3, K4, K9 at f64, solve_ex) replayed from
    their graphs (a WHILE node of restarts with the sweep a WHILE node
    inside; a WHILE node of iterations) equal the same runs decided by
    host reads on the card, bit for bit, twice in a row; a replay reads
    the host once, under the loop's label."""
    _need_cuda()
    from lorads_torch import device as tdev
    from lorads_torch.alg import devloop
    with devloop.phase():
        for _ in range(2):
            loop = (_active_set_loop_of() if which == "active_set"
                    else _cert_loop_of(which))
            eager = devloop.eager_chunk(loop)
            want = loop.pack(loop.inputs, eager).tolist()
            before = dict(tdev.HOST_SYNCS_BY)
            state, got = devloop.run(loop)
            reads = {k: n - before[k] for k, n in tdev.HOST_SYNCS_BY.items()
                     if n > before[k]}
            assert reads == {loop.label: 1}
            assert got == want
            for g, e in zip(_flat(state), _flat(eager)):
                assert torch.equal(g, e)


@pytest.mark.cuda
def test_step_solve_ex_captures():
    """The active set's f32 step solve, torch.linalg.solve_ex on a
    [144, 144] system, captured into a CUDA graph: the replay equals the
    eager call bit for bit."""
    _need_cuda()
    rng = np.random.default_rng(17)
    G = torch.as_tensor(rng.standard_normal((144, 600)), device="cuda")
    M = G @ G.T
    M = (M + 1e-2 * torch.trace(M) / 144 * torch.eye(144, device="cuda"))
    M = (M / M.abs().max()).float()
    t = torch.as_tensor(rng.standard_normal(144), dtype=torch.float32,
                        device="cuda")
    want = torch.linalg.solve_ex(M, t)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.linalg.solve_ex(M, t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = torch.linalg.solve_ex(M, t)[0]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_certificate_reads_once_a_lanczos_bucket():
    """A maxcut2000 solve on the card (its certificate a Lanczos bucket):
    each certificate pass runs one Lanczos loop that reads the host once
    (label lanczos) and makes no ``other`` read."""
    _need_cuda()
    from lorads_torch import device as tdev
    from lorads_torch.alg.solver import LoradsSolver as Solver
    s = LoradsSolver(read_sdpa(os.path.join(FIX, "maxcut2000.dat-s")),
                     LoradsParams(verbose=False), device="cuda")
    passes, run = [], Solver._dual_infeas_pass

    def counted(self):
        before = dict(tdev.HOST_SYNCS_BY)
        out = run(self)
        passes.append({k: n - before[k] for k, n in
                       tdev.HOST_SYNCS_BY.items() if n > before[k]})
        return out

    Solver._dual_infeas_pass = counted
    try:
        res = s.solve()
    finally:
        Solver._dual_infeas_pass = run
    assert res.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert passes and all(p == {"lanczos": 1} for p in passes), passes
    assert s.last_cert_restarts[0] >= 1


# ---------------------------------------------------------------------------
# The shard layouts (parallel/pattern_sharded.py, row_sharded.py): each
# kernel at their shapes against its plain version, and the building
# blocks on a one-rank NCCL group against their unplaced runs.
# ---------------------------------------------------------------------------

def _shard_buckets(dtype, device):
    """(summed Max-Cut, summed matrix completion, rowshard theta) at D = 4
    built on ``device``."""
    from lorads_torch.parallel.pattern_sharded import build_pattern_shards
    from lorads_torch.parallel.row_sharded import build_rowshard_bucket
    out = []
    for problem, kind in (
            (generators.maxcut(n=2000, avg_degree=6, seed=1), "sp"),
            (generators.matrix_completion(n1=300, n2=300, true_rank=3,
                                          frac_obs=0.05, seed=2), "sp"),
            (generators.lovasz_theta(n=200, avg_degree=8, seed=5), "tp")):
        plan = presolve(problem, LoradsParams()).plans[0]
        out.append(build_pattern_shards(plan, problem.m, 4, dtype,
                                        summed=True, device=device)
                   if kind == "sp" else
                   build_rowshard_bucket(plan, problem.m, 4, dtype,
                                         device=device))
    return out


def _close_all(got, ref, dtype, name):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        g, r = g.cpu().double(), r.double()
        tol = _tol(dtype) * max(float(r.abs().max()), 1.0) * 64
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        assert float((g - r).abs().max()) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_shard_layout_kernels_match_plain(dtype):
    """K2 (cmul) and K3 on the summed Max-Cut shards, K3, K3p, K4 and K5
    on the summed matrix-completion shards, K4 on the row slabs (A(.)
    and W), each at B = 4 on CUDA tensors against the plain versions on
    CPU copies of the same buckets."""
    _need_cuda()
    gpu = _shard_buckets(dtype, "cuda")
    cpu = _shard_buckets(dtype, "cpu")
    rng = np.random.default_rng(0)
    for (bg, bc), what in zip(zip(gpu, cpu), ("maxcut", "matcomp",
                                                "theta")):
        n, r = bg.n, 5
        U, V = (torch.as_tensor(rng.standard_normal((1, n, r))).to(dtype)
                for _ in range(2))
        w = torch.as_tensor(rng.standard_normal(bg.m_glob)).to(dtype)
        before = dict(kernels.LAUNCHES)
        for fn, name in ((lambda b, u, v: pat.uvt(b, u, v), "uvt"),
                         (lambda b, u, v: pat.constr_vals(
                             b, pat.uvt(b, u, v)), "constr_vals")):
            _close_all(fn(bg, U.cuda(), V.cuda()), fn(bc, U, V), dtype,
                       f"{what} {name}")
        if what == "maxcut":
            _close_all(pat.cmul(bg, U.cuda()), pat.cmul(bc, U), dtype,
                       "maxcut cmul")
        if what != "maxcut":
            Wg = pat.build_w(bg, pat.gather_w(bg, w.cuda()))
            Wc = pat.build_w(bc, pat.gather_w(bc, w))
            _close_all(Wg, Wc, dtype, f"{what} build_w")
            _close_all(pat.w_mul(bg, Wg, V.cuda()), pat.w_mul(bc, Wc, V),
                       dtype, f"{what} w_mul")
        if what == "matcomp":
            _close_all(pat.uvt_pair(bg, U.cuda(), V.cuda())[1],
                       pat.uvt_pair(bc, U, V)[1], dtype, "uvt_pair")
        ran = {k for k in kernels.LAUNCHES if kernels.LAUNCHES[k] >
               before[k]}
        want = {"maxcut": {"cmul_csr", "uvt_split"},
                "matcomp": {"uvt_split", "uvt_pair_split", "gather_segsum",
                            "wmul_csr"},
                "theta": {"gather_segsum"}}[what]
        assert want <= ran, (what, ran)


@pytest.mark.cuda
def test_one_rank_nccl_building_blocks():
    """sharded_solver_step, make_sharded_gradient and
    make_row_sharded_gradient on a one-rank NCCL group (CUDA tensors)
    against their unplaced runs (no group, no collective)."""
    _need_cuda()
    import torch.distributed as dist

    from lorads_torch.alg import aop
    from lorads_torch.parallel import comm, distributed
    from lorads_torch.parallel.pattern_sharded import (
        build_pattern_shards, make_sharded_gradient)
    from lorads_torch.parallel.row_sharded import (
        build_row_shards, make_row_sharded_gradient)
    from lorads_torch.parallel.sharded import sharded_solver_step

    distributed.init_multihost(store=dist.HashStore(), rank=0,
                               world_size=1, device="cuda")
    try:
        mesh = distributed.solver_mesh(1, "cuda")
        assert mesh is not None and mesh.size == 1
        comm.reset()
        s = LoradsSolver(generators.random_multiblock(
            n_blocks=8, dim=12, m=10, seed=3), LoradsParams(verbose=False),
            device="cuda")
        got = sharded_solver_step(mesh, s.pd, s.U, s.V, s.dual, 1.0)
        ref = sharded_solver_step(None, s.pd, s.U, s.V, s.dual, 1.0)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-10)
        assert comm.CALLS["scatter_constr"] == 3
        rng = np.random.default_rng(0)
        for kind in ("sp", "tp"):
            problem = (generators.maxcut(n=2000, avg_degree=6, seed=1)
                       if kind == "sp" else
                       generators.lovasz_theta(n=200, avg_degree=8, seed=5))
            s = LoradsSolver(problem, LoradsParams(verbose=False),
                             device="cuda")
            plan = s.ps.plans[0]
            dual = torch.as_tensor(rng.standard_normal(problem.m),
                                   device="cuda")
            rho = 1.7
            U = s.R.cones[0][0]
            if kind == "sp":
                data = build_pattern_shards(plan, problem.m, 4,
                                            torch.float64, device="cuda")
                step = make_sharded_gradient(mesh, data, s.pd.rhs,
                                             s.pd.c_nrm_inf)
            else:
                data = build_row_shards(plan, problem.m, 4, torch.float64,
                                        device="cuda")
                step = make_row_sharded_gradient(mesh, data,
                                                 s.pd.c_nrm_inf)
            total, grad, cert = step(U, s.pd.rhs, dual, rho)
            _, tot0 = aop.auv(s.pd, s.R, s.R)
            g0 = aop.grad(s.pd, s.R, rho * (tot0 - s.pd.rhs) - dual)
            torch.testing.assert_close(total, tot0, rtol=1e-9, atol=1e-10)
            torch.testing.assert_close(grad, g0.cones[0][0], rtol=1e-9,
                                       atol=1e-10)
            assert float(cert) == pytest.approx(
                float(aop.cert_value(s.pd, g0)), rel=1e-9)
    finally:
        dist.destroy_process_group()
