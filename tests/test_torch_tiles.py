"""The tile schedules of K5 and K6 (kernels.Tiles) on the CPU.

The schedules are built once per split bucket, where it lies
(pattern.tile_fields: kernels.adj_tiles over the off slots,
kernels.wmul_tiles over the full-symmetric entry list); the CUDA kernels
read them and nothing here runs a kernel.  Checked on matcomp500, on the split buckets of
hand_multiblock (presolved with dense mode off), on a merged B = 2
batch of two matrix completions and on a hand-made skewed pattern (a
hub row, empty tiles, a tile that holds only padding):

* the invariants: every entry appears exactly once, in its unit's row
  range and, for a staged unit, its column range; bounds and unit rows
  are monotone; padding slots and entries are scheduled like the rest;
* a torch walk over each schedule (test-only code, in the order the
  kernels decode it) gives what lorads_tpu computes from the same numpy
  inputs on the CPU at f64: on the off slots K3's sym(U V^T) (its uvt),
  K3's one dot when V is U (its uvt_from_cache of its gather_cache),
  K3p's sym(R D^T) and D D^T (its uvt_pair) and a2 .* sym(X F^T) (its
  a_adj_a of its uvt), and W @ X (its w_mul), within rtol 1e-11 plus
  4 * 2^-48 * sum|terms| (lorads_tpu's compensated prefix scan splits
  each term into two f32 planes, as tests/test_torch_sparse.py states);
  the skewed pattern's off values against lorads_tpu's uvt, uvt_pair
  and uvt_from_cache on its off (rows, cols).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.core.problem import merge_problems
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_tpu.ops import pattern as tpu_pat
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
F64_PREFIX = 2.0 ** -48
MASK = (1 << kernels.IJ_SHIFT) - 1


def _problem(name):
    if name == "matcomp500":
        return tpu_sdpa.read_sdpa(FIX + "matcomp500.dat-s"), TpuParams()
    if name == "hand_multiblock":
        # every block in sparse (split) mode
        return (tpu_sdpa.read_sdpa(FIX + "hand_multiblock.dat-s"),
                TpuParams(dense_dim_threshold=0, dense_threshold=1.1,
                          per_matrix_dense_threshold=1.1))
    return merge_problems([
        tpu_gen.matrix_completion(n1=60, n2=60, frac_obs=0.05, seed=1),
        tpu_gen.matrix_completion(n1=40, n2=50, frac_obs=0.05,
                                  seed=2)]), TpuParams()


@functools.lru_cache(maxsize=None)
def _buckets(name):
    """[(lorads_tpu bucket, port bucket, plan)] of the split buckets."""
    problem, params = _problem(name)
    out = []
    for bp in tpu_presolve.presolve(problem, params).buckets:
        if not bp.dense:
            out.append((tpu_pat.build_bucket_data(bp, problem.m,
                                                  jnp.float64),
                        t_pat.build_bucket_data(bp, problem.m,
                                                torch.float64, "cpu"), bp))
    assert out
    return out


def _skewed():
    """Two blocks on n = 300: block 0 a hub row (row 299 against every
    column), a 40-row band of short rows and empty tiles; block 1 only
    rows 200..230 (tile (0, 0) then holds only block 1's padding)."""
    rng = np.random.default_rng(5)
    n = 300
    pats = []
    hub = [(299, c) for c in range(299)]
    band = {(int(r), int(c)) for r in rng.integers(100, 140, 150)
            for c in [rng.integers(0, r)]}
    pats.append(sorted(set(hub) | band))
    rows1 = rng.integers(200, 231, 120)
    pats.append(sorted({(int(r), int(rng.integers(64, r))) for r in rows1}))
    Ko = max(len(p) for p in pats)
    off_rows = np.zeros((2, Ko), np.int64)
    off_cols = np.zeros((2, Ko), np.int64)
    c_off = np.zeros((2, Ko))
    for b, p in enumerate(pats):
        off_rows[b, :len(p)] = [e[0] for e in p]
        off_cols[b, :len(p)] = [e[1] for e in p]
        c_off[b, :len(p)] = rng.standard_normal(len(p))
    z = np.zeros((2, 1))
    port = t_pat.port_fields(n, 1, off_rows, off_cols, c_off,
                             z.astype(np.int64), z.astype(np.int64), z)
    port.update(t_pat.tile_fields(n, *(
        torch.as_tensor(np.asarray(a, np.int32)) for a in (
            off_rows, off_cols, port["sym_slot_rs"], port["sym_cols_rs"],
            port["bnd_sym_rows"]))))
    return n, off_rows, off_cols, port


def _tiles(d, kind):
    return t_pat.bucket_tiles(types.SimpleNamespace(**d), kind)


def _decode(t, b):
    """(row, col, slot, unit) of block b's scheduled entries, in order."""
    bnd = t.bnd[b].long()
    unit = torch.repeat_interleave(torch.arange(bnd.numel() - 1),
                                   bnd[1:] - bnd[:-1])
    L = int(bnd[-1])
    ij = t.ij[b, :L].long()
    return (t.row0[b].long()[unit] + (ij >> kernels.IJ_SHIFT), ij & MASK,
            t.slot[b, :L].long(), unit)


def _check_schedule(t, rows, cols, slots, n, emax=None, emax_l2=None,
                    row_runs=False, units=None):
    """The invariants of one schedule against the entries (rows, cols,
    slots) [B, N] it was built from (all of them live); units of at most
    emax (staged) and emax_l2 (L2) entries; row_runs: a unit's entries
    come row by row (K5's per-row sums need it)."""
    B, N = rows.shape
    assert t.slot.dtype == t.ij.dtype == t.bnd.dtype == torch.int32
    # per block (staged units, units of sparse tiles), and their totals
    if units is None:
        units = kernels.unit_counts(t.row0, t.col0, n).tolist()
    assert (t.staged, t.sparse) == t_pat._unit_totals(units)
    for b in range(B):
        bnd = t.bnd[b].long()
        assert int(bnd[0]) == 0 and int(bnd[-1]) == N
        cnt = bnd[1:] - bnd[:-1]
        assert bool((cnt >= 0).all())
        row0, col0 = t.row0[b].long(), t.col0[b].long()
        assert bool((row0[1:] >= row0[:-1]).all())
        assert bool((row0[cnt == 0] == n).all())
        assert bool((col0[cnt == 0] == -1).all())
        for cap, kind in ((emax, col0 >= 0), (emax_l2, col0 < 0)):
            if cap is not None and bool(kind.any()):
                assert int(cnt[kind].max()) <= cap
        assert bool((row0[cnt > 0] % t.rows == 0).all())
        live = row0 < n
        assert int((live & (col0 >= 0)).sum()) == units[b][0]
        assert int((live & (col0 < 0)).sum()) == units[b][1]
        r, c, s, u = _decode(t, b)
        assert bool((r >= row0[u]).all() and (r < row0[u] + t.rows).all())
        st = col0[u] >= 0
        assert bool((c[st] >= col0[u][st]).all()
                    and (c[st] < col0[u][st] + t.cols).all())
        assert bool((col0[cnt > 0][col0[cnt > 0] >= 0] % t.cols == 0).all())
        # every entry exactly once
        got = sorted(zip(r.tolist(), c.tolist(), s.tolist()))
        want = sorted(zip(np.asarray(rows[b]).tolist(),
                          np.asarray(cols[b]).tolist(),
                          np.asarray(slots[b]).tolist()))
        assert got == want
        if row_runs:
            same = u[1:] == u[:-1]
            assert bool((r[1:][same] >= r[:-1][same]).all())
        if t.strip is None:  # K6's: no strip or row pointers
            assert t.rowptr is None
            continue
        # each strip's units
        strip = t.strip[b].long()
        assert strip.numel() == -(-n // t.rows) + 1
        assert int(strip[0]) == 0 and int(strip[-1]) == int((cnt > 0).sum())
        own = torch.repeat_interleave(torch.arange(strip.numel() - 1),
                                      strip[1:] - strip[:-1])
        assert bool((row0[:own.numel()] == own * t.rows).all())
        # rowptr: each unit's entries below each local row
        rowptr = t.rowptr[b].long().reshape(-1, t.rows + 1)
        per = torch.bincount(u * t.rows + (r - row0[u]),
                             minlength=rowptr.shape[0] * t.rows)
        assert bool((rowptr[:, 0] == 0).all())
        assert torch.equal(rowptr[:, 1:],
                           per.reshape(-1, t.rows).cumsum(1))


def _dot(a, b):
    return (a * b).sum(-1)


# the off values of K3 (two dots; one dot when V is U) and K3p per entry,
# from the rows I[f], J[f] of each factor f at the entry's row and column
OFF_VALUES = {
    "uvt": lambda I, J: (0.5 * (_dot(I[0], J[1]) + _dot(J[0], I[1])),),
    "uvt_one_dot": lambda I, J: (_dot(I[0], J[0]),),
    "uvt_pair": lambda I, J: (0.5 * (_dot(I[0], J[1]) + _dot(J[0], I[1])),
                              _dot(I[1], J[1])),
}


def _walk_off(t, kind, *F):
    """The off values of K3 or K3p (OFF_VALUES[kind]) over the schedule t
    of the off slots, entry by entry in the kernels' decode order, each
    value written at its entry's slot: a tuple of [B, Ko]."""
    B, Ko = t.slot.shape
    outs = None
    for b in range(B):
        i, j, s, _ = _decode(t, b)
        vals = OFF_VALUES[kind]([f[b, i] for f in F], [f[b, j] for f in F])
        if outs is None:
            outs = tuple(torch.zeros((B, Ko), dtype=F[0].dtype)
                         for _ in vals)
        for o, v in zip(outs, vals):
            o[b, s] = v
    return outs


def _walk_adj(t, X, F, a2):
    return a2 * _walk_off(t, "uvt", X, F)[0]


def _walk_wmul(t, X, W_d, W_o):
    out = W_d[:, :, None] * X
    for b in range(X.shape[0]):
        i, j, s, _ = _decode(t, b)
        w = torch.where(s >= 0, W_o[b, s.clamp(min=0)], 0.0)
        out[b].index_add_(0, i, w[:, None] * X[b, j])
    return out


def _close(got, ref, l1):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-11,
                               atol=4 * F64_PREFIX * float(l1.sum())
                               + 1e-300)


@pytest.mark.parametrize("name", ["matcomp500", "hand_multiblock",
                                  "merged_b2"])
def test_schedule_invariants(name):
    for _, tbk, _ in _buckets(name):
        # the bucket's blocks and each block as bucket_slice gives it
        # (the bucket Gauss-Seidel scan): its own unit counts
        for bk in [tbk] + [t_pat.bucket_slice(tbk, b) for b in range(tbk.B)]:
            Ko = bk.Ko
            # the schedules are made once a bucket, K6's with no strips
            assert bk.off_tiles is bk.off_tiles
            assert bk.off_tiles.strip is None
            assert not hasattr(bk, "off_tile_strip")
            _check_schedule(bk.off_tiles, bk.off_rows, bk.off_cols,
                            torch.arange(Ko).expand(bk.B, Ko), bk.n,
                            kernels.ADJ_EMAX, kernels.ADJ_EMAX_L2,
                            units=bk.off_tile_units)
            _check_schedule(bk.sym_tiles, bk.sym_rows_rs,
                            bk.sym_cols_rs, bk.sym_slot_rs, bk.n,
                            row_runs=True, units=bk.sym_tile_units)


def _skewed_buckets():
    """The skewed pattern as (the fields lorads_tpu's uvt, uvt_pair and
    gather_cache read, the port's fields with its schedules, None)."""
    n, off_rows, off_cols, port = _skewed()
    jbk = types.SimpleNamespace(
        B=2, rowshard=False, summed=False, mesh=None, dense=False,
        split=True, has_off=True, off_rows=jnp.asarray(off_rows),
        off_cols=jnp.asarray(off_cols), off_rows_cp=jnp.asarray(off_rows))
    tbk = types.SimpleNamespace(
        B=2, n=n, Ko=off_rows.shape[1], off_tiles=_tiles(port, "off"),
        off_rows=torch.as_tensor(off_rows, dtype=torch.int32),
        off_cols=torch.as_tensor(off_cols, dtype=torch.int32))
    return [(jbk, tbk, None)]


def _check_off_walks(jbk, tbk, rng, r):
    """K3 (U != V and U is V) and K3p walked over the off schedule
    against lorads_tpu's uvt, uvt_from_cache and uvt_pair (and against
    the plain versions)."""
    B, n = tbk.B, tbk.n
    U, V = (rng.standard_normal((B, n, r)) for _ in range(2))
    Uj, Vj = jnp.asarray(U), jnp.asarray(V)
    Ut, Vt = torch.as_tensor(U), torch.as_tensor(V)
    a = (tbk.off_rows, tbk.off_cols)
    t = tbk.off_tiles
    # K3, U != V
    got, = _walk_off(t, "uvt", Ut, Vt)
    l1, = _walk_off(t, "uvt", Ut.abs(), Vt.abs())
    _close(got, tpu_pat.uvt(jbk, Uj, Vj)[1], l1)
    _close(got, kernels.uvt_split_plain(Ut, Vt, *a)[1], l1)
    # K3, U is V: lorads_tpu's one-dot form from its gathered rows
    got, = _walk_off(t, "uvt_one_dot", Ut)
    l1, = _walk_off(t, "uvt_one_dot", Ut.abs())
    _close(got, tpu_pat.uvt_from_cache(jbk, Uj,
                                       tpu_pat.gather_cache(jbk, Uj))[1], l1)
    _close(got, tpu_pat.uvt(jbk, Uj, Uj)[1], l1)
    _close(got, kernels.uvt_split_plain(Ut, Ut, *a)[1], l1)
    # K3p: (sym(R D^T), D D^T) off values
    got = _walk_off(t, "uvt_pair", Ut, Vt)
    l1 = _walk_off(t, "uvt_pair", Ut.abs(), Vt.abs())
    (_, rd_o), (_, dd_o) = tpu_pat.uvt_pair(jbk, Uj, Vj)
    plain = kernels.uvt_pair_split_plain(Ut, Vt, *a)
    for g, ref, p, e in zip(got, (rd_o, dd_o), plain[1::2], l1):
        _close(g, ref, e)
        _close(g, p, e)


@pytest.mark.parametrize("name", ["matcomp500", "hand_multiblock",
                                  "merged_b2", "skewed"])
def test_schedule_walks_match_lorads_tpu(name):
    rng = np.random.default_rng(11)
    buckets = _skewed_buckets() if name == "skewed" else _buckets(name)
    for jbk, tbk, bp in buckets:
        r = 5 if bp is None else max(bp.rank, 2)
        _check_off_walks(jbk, tbk, rng, r)
        if bp is None:  # the skewed pattern: K6 and K5 in test_skewed_schedule
            continue
        B, n, Ko = tbk.B, tbk.n, tbk.Ko
        X, F = (rng.standard_normal((B, n, r)) for _ in range(2))
        Xj, Fj = jnp.asarray(X), jnp.asarray(F)
        Xt, Ft = torch.as_tensor(X), torch.as_tensor(F)
        # K6: a2 .* sym(X F^T) on the off slots
        got = _walk_adj(tbk.off_tiles, Xt, Ft, tbk.a2_off)
        ref = tpu_pat.a_adj_a(jbk, tpu_pat.uvt(jbk, Xj, Fj))[1]
        l1 = _walk_adj(tbk.off_tiles, Xt.abs(), Ft.abs(),
                       tbk.a2_off.abs())
        _close(got, ref, l1)
        np.testing.assert_allclose(
            got, kernels.adj_a_offdiag_plain(Xt, Ft, tbk.off_rows,
                                              tbk.off_cols, tbk.a2_off,
                                              False)[1], rtol=1e-12,
            atol=1e-13 * float(l1.max()))
        # K5: W @ X
        # W as lorads_tpu's build_w gives it: (W_d, W_o, the
        # column-order mirror of W_o), 0 at the padding slots
        W_d, W_o = rng.standard_normal((B, n)), rng.standard_normal((B, Ko))
        W_o[np.asarray(tbk.off_rows == tbk.off_cols)] = 0.0
        jW = (jnp.asarray(W_d), jnp.asarray(W_o), jnp.asarray(
            np.take_along_axis(W_o, np.asarray(jbk.off_col_perm), 1)))
        W_d, W_o = torch.as_tensor(W_d), torch.as_tensor(W_o)
        got = _walk_wmul(tbk.sym_tiles, Xt, W_d, W_o)
        ref = tpu_pat.w_mul(jbk, jW, Xj)
        l1 = _walk_wmul(tbk.sym_tiles, Xt.abs(), W_d.abs(),
                        W_o.abs())
        _close(got, ref, l1)


def test_skewed_schedule():
    """A hub row, empty tiles, a padding-only tile, B = 2: the
    invariants, the units' split at emax and the walks against the
    plain versions."""
    n, off_rows, off_cols, port = _skewed()
    Ko = off_rows.shape[1]
    adj = _tiles(port, "off")
    wm = _tiles(port, "sym")
    _check_schedule(adj, off_rows, off_cols,
                    np.broadcast_to(np.arange(Ko), (2, Ko)), n,
                    kernels.ADJ_EMAX, kernels.ADJ_EMAX_L2)
    _check_schedule(wm, port["sym_rows_rs"], port["sym_cols_rs"],
                    port["sym_slot_rs"], n, row_runs=True)
    # block 0 holds staged units (the hub strip's) and an L2 unit (a
    # band strip's sparse tiles); block 1's tile (0, 0) holds only its
    # padding slots
    col0 = adj.col0[0][adj.row0[0] < n]
    assert bool((col0 >= 0).any()) and bool((col0 == -1).any())
    i, j, s, u = _decode(adj, 1)
    pad = np.asarray(off_rows[1]) == np.asarray(off_cols[1])
    assert set(s[(i == 0) & (j == 0)].tolist()) == set(
        np.nonzero(pad)[0].tolist())
    # units split at emax and emax_l2
    small = kernels.tile_schedule(
        torch.as_tensor(off_rows), torch.as_tensor(off_cols),
        torch.arange(Ko).expand(2, Ko), n, kernels.ADJ_TILE,
        kernels.ADJ_TILE, kernels.ADJ_MIN_FILL, emax=7, emax_l2=2)
    _check_schedule(small, off_rows, off_cols,
                    np.broadcast_to(np.arange(Ko), (2, Ko)), n, 7, 2)
    # one hub strip of K5: the hub row's mirror entries fill every strip
    assert int((wm.row0[0] < n).sum()) > n // kernels.WMUL_STRIP
    rng = np.random.default_rng(12)
    X, F = (torch.as_tensor(rng.standard_normal((2, n, 5)))
            for _ in range(2))
    a2 = torch.as_tensor(rng.random((2, Ko)) * (~np.stack(
        [off_rows[b] == off_cols[b] for b in range(2)])))
    rows_t, cols_t = (torch.as_tensor(a, dtype=torch.int32)
                      for a in (off_rows, off_cols))
    ref = kernels.adj_a_offdiag_plain(X, F, rows_t, cols_t, a2, False)[1]
    torch.testing.assert_close(_walk_adj(adj, X, F, a2), ref, rtol=1e-12,
                               atol=1e-12)
    W_d, W_o = (torch.as_tensor(rng.standard_normal(s_))
                for s_ in ((2, n), (2, Ko)))
    args = tuple(torch.as_tensor(port[k], dtype=torch.int32) for k in (
        "sym_slot_rs", "sym_cols_rs", "bnd_sym_rows"))
    ref = kernels.wmul_csr_plain(X, W_d, W_o, *args)
    torch.testing.assert_close(_walk_wmul(wm, X, W_d, W_o), ref,
                               rtol=1e-12, atol=1e-12)
    # the wrappers' own build (a call without tiles) gives the same
    # schedule as the bucket build
    again = kernels.wmul_tiles(*args)
    for f in range(5):
        assert torch.equal(again[f], wm[f])
    again = kernels.adj_tiles(rows_t, cols_t, n)
    for f in range(5):
        assert torch.equal(again[f], adj[f])
