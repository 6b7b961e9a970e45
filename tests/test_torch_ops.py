"""lorads_torch ops vs lorads_tpu: kernels' plain versions, BucketData,
the copied host modules, precision pins.

Both packages get the same numpy inputs; lorads_tpu runs on CPU at f64
(conftest) and the port on CPU tensors, where every kernel wrapper takes
its plain PyTorch version.  Tolerances:

* f64 sums: rtol 1e-11 plus 2^-48 * sum|terms| of the whole input, the
  error contract of lorads_tpu's compensated prefix scan
  (lorads_tpu/ops/pattern.py:138-170, comp_segment_sum);
* f32 sums: 4 * eps32 * sum|terms| of each segment.

The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.config import SolverStatus as TpuStatus
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_tpu.ops import pattern as tpu_pat
from lorads_torch import config as t_config
from lorads_torch import interop
from lorads_torch.core import presolve as t_presolve
from lorads_torch.io import generators as t_gen
from lorads_torch.io import sdpa as t_sdpa
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as t_pat

FIX = "tests/fixtures/"
EPS32 = float(np.finfo(np.float32).eps)
F64_PREFIX = 2.0 ** -48


def _maxcut_instance(name):
    if name == "maxcut300":
        return tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    return tpu_sdpa.read_sdpa(FIX + "maxcut2000.dat-s")


@functools.lru_cache(maxsize=None)
def _buckets(name, dtype=np.float64):
    """(lorads_tpu bucket, port bucket, presolved plan) for an instance."""
    problem = _maxcut_instance(name)
    ps = tpu_presolve.presolve(problem, TpuParams())
    bp = ps.buckets[0]
    jbk = tpu_pat.build_bucket_data(bp, problem.m, jnp.dtype(dtype))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tbk = t_pat.build_bucket_data(bp, problem.m, tdt, "cpu")
    return jbk, tbk, bp


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x)).to(dtype)


# ---------------------------------------------------------------------------
# K1: sorted segment sum.
# ---------------------------------------------------------------------------

def _segment_case(kind, rng):
    """(data [B, N(, r)], bounds [B, S+1]) for one edge case."""
    P = tpu_pat._PAIR_CHUNK
    if kind == "empty_segments":
        B, N, S = 2, 300, 120           # many segments hold no entry
        ids = np.sort(rng.integers(0, S, (B, N)) // 7 * 7, axis=1)
    elif kind == "padded_blocks":
        B, N, S = 3, 500, 40            # blocks end early (pad ids = S)
        ids = np.sort(rng.integers(0, S, (B, N)), axis=1)
        ids[1, 300:] = S
        ids[2, 17:] = S
    elif kind == "chunk_edges":
        B, N, S = 2, 3 * P + 7, 9       # segments straddle chunk edges
        ids = np.sort(rng.integers(0, S, (B, N)), axis=1)
    else:                               # "long": prefixes >> segments
        B, N, S = 2, 12_000, 60
        ids = np.sort(rng.integers(0, S, (B, N)), axis=1)
    return ids.astype(np.int32), tpu_pat._bounds_np(ids, S)


@pytest.mark.parametrize("kind", ["empty_segments", "padded_blocks",
                                  "chunk_edges", "long"])
@pytest.mark.parametrize("r", [None, 3])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_segment_sum_matches_comp_segment_sum(kind, r, dtype):
    rng = np.random.default_rng(11)
    ids, bounds = _segment_case(kind, rng)
    B, N = ids.shape
    shape = (B, N) if r is None else (B, N, r)
    data = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)
    bnd = np.array(bounds)
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    ref = np.asarray(tpu_pat.comp_segment_sum(jnp.asarray(data, jdt),
                                              bounds), np.float64)
    got = t_pat.comp_segment_sum(_t(data, tdt),
                                 torch.as_tensor(bnd)).double().numpy()
    assert got.shape == ref.shape
    # |terms| per segment (exact) and over the whole input
    l1 = kernels.segment_sum_plain(_t(np.abs(data)),
                                   torch.as_tensor(bnd)).numpy()
    if dtype == "f64":
        atol = F64_PREFIX * np.abs(data).sum()
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=atol)
    else:
        assert np.all(np.abs(got - ref) <= 4 * EPS32 * l1 + 1e-30)
    # and against the exact segment sums
    exact = np.zeros((B, bnd.shape[1] - 1) + shape[2:])
    for b in range(B):
        for j in range(bnd.shape[1] - 1):
            exact[b, j] = data[b, bnd[b, j]:bnd[b, j + 1]].sum(axis=0)
    tol = (1e-13 if dtype == "f64" else 2 * EPS32) * l1
    assert np.all(np.abs(got - exact) <= tol + 1e-30)


@pytest.mark.parametrize("r", [None, 4])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_single_segment_sum_matches(r, dtype):
    rng = np.random.default_rng(0)
    B, S = 3, 40
    ids = np.stack([np.sort(rng.choice(S, size=17, replace=False))
                    for _ in range(B)])
    bounds = np.stack([np.searchsorted(ids[b], np.arange(S + 1))
                       for b in range(B)]).astype(np.int32)
    data = rng.standard_normal((B, 17) if r is None else (B, 17, r))
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    ref = np.asarray(tpu_pat.single_segment_sum(jnp.asarray(data, jdt),
                                                jnp.asarray(bounds)))
    got = t_pat.single_segment_sum(_t(data, tdt),
                                   torch.as_tensor(bounds)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_segment_sum_wrapper_checks_inputs():
    d = torch.zeros((1, 4))
    with pytest.raises(TypeError):
        kernels.segment_sum(d, torch.zeros((1, 3), dtype=torch.int64))
    with pytest.raises(TypeError):
        kernels.segment_sum(d.to(torch.int32),
                            torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.segment_sum(torch.zeros((1, 4, 2)).transpose(1, 2),
                            torch.zeros((1, 3), dtype=torch.int32))


# ---------------------------------------------------------------------------
# K2: cmul, K3: uvt.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["maxcut300", "maxcut2000"])
@pytest.mark.parametrize("r", ["1", "rank"])
@pytest.mark.parametrize("include_diag", [True, False])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cmul_matches(name, r, include_diag, dtype):
    npdt = np.float64 if dtype == "f64" else np.float32
    jbk, tbk, bp = _buckets(name, npdt)
    rr = 1 if r == "1" else bp.rank
    rng = np.random.default_rng(5)
    X = rng.standard_normal((1, bp.n, rr))
    tdt = torch.float64 if dtype == "f64" else torch.float32
    ref = np.asarray(tpu_pat.cmul(jbk, jnp.asarray(X, jbk.c_diag.dtype),
                                  include_diag=include_diag), np.float64)
    got = t_pat.cmul(tbk, _t(X, tdt),
                     include_diag=include_diag).double().numpy()
    # sum |terms| per output row
    absb = dataclasses.replace(
        tbk, c_diag=tbk.c_diag.abs().double(),
        c_sym_rs=tbk.c_sym_rs.abs().double())
    l1 = t_pat.cmul(absb, _t(np.abs(X)), include_diag=include_diag).numpy()
    if dtype == "f64":
        np.testing.assert_allclose(got, ref, rtol=1e-11,
                                   atol=F64_PREFIX * l1.sum())
    else:
        assert np.all(np.abs(got - ref) <= 4 * EPS32 * l1 + 1e-30)


@pytest.mark.parametrize("name", ["maxcut300", "maxcut2000"])
def test_uvt_split_matches(name):
    jbk, tbk, bp = _buckets(name)
    rng = np.random.default_rng(2)
    U = rng.standard_normal((1, bp.n, bp.rank))
    V = rng.standard_normal((1, bp.n, bp.rank))
    rd, ro = tpu_pat.uvt(jbk, jnp.asarray(U), jnp.asarray(V))
    gd, go = t_pat.uvt(tbk, _t(U), _t(V))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(go.numpy(), np.asarray(ro), rtol=1e-11,
                               atol=1e-13)


@pytest.mark.parametrize("name", ["maxcut300", "maxcut2000"])
def test_diag_ident_ops_match(name):
    """constr_vals, obj_inner, scatter_constr, gather_w, build_w and
    densify_w of the diag-identity bucket."""
    jbk, tbk, bp = _buckets(name)
    rng = np.random.default_rng(3)
    U = rng.standard_normal((1, bp.n, 6))
    V = rng.standard_normal((1, bp.n, 6))
    w = rng.standard_normal(bp.m_loc)
    juv = tpu_pat.uvt(jbk, jnp.asarray(U), jnp.asarray(V))
    tuv = t_pat.uvt(tbk, _t(U), _t(V))
    jv = tpu_pat.constr_vals(jbk, juv)
    tv = t_pat.constr_vals(tbk, tuv)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12)
    np.testing.assert_allclose(t_pat.obj_inner(tbk, tuv).numpy(),
                               np.asarray(tpu_pat.obj_inner(jbk, juv)),
                               rtol=1e-11)
    np.testing.assert_array_equal(
        t_pat.scatter_constr(tbk, tv).numpy(),
        np.asarray(tpu_pat.scatter_constr(jbk, jnp.asarray(tv.numpy()))))
    jw = tpu_pat.gather_w(jbk, jnp.asarray(w))
    tw = t_pat.gather_w(tbk, _t(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for include_obj in (True, False):
        jW = tpu_pat.build_w(jbk, jw, include_obj=include_obj)
        tW = t_pat.build_w(tbk, tw, include_obj=include_obj)
        np.testing.assert_array_equal(tW[0].numpy(), np.asarray(jW[0]))
        np.testing.assert_array_equal(tW[1].numpy(), np.asarray(jW[1]))
    if bp.n <= 1024:
        jD = tpu_pat.densify_w(jbk, tpu_pat.build_w(jbk, jw))
        tD = t_pat.densify_w(tbk, t_pat.build_w(tbk, tw))
        np.testing.assert_array_equal(tD.numpy(), np.asarray(jD))


# ---------------------------------------------------------------------------
# BucketData and the copied host modules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["maxcut300", "maxcut2000"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bucket_data_fields_equal(name, dtype):
    jbk, tbk, bp = _buckets(name, dtype)
    # diag-identity buckets share the full-symmetric entry list too
    for f in t_pat.INT_FIELDS + t_pat.SYM_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tbk, f).numpy(),
                                      np.asarray(getattr(jbk, f)))
        assert getattr(tbk, f).dtype == torch.int32
    for f in t_pat.FLOAT_FIELDS + t_pat.SYM_FLOAT_FIELDS:
        a = getattr(tbk, f).numpy()
        b = np.asarray(getattr(jbk, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for f in t_pat.META_FIELDS + ("split", "dense"):
        assert getattr(tbk, f) == getattr(jbk, f), f
    assert tbk.diag_ident
    # interop builds the same bucket from lorads_tpu's arrays
    ibk = interop.bucket_from_numpy(jbk, dtype=tbk.dtype)
    for f in t_pat.ALL_INT_FIELDS + t_pat.ALL_FLOAT_FIELDS:
        assert torch.equal(getattr(ibk, f), getattr(tbk, f)), f


def _assert_same_problem(a, b):
    assert a.m == b.m
    np.testing.assert_array_equal(a.rhs, b.rhs)
    assert len(a.blocks) == len(b.blocks)
    for x, y in zip(a.blocks, b.blocks):
        for f in dataclasses.fields(x):
            np.testing.assert_array_equal(getattr(x, f.name),
                                          getattr(y, f.name))
    assert (a.lp is None) == (b.lp is None)
    if a.lp is not None:
        for f in dataclasses.fields(a.lp):
            np.testing.assert_array_equal(getattr(a.lp, f.name),
                                          getattr(b.lp, f.name))


@pytest.mark.parametrize("fixture", ["maxcut2000.dat-s", "mc_gtoy60.dat-s",
                                     "hand_multiblock.dat-s",
                                     "theta_gtoy60.dat-s"])
def test_sdpa_reader_copy(fixture):
    _assert_same_problem(t_sdpa.read_sdpa(FIX + fixture),
                         tpu_sdpa.read_sdpa(FIX + fixture))
    _assert_same_problem(t_sdpa.read_sdpa(FIX + fixture),
                         tpu_sdpa.read_sdpa(FIX + fixture, native=False))


def test_generators_copy():
    _assert_same_problem(t_gen.maxcut(n=300, avg_degree=4, seed=3),
                         tpu_gen.maxcut(n=300, avg_degree=4, seed=3))
    _assert_same_problem(t_gen.maxcut(n=20000, avg_degree=8, seed=7),
                         tpu_gen.maxcut(n=20000, avg_degree=8, seed=7))
    _assert_same_problem(t_gen.maxcut_from_graph(FIX + "g_toy60.rudy"),
                         tpu_gen.maxcut_from_graph(FIX + "g_toy60.rudy"))
    for a, b in zip(t_gen.gset_torus(20, 30, seed=67),
                    tpu_gen.gset_torus(20, 30, seed=67)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fixture", ["maxcut2000.dat-s", "mc_gtoy60.dat-s",
                                     "hand_multiblock.dat-s",
                                     "matcomp500.dat-s"])
def test_presolve_copy(fixture):
    problem = tpu_sdpa.read_sdpa(FIX + fixture)
    a = t_presolve.presolve(problem, t_config.LoradsParams())
    b = tpu_presolve.presolve(problem, TpuParams())
    for f in ("m", "rho0", "c_nrm1", "c_nrm2", "c_nrm_inf", "b_nrm1",
              "b_nrm2", "b_nrm_inf"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        for f in dataclasses.fields(x):
            if f.name == "plans":
                continue
            np.testing.assert_array_equal(np.asarray(getattr(x, f.name)),
                                          np.asarray(getattr(y, f.name)))
        for p, q in zip(x.plans, y.plans):
            for f in dataclasses.fields(p):
                np.testing.assert_array_equal(
                    np.asarray(getattr(p, f.name)),
                    np.asarray(getattr(q, f.name)))


def test_params_copy():
    a = {f.name: f.default for f in
         dataclasses.fields(t_config.LoradsParams)}
    b = {f.name: f.default for f in dataclasses.fields(TpuParams)}
    assert a == b
    assert ([s.value for s in t_config.SolverStatus]
            == [s.value for s in TpuStatus])


def test_tf32_off_after_import():
    import lorads_torch
    from lorads_torch import device as tdev

    assert lorads_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    tdev.assert_full_precision()
