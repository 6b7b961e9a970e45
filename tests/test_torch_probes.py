"""lorads_torch.probes vs the Pallas probes of tools/probes/ on the CPU.

The reference one-hot kernels (tools/probes/onehot.py) are loaded under a
private module name from their file, and run in Pallas interpret mode;
the gathers and scatters are held to ``jnp.take`` and
``jax.ops.segment_sum`` on each probe's inputs, drawn from
``default_rng(0)`` as the probes draw them but at small sizes.  The port
runs on CPU tensors, where every wrapper takes its plain version.

Tolerances: plans field for field; gathers exactly; sums within
4 eps32 * sum |values| of each output (both sides split the values into
the same round-to-nearest-even bf16 planes, so only the summation order
differs); K3's f32 row dots of 24 terms within 4 eps32 * sum |terms|.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_torch.ops import kernels
from lorads_torch.probes import gather
from lorads_torch.probes import onehot as oh
from lorads_torch.probes.__main__ import SECTIONS
from lorads_torch.probes.__main__ import main as probes_main

EPS32 = float(np.finfo(np.float32).eps)
PROBES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "probes")


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "_lorads_probe_onehot_ref", os.path.join(PROBES, "onehot.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()

# the id sets of tools/probes/test_onehot.py (scatter: seed 3, gather:
# seed 5, the same (K, n, r) shapes)
SHAPES = [(5000, 1000, 20), (3000, 517, 7), (64, 2000, 3)]


def _ids_vals(seed, kind):
    """The reference tests' draws: per shape, sorted ids then values."""
    rng = np.random.default_rng(seed)
    out = []
    for K, n, r in SHAPES:
        ids = np.sort(rng.integers(0, n, K)).astype(np.int32)
        v = (rng.standard_normal((K, r)) if kind == "scatter"
             else rng.standard_normal((n, r))).astype(np.float32)
        out.append((ids, n, v))
    return out


def _plan_fields_equal(mine, ref):
    for f in ("ok", "kind", "n", "K", "CT", "WT", "n_pad", "K_pad"):
        assert getattr(mine, f) == getattr(ref, f), f
    if ref.ok:
        np.testing.assert_array_equal(mine.wblock.numpy(),
                                      np.asarray(ref.wblock))
        np.testing.assert_array_equal(mine.ids_pad.numpy(),
                                      np.asarray(ref.ids_pad))
    else:
        assert mine.wblock is None and mine.ids_pad is None


@pytest.mark.parametrize("i", range(len(SHAPES)))
@pytest.mark.parametrize("kind", ["scatter", "gather"])
def test_plans_match_reference(i, kind):
    ids, n, _ = _ids_vals(3 if kind == "scatter" else 5, kind)[i]
    if kind == "scatter":
        for CT, WT in ((256, 0), (128, 1024), (16, 512)):
            _plan_fields_equal(
                oh.plan_sorted_scatter(ids, n, CT=CT, WT=WT, device="cpu"),
                REF.plan_sorted_scatter(ids, n, CT=CT, WT=WT))
    else:
        for KT in (256, 128, 16):
            _plan_fields_equal(
                oh.plan_sorted_gather(ids, n, KT=KT, device="cpu"),
                REF.plan_sorted_gather(ids, n, KT=KT))


def test_plans_refuse_as_the_reference():
    """A segment wider than any window cap, and unsorted ids."""
    rng = np.random.default_rng(4)
    ids = np.sort(np.concatenate([np.zeros(20000, np.int64),
                                  rng.integers(0, 300, 500)]))
    mine = oh.plan_sorted_scatter(ids, 300, WT=2048, device="cpu")
    assert not mine.ok
    _plan_fields_equal(mine, REF.plan_sorted_scatter(ids, 300, WT=2048))
    for plan in (oh.plan_sorted_gather, oh.plan_sorted_scatter):
        mine = plan(np.array([5, 3, 1]), 10, device="cpu")
        assert not mine.ok
    _plan_fields_equal(oh.plan_sorted_gather(np.array([5, 3, 1]), 10,
                                             device="cpu"),
                       REF.plan_sorted_gather(np.array([5, 3, 1]), 10))
    # an id past the table
    assert not oh.plan_sorted_gather(np.array([1, 12]), 10,
                                     device="cpu").ok


def test_planes_round_to_nearest_even_as_jax():
    v = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    v[:4] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
             3.0 * 2.0 ** -130]                  # ties and a subnormal
    for mode in ("bf16x3", "bf16x2"):
        mine = oh.planes(torch.as_tensor(v), mode)
        ref = REF._planes(jnp.asarray(v), mode)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    hi, mid, lo = oh.planes(torch.as_tensor(v), "bf16x3")
    assert torch.equal((hi.float() + mid.float()) + lo.float(),
                       torch.as_tensor(v))


@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16x2"])
def test_sorted_scatter_matches_reference(mode):
    for ids, n, v in _ids_vals(3, "scatter"):
        ref = np.asarray(REF.sorted_scatter(
            jnp.asarray(v), REF.plan_sorted_scatter(ids, n), mode=mode,
            interpret=True))
        plan = oh.plan_sorted_scatter(ids, n, device="cpu")
        got = oh.sorted_scatter(torch.as_tensor(v), plan, mode)
        l1 = np.zeros((n, v.shape[1]))
        np.add.at(l1, ids, np.abs(v).astype(np.float64))
        assert got.shape == ref.shape
        assert np.all(np.abs(got.numpy().astype(np.float64) - ref)
                      <= 4 * EPS32 * l1 + 1e-30), mode


@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16x2"])
def test_sorted_gather_matches_reference(mode):
    for ids, n, X in _ids_vals(5, "gather"):
        ref = np.asarray(REF.sorted_gather(
            jnp.asarray(X), REF.plan_sorted_gather(ids, n), mode=mode,
            interpret=True))
        plan = oh.plan_sorted_gather(ids, n, device="cpu")
        got = oh.sorted_gather(torch.as_tensor(X), plan, mode).numpy()
        np.testing.assert_array_equal(got, ref)
        if mode != "bf16x2":
            np.testing.assert_array_equal(got, X[ids])


@pytest.mark.parametrize("mode", ["f32", "bf16x3", "bf16x2"])
def test_scatter_rk_layout_matches_kr(mode):
    for ids, n, v in _ids_vals(3, "scatter"):
        plan = oh.plan_sorted_scatter(ids, n, device="cpu")
        vt = torch.as_tensor(v)
        kr = oh.sorted_scatter(vt, plan, mode, "kr")
        rk = oh.sorted_scatter(vt.T.contiguous(), plan, mode, "rk")
        assert rk.shape == (v.shape[1], n)
        assert torch.equal(rk.T, kr)


def test_wrappers_refuse_bad_arguments():
    ids, n, v = _ids_vals(3, "scatter")[0]
    plan = oh.plan_sorted_scatter(ids, n, device="cpu")
    with pytest.raises(ValueError):
        oh.sorted_scatter(torch.as_tensor(v), plan, "bf16x4")
    with pytest.raises(ValueError):
        oh.sorted_scatter(torch.as_tensor(v), plan, layout="kk")
    with pytest.raises(ValueError):
        oh.sorted_gather(torch.zeros((n, 3)), plan)   # a scatter plan
    with pytest.raises(TypeError):
        oh.sorted_scatter(torch.as_tensor(v).double(), plan)
    with pytest.raises(IndexError):
        gather.row_gather(torch.zeros(5), torch.tensor([0, 5],
                                                       dtype=torch.int32))
    with pytest.raises(IndexError):
        gather.scatter_add(torch.zeros(2), torch.tensor([-1, 0],
                                                        dtype=torch.int32),
                           4)


def test_flop_counts_follow_the_kernels_chunks():
    """One mma (2*16*16*8 flops) per 16-row chunk, 8 columns and plane."""
    ids = np.array([0, 0, 1, 17, 17, 17, 40], np.int32)
    plan = oh.plan_sorted_scatter(ids, 50, CT=16, device="cpu")
    # sub-tiles [0,16): 3 rows, [16,32): 3 rows, [32,48): 1 row
    assert oh.scatter_mma_flops(plan, 20, "bf16x3") == 3 * 4096 * 3 * 3
    gplan = oh.plan_sorted_gather(ids, 50, KT=16, device="cpu")
    # one 16-id sub-tile spanning rows 0..40: 3 chunks
    assert oh.gather_mma_flops(gplan, 8, "bf16x2") == 3 * 4096 * 1 * 2


# ---------------------------------------------------------------------------
# P3 / P4 against jnp.take and jax.ops.segment_sum on the probes' inputs.
# ---------------------------------------------------------------------------

def _probe_inputs(probe):
    """(table, ids) as the probe draws them from default_rng(0), scaled
    to n <= 2000, K <= 8000."""
    rng = np.random.default_rng(0)
    if probe == "pallas_gather":                  # gA-gD: n, K, r
        X = rng.standard_normal((2000, 20)).astype(np.float32)
        return X, rng.integers(0, 2000, 8000).astype(np.int32), "kr"
    if probe == "pallas_gather_gE":               # a [K] vector by n ids
        rng.standard_normal((2000, 20))
        rng.integers(0, 2000, 8000)
        vec = rng.standard_normal(8000).astype(np.float32)
        return vec, rng.integers(0, 8000, 2000).astype(np.int32), "kr"
    if probe.startswith("pallas_gather2"):         # heights, K=8000, r=20
        n = int(probe.split("_")[-1])
        rng = np.random.default_rng(0)
        X = rng.standard_normal((n, 20)).astype(np.float32)
        return X, rng.integers(0, n, 8000).astype(np.int32), "kr"
    if probe == "pallas_gather3_gT":              # [R, n] by K ids
        X = rng.standard_normal((24, 2000)).astype(np.float32)
        return X, rng.integers(0, 2000, 8000).astype(np.int32), "rk"
    # gather9 fA/fB: unsorted ids first, then the table
    ids = rng.integers(0, 2000, 8000).astype(np.int32)
    return rng.standard_normal((2000, 24)).astype(np.float32), ids, "kr"


@pytest.mark.parametrize("probe", [
    "pallas_gather", "pallas_gather_gE", "pallas_gather2_8",
    "pallas_gather2_1024", "pallas_gather2_2000", "pallas_gather3_gT",
    "gather9"])
def test_row_gather_matches_jnp_take(probe):
    X, ids, layout = _probe_inputs(probe)
    axis = 1 if layout == "rk" else 0
    ref = np.asarray(jnp.take(jnp.asarray(X), jnp.asarray(ids), axis=axis))
    got = gather.row_gather(torch.as_tensor(X), torch.as_tensor(ids),
                            layout).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("r", [24, 1])
def test_scatter_add_matches_segment_sum(r):
    """gather9 fC's unsorted segment sum (n=2000, K=8000)."""
    rng = np.random.default_rng(0)
    n, K = 2000, 8000
    ids = rng.integers(0, n, K).astype(np.int32)
    rng.standard_normal((n, r))
    vals = rng.standard_normal((K, r) if r > 1 else (K,)).astype(np.float32)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                         num_segments=n))
    got = gather.scatter_add(torch.as_tensor(vals), torch.as_tensor(ids),
                             n).numpy()
    l1 = np.zeros((n,) + vals.shape[1:])
    np.add.at(l1, ids, np.abs(vals).astype(np.float64))
    assert got.shape == ref.shape
    assert np.all(np.abs(got.astype(np.float64) - ref)
                  <= 4 * EPS32 * l1 + 1e-30)


def test_uvt_split_on_transposed_factors_matches_probe():
    """K3 (plain version) on X^T, D^T against pallas_gather3's ref_uv
    (:121-123), at n=2000, K=8000, R=24."""
    rng = np.random.default_rng(0)
    n, K, R = 2000, 8000, 24
    Xt = rng.standard_normal((R, n)).astype(np.float32)
    idx = rng.integers(0, n, K).astype(np.int32)
    idx_r = np.sort(rng.integers(0, n, K)).astype(np.int32)
    Dt = Xt * np.float32(0.5) + np.float32(1.0)
    jX, jD, ji, jr = map(jnp.asarray, (Xt, Dt, idx, idx_r))
    ref_uv = np.asarray(0.5 * (
        jnp.sum(jnp.take(jX, jr, 1) * jnp.take(jD, ji, 1), 0)
        + jnp.sum(jnp.take(jX, ji, 1) * jnp.take(jD, jr, 1), 0)))
    U = torch.as_tensor(Xt.T.copy())[None]
    V = torch.as_tensor(Dt.T.copy())[None]
    rows = torch.as_tensor(idx_r)[None]
    cols = torch.as_tensor(idx)[None]
    _, o = kernels.uvt_split(U, V, rows, cols)
    _, l1 = kernels.uvt_split_plain(U.abs(), V.abs(), rows, cols)
    assert o.shape == (1, K)
    assert np.all(np.abs(o[0].numpy().astype(np.float64) - ref_uv)
                  <= 4 * EPS32 * l1[0].numpy() + 1e-30)


def test_driver_runs_every_section_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert probes_main(["--device", "cpu", "--small"]) == 0
    lines = out.getvalue().splitlines()
    for name in SECTIONS:
        assert f"--- {name}" in lines
    rows = json.loads(lines[-1])["probes"]
    assert {r["section"] for r in rows} == set(SECTIONS)
    for r in rows:
        assert r["ms"] is None and r["library_ms"] is None   # not measured
        assert r["bound_ms"] > 0 and r["max_abs_err"] >= 0
    cases = {r["case"] for r in rows}
    assert any(c.startswith("P1 ") and "[r,K]" in c for c in cases)
    assert any(c.startswith("P2 ") for c in cases)
    assert any(c.startswith("P4 ") for c in cases)
    assert any(c.startswith("K1 ") for c in cases)


def test_driver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert probes_main(["--small", "--only", "uvt"]) == 2
    assert "no CUDA device" in err.getvalue()
