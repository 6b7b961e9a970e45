"""Checkpoints and solution files across lorads_tpu and lorads_torch.

A checkpoint (utils/checkpoint.py: one .npz of R/U/V/S per cone and LP
plus the dual, and a .meta.json) written by either package loads in the
other: R, U, V, S and the dual bit for bit, and the meta too (the
reader saves again and the two files are compared).  A ``--solOut`` /
``save_solution`` file written by either package warm-starts the other
(``set_initial_factors``: columns truncated or filled with the scaled
identity), both packages giving the same factors bit for bit, and both
refuse the same bad inputs with the same ValueError.  No solve runs:
the solvers are constructed and their state set by hand.
tests/fixtures/hand_multiblock.dat-s: two dense one-block buckets and
an LP block of 2 columns.  Then the CLI's sequence of tests/test_io.py
(--dualUV --checkpoint --solOut, --resume, --warmStart, a corrupt
warm-start file, --traceDir) with --device cpu, utils.profiling's
torch.profiler trace on the CPU, and its datasheet peaks, which the CPU
has none of.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import alm as tpu_alm
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.alg.state import FactorVec as TpuFV
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import alm as t_alm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.alg.state import FactorVec as TorchFV
from lorads_torch.config import LoradsParams as TorchParams

FIX = "tests/fixtures/"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem():
    return tpu_sdpa.read_sdpa(FIX + "hand_multiblock.dat-s")


def _solver(pkg):
    if pkg == "tpu":
        return TpuSolver(_problem(), TpuParams(verbose=False))
    return TorchSolver(_problem(), TorchParams(verbose=False), device="cpu")


def _fv(pkg, cones, lp):
    if pkg == "tpu":
        return TpuFV(tuple(jnp.asarray(x) for x in cones), jnp.asarray(lp))
    return TorchFV(tuple(torch.tensor(x) for x in cones), torch.tensor(lp))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stats(pkg):
    """ALM and ADMM stats with the same numbers in either package."""
    alm = (tpu_alm if pkg == "tpu" else t_alm).ALMStats(
        rho=7.25, outer_iter=4, inner_iter=11, pobj=0.2, dobj=0.25,
        pinf_l1=4.5e-4, pinf_inf=8.5e-4, gap=9.1e-3, tau=0.0228)
    admm = (tpu_admm if pkg == "tpu" else t_admm).ADMMStats(
        rho=36.5, iter=45, cg_iter=53, pobj=0.21, dobj=0.215,
        pinf_l1=4.3e-6, pinf_inf=7.8e-6, gap=1.7e-3)
    return alm, admm


def _set_state(s, pkg, scale):
    """Random R, U, V, S and dual (seeded), the scalars set."""
    rng = np.random.default_rng(17)
    shapes = [tuple(x.shape) for x in s.R.cones]
    n_lp = s.R.lp.shape[0]
    for name in ("R", "U", "V", "S"):
        setattr(s, name, _fv(pkg, [rng.standard_normal(sh) for sh in shapes],
                             rng.standard_normal(n_lp)))
    dual = rng.standard_normal(s.m)
    s.dual = jnp.asarray(dual) if pkg == "tpu" else torch.tensor(dual)
    s.scale_obj_his = scale
    s.rho_max = 1234.5
    s.pobj, s.dobj, s.gap, s.pinf_l1 = -1.5, -1.25, 3.5e-3, 2.25e-5


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("scale", [1.0, 5.0])
@pytest.mark.parametrize("writer,reader", [("torch", "tpu"),
                                           ("tpu", "torch")])
def test_checkpoint_crosses_packages(writer, reader, scale, tmp_path):
    w = _solver(writer)
    _set_state(w, writer, scale)
    first = str(tmp_path / "first.ckpt")
    w.save(first, *_stats(writer), phase="post_admm")
    written = _arrays(first)
    assert sorted(written) == sorted(
        [f"{p}_cone{i}" for p in "RUVS" for i in range(2)]
        + [f"{p}_lp" for p in "RUVS"] + ["dual"])

    r = _solver(reader)
    pd0 = r.pd
    meta = r.load(first)
    with open(first + ".meta.json") as f:
        assert meta == json.load(f)
    assert meta["phase"] == "post_admm" and meta["version"] == 1
    for p in "RUVS":
        fv = getattr(r, p)
        for i, x in enumerate(fv.cones):
            np.testing.assert_array_equal(_np(x), written[f"{p}_cone{i}"])
        np.testing.assert_array_equal(_np(fv.lp), written[f"{p}_lp"])
    np.testing.assert_array_equal(_np(r.dual), written["dual"])
    assert (r.scale_obj_his, r.rho_max, r.pobj, r.dobj, r.gap,
            r.pinf_l1) == (scale, 1234.5, -1.5, -1.25, 3.5e-3, 2.25e-5)
    # the objective data is rebuilt and rescaled only when scaled
    assert (r.pd is pd0) == (scale == 1.0)
    if reader == "torch" and scale != 1.0:
        ref = t_aop.scale_objective(
            t_aop.build_problem_data(r.ps, torch.float64, "cpu"), scale)
        assert float(t_aop.obj_only(r.pd, r.R, r.R)) == float(
            t_aop.obj_only(ref, r.R, r.R))

    # the reader writes the same file back: arrays and meta alike
    second = str(tmp_path / "second.ckpt")
    r.save(second, *_stats(reader), phase="post_admm")
    again = _arrays(second)
    assert sorted(again) == sorted(written)
    for k in written:
        assert again[k].dtype == written[k].dtype == np.float64
        np.testing.assert_array_equal(again[k], written[k])
    with open(first + ".meta.json") as f1, \
            open(second + ".meta.json") as f2:
        assert f1.read() == f2.read()


def test_port_save_counts_its_host_reads(tmp_path):
    """A save reads each tensor to the host once, under "other"."""
    from lorads_torch import device as dev
    s = _solver("torch")
    dev.reset_host_syncs()
    s.save(str(tmp_path / "c"))
    # R, U, V, S: two cones and the LP each; the dual
    assert dev.HOST_SYNCS_BY["other"] == dev.HOST_SYNCS == 4 * 3 + 1


def test_solution_files_are_the_same(tmp_path):
    """save_solution from the same state (the same seeded start and a
    scaled dual) in both packages: the same keys, bit for bit."""
    files = []
    for pkg in ("tpu", "torch"):
        s = _solver(pkg)
        dual = np.random.default_rng(3).standard_normal(s.m)
        s.dual = jnp.asarray(dual) if pkg == "tpu" else torch.tensor(dual)
        s.scale_obj_his = 5.0
        files.append(str(tmp_path / f"{pkg}.npz"))
        s.save_solution(files[-1])
    a, b = (_arrays(f) for f in files)
    assert sorted(a) == sorted(b) == ["f0", "f1", "lp", "y"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _warm_inputs(path, case, rng):
    """The factors of a solution file, as they are or with a column more
    (truncated on the way in) or one fewer (filled)."""
    z = _arrays(path)
    fs = [z["f0"], z["f1"]]
    if case == "truncate":
        fs = [np.concatenate([f, rng.standard_normal((f.shape[0], 1))],
                             axis=1) for f in fs]
    elif case == "fill":
        fs = [f[:, :-1] for f in fs]
    return fs, z["lp"], z["y"]


@pytest.mark.parametrize("case", ["as_saved", "truncate", "fill"])
@pytest.mark.parametrize("writer", ["tpu", "torch"])
def test_warm_start_crosses_packages(writer, case, tmp_path):
    w = _solver(writer)
    _set_state(w, writer, 1.0)
    path = str(tmp_path / "sol.npz")
    w.save_solution(path)
    fs, lp, y = _warm_inputs(path, case, np.random.default_rng(4))
    out = {}
    for pkg in ("tpu", "torch"):
        s = _solver(pkg)
        s.scale_obj_his = 5.0
        s.set_initial_factors(fs, lp, dual=y)
        assert s.U is s.R and s.V is s.R
        out[pkg] = ([_np(x) for x in s.R.cones], _np(s.R.lp), _np(s.dual))
    for a, b in zip(out["tpu"][0], out["torch"][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["tpu"][1], out["torch"][1])
    np.testing.assert_array_equal(out["tpu"][2], out["torch"][2])
    ranks = [x.shape[2] for x in out["torch"][0]]
    for k, (F, R) in enumerate(zip(fs, out["torch"][0])):
        keep = min(F.shape[1], ranks[k])
        np.testing.assert_array_equal(R[0, :F.shape[0], :keep], F[:, :keep])
    np.testing.assert_array_equal(out["torch"][1], np.sqrt(lp))
    np.testing.assert_array_equal(out["torch"][2], y * 5.0)


@pytest.mark.parametrize("case", ["rows", "ndim", "negative_lp"])
def test_warm_start_refuses_bad_input(case, tmp_path):
    s0 = _solver("torch")
    path = str(tmp_path / "sol.npz")
    s0.save_solution(path)
    fs, lp, y = _warm_inputs(path, "as_saved", None)
    if case == "rows":
        fs[1] = fs[1][1:]
    elif case == "ndim":
        fs[0] = fs[0][None]
    else:
        lp = lp.copy()
        lp[0] = -1.0
    msgs = []
    for pkg in ("tpu", "torch"):
        with pytest.raises(ValueError) as e:
            _solver(pkg).set_initial_factors(fs, lp, dual=y)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# The CLI sequence, the trace, the peaks.
# ---------------------------------------------------------------------------

def test_cli_extras_sequence(tmp_path, capsys):
    """tests/test_io.py's sequence with --device cpu, then --traceDir."""
    from lorads_torch.__main__ import main
    from lorads_torch.io import generators
    from lorads_torch.io.sdpa import write_sdpa

    f = tmp_path / "mc.dat-s"
    write_sdpa(str(f), generators.maxcut(n=40, avg_degree=4, seed=2))
    base = [str(f), "--quiet", "--device", "cpu"]
    ck, sol = tmp_path / "state.ckpt", tmp_path / "sol.npz"
    assert main(base + ["--timesLogRank", "2.0", "--ALMRhoFactor", "2.0",
                        "--lbfgsListLength", "2", "--dualUV", "1",
                        "--checkpoint", str(ck), "--solOut", str(sol)]) == 0
    out = capsys.readouterr().out
    assert f"solution written to {sol}" in out
    assert ck.exists() and sol.exists()
    assert (tmp_path / "state.ckpt.meta.json").exists()
    assert main(base + ["--resume", str(ck)]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {ck} (phase post_admm)" in out
    assert main(base + ["--warmStart", str(sol)]) == 0
    out = capsys.readouterr().out
    assert f"warm started from {sol}" in out
    assert "primal_dual_optimal" in out
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz")
    assert main(base + ["--warmStart", str(bad)]) == 2
    assert "could not warm-start" in capsys.readouterr().err
    trace = tmp_path / "trace"
    assert main(base + ["--traceDir", str(trace)]) == 0
    assert "primal_dual_optimal" in capsys.readouterr().out
    assert list(trace.glob("*.pt.trace.json"))


def test_device_trace_on_the_cpu(tmp_path):
    from lorads_torch.utils.profiling import device_trace
    with device_trace(None):
        pass
    with device_trace(str(tmp_path), "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and "aten::mm" in files[0].read_text()


def test_lost_kernels_are_launches_without_a_kernel_event():
    from lorads_torch.utils.profiling import lost_kernels

    def ev(cat, name, corr):
        return {"cat": cat, "name": name, "args": {"correlation": corr}}
    events = [ev("cuda_runtime", "cudaLaunchKernel", 1),
              ev("kernel", "k1", 1),
              ev("cuda_runtime", "cudaLaunchKernel", 2),
              ev("cuda_runtime", "cudaLaunchKernelExC", 3),
              ev("cuda_runtime", "cudaMemcpyAsync", 4),
              ev("cuda_runtime", "cudaGraphLaunch", 5),
              ev("kernel", "k3", 3)]
    assert lost_kernels(events) == [events[2]]
    assert lost_kernels(events[:2]) == []


def test_trace_start_probe_needs_a_card(monkeypatch):
    from lorads_torch.probes import trace_start
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_start.main(["--traces", "1"]) == 3


def test_roofline_needs_a_card():
    from lorads_torch.utils import profiling
    with pytest.raises(ValueError, match="no datasheet"):
        profiling.chip_peaks("cpu")
    with pytest.raises(ValueError, match="no datasheet"):
        profiling.roofline(1e9, 1e9, 1e-3, device="cpu")
    assert profiling.H100_SXM_PEAKS["hbm"] == 3.35e12
    r = dict(flops=2e9, bytes=1e9, wall_s=2e-3, target_s=1e-3,
             bound="compute", mfu=0.5, bw_frac=0.25, headroom=2.0)
    assert "x2.0 off" in profiling.format_roofline("k", r)


def test_solver_accepts_trace_dir(tmp_path):
    """LoradsParams.trace_dir is the CLI's to read, as in lorads_tpu: the
    solver takes it and writes nothing."""
    s = TorchSolver(_problem(), TorchParams(verbose=False,
                                            trace_dir=str(tmp_path)),
                    device="cpu")
    assert s.params.trace_dir == str(tmp_path)
    assert not list(tmp_path.iterdir())
