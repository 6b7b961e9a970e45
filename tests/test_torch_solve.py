"""lorads_torch end to end: solves against lorads_tpu, the CLI, imports
without JAX, chip_smoke.py without a GPU, out-of-slice configurations.

Both packages solve the same instance on CPU at f64.  Two certified
solutions agree on pObj within the width the acceptance bands leave
them (gap <= 5 * phase2_tol each): 1e-4 relative.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io.sdpa import read_sdpa
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams, SolverStatus
from lorads_torch.core.presolve import presolve as t_presolve
from lorads_torch.io import generators as t_gen
from lorads_torch.ops import pattern as t_pat


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
POBJ_RTOL = 1e-4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _maxcut_with_offdiag(shared):
    """maxcut(120, 4) plus constraints with right-hand side 0 on
    off-diagonal slots, so X = I stays feasible: 40 single-entry
    constraints X_ij = 0 (each slot owns its constraint, beside the
    diagonal ones), or 8 two-entry constraints whose slots are shared
    (a_off_unique False)."""
    base = tpu_gen.maxcut(n=120, avg_degree=4, seed=3)
    blk = base.blocks[0]
    rng = np.random.default_rng(3)
    rows = rng.integers(1, 120, 400)
    cols = (rows * rng.random(400)).astype(np.int64)
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)[:40]
    con, row, col, val = [], [], [], []
    m = base.m
    if shared:
        for _ in range(8):
            for s in rng.choice(len(pairs), 2, replace=False):
                con.append(m), row.append(pairs[s][0])
                col.append(pairs[s][1]), val.append(rng.standard_normal())
            m += 1
    else:
        for i, j in pairs:
            con.append(m), row.append(i), col.append(j), val.append(1.0)
            m += 1
    cat = lambda a, b, dt: np.concatenate(  # noqa: E731
        [a, np.asarray(b)]).astype(dt)
    blk = dataclasses.replace(
        blk, m=m, a_con=cat(blk.a_con, con, np.int32),
        a_row=cat(blk.a_row, row, np.int32),
        a_col=cat(blk.a_col, col, np.int32),
        a_val=cat(blk.a_val, val, np.float64))
    return dataclasses.replace(
        base, m=m, rhs=np.concatenate([base.rhs, np.zeros(m - base.m)]),
        blocks=[blk])


def _instance(name):
    if name == "maxcut120_offdiag":
        return _maxcut_with_offdiag(shared=False)
    if name == "maxcut120_shared":
        return _maxcut_with_offdiag(shared=True)
    if name == "maxcut300":
        return tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    if name == "gset_torus10000":
        return tpu_gen.maxcut_from_graph(
            os.path.join(FIX, "gset_torus10000.rudy"))
    if name == "matcomp500":
        return read_sdpa(os.path.join(FIX, "matcomp500.dat-s"))
    if name.startswith("matcomp"):       # bench.py's recipe, n1 = n2
        n = int(name[len("matcomp"):])
        return tpu_gen.matrix_completion(n1=n, n2=n, true_rank=3,
                                         frac_obs=0.12, seed=3)
    return read_sdpa(os.path.join(FIX, "maxcut2000.dat-s"))


def _solve_both(name, chunks=None):
    """lorads_tpu's and the port's results; ``chunks``, if a list, gets
    the CG count of each of the port's ADMM chunks."""
    problem = _instance(name)
    jr = TpuSolver(problem, TpuParams(verbose=False)).solve()
    ts = TorchSolver(problem, LoradsParams(verbose=False), device="cpu")
    if chunks is None:
        return jr, ts.solve()
    chunk = t_admm.admm_chunk

    def counted(*a, **k):
        c = chunk(*a, **k)
        chunks.append(c["cg_iter"])
        return c

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_admm, "admm_chunk", counted)
        tr = ts.solve()
    assert ts.admm_cg_total == sum(chunks)
    return jr, tr


def _assert_agree(jr, tr):
    p = LoradsParams()
    assert jr.status.value == "primal_dual_optimal"
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert abs(tr.pobj - jr.pobj) <= POBJ_RTOL * abs(jr.pobj)
    assert tr.pinf_l1 <= p.phase2_tol
    assert tr.gap <= 5 * p.phase2_tol
    assert tr.dinf_l1 <= 5 * p.phase2_tol
    assert np.all(np.isfinite(tr.dual))
    assert bool(torch.isfinite(tr.R.cones[0]).all())


# (diag_ident, has_diag_a, a_off_unique) of the general-path instances
_GENERAL = {"matcomp500": (False, False, True),
            "maxcut120_offdiag": (False, True, True),
            "maxcut120_shared": (False, True, False)}


@pytest.mark.parametrize("name", ["maxcut300", "maxcut2000", "matcomp500",
                                  "maxcut120_offdiag", "maxcut120_shared"])
def test_solve_matches_lorads_tpu(name):
    """maxcut300 takes ALM + closed-form ADMM + the exact-eigh
    certificate; maxcut2000 the Lanczos certificate; the general sparse
    path takes ALM, ADMM with mixed-precision CG and exact eigh, with
    off constraints alone (matcomp500), beside diagonal ones
    (maxcut120_offdiag: the CG operator's diagonal composition) and
    sharing slots (maxcut120_shared: the generic CG operator)."""
    chunks = []
    jr, tr = _solve_both(name, chunks)
    _assert_agree(jr, tr)
    assert tr.admm_stats.iter == jr.admm_stats.iter
    assert tr.alm_stats.inner_iter == jr.alm_stats.inner_iter
    if name != "maxcut2000":
        assert tr.admm_stats.iter > 0
    if name in _GENERAL:
        problem = _instance(name)
        bk = t_pat.build_bucket_data(
            t_presolve(problem, LoradsParams()).buckets[0], problem.m,
            torch.float64, "cpu")
        assert (bk.diag_ident, bk.has_diag_a,
                bk.a_off_unique) == _GENERAL[name]
        # cg_iter is the last ADMM chunk's CG count in both packages (the
        # port's solver keeps the total, checked in _solve_both)
        assert tr.admm_stats.cg_iter == chunks[-1] > 0
        assert jr.admm_stats.cg_iter > 0
    if name == "matcomp500":               # one ADMM dispatch
        assert len(chunks) == 1
        assert tr.admm_stats.cg_iter == jr.admm_stats.cg_iter
    if name == "maxcut120_shared":
        assert len(chunks) > 1


@pytest.mark.slow
def test_gset_torus10000_matches_lorads_tpu():
    jr, tr = _solve_both("gset_torus10000")
    _assert_agree(jr, tr)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["matcomp600", "matcomp2000"])
def test_large_matcomp_solve_matches_lorads_tpu(name):
    """matcomp600 and matcomp2000 (n > 1024) certify by Lanczos on the
    W @ X matvec."""
    jr, tr = _solve_both(name)
    _assert_agree(jr, tr)


def test_cli_prints_dimacs_report():
    _check_cli_report("maxcut2000.dat-s")


def test_cli_prints_dimacs_report_matcomp500():
    _check_cli_report("matcomp500.dat-s")


def _check_cli_report(fixture):
    out = subprocess.run(
        [sys.executable, "-m", "lorads_torch",
         os.path.join(FIX, fixture), "--device", "cpu",
         "--quiet"], capture_output=True, text=True, timeout=300,
        env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "End Program with status `primal_dual_optimal`" in out.stdout
    for line in ("1.Primal Objective", "2.Dual Objective",
                 "1.Constraint Violation(1)", "2.Dual Infeasibility(1)",
                 "3.Primal Dual Gap", "6.Dual Infeasibility(Inf)"):
        assert line in out.stdout


_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
import lorads_torch
for m in pkgutil.walk_packages(lorads_torch.__path__, "lorads_torch."):
    importlib.import_module(m.name)
assert not any(k == "lorads_tpu" or k.startswith("lorads_tpu.")
               for k in sys.modules)
from lorads_torch import LoradsParams, LoradsSolver
from lorads_torch.io import generators
res = LoradsSolver(generators.maxcut(n=300, avg_degree=4, seed=3),
                   LoradsParams(verbose=False), device="cpu").solve()
print(res.status.value, res.pobj)
"""


def test_port_imports_and_solves_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX],
                         capture_output=True, text=True, timeout=300,
                         env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("primal_dual_optimal")


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    runs = [(REPO, os.path.join(REPO, "chip_smoke.py"))]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    runs.append((str(tmp_path), str(alone)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for cwd, script in runs:
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=300, cwd=cwd, env=env)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSolver(t_gen.maxcut(n=100, avg_degree=4, seed=1),
                    LoradsParams(verbose=False))


@pytest.mark.parametrize("case", ["shard", "f32"])
def test_out_of_slice_raises(case):
    problem = t_gen.maxcut(n=300, avg_degree=4, seed=3)
    params = LoradsParams(verbose=False, **{
        "shard": dict(shard="dp"),
        "f32": dict(dtype="f32"),
    }[case])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TorchSolver(problem, params, device="cpu")
