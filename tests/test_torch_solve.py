"""lorads_torch end to end: solves against lorads_tpu, the CLI, imports
without JAX, chip_smoke.py without a GPU, out-of-slice configurations.

Both packages solve the same instance on CPU at f64.  Two certified
solutions agree on pObj within the width the acceptance bands leave
them (gap <= 5 * phase2_tol each): 1e-4 relative.
"""

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
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams, SolverStatus
from lorads_torch.io import generators as t_gen
from lorads_torch.io.sdpa import read_sdpa as t_read_sdpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
POBJ_RTOL = 1e-4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _instance(name):
    if name == "maxcut300":
        return tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    if name == "gset_torus10000":
        return tpu_gen.maxcut_from_graph(
            os.path.join(FIX, "gset_torus10000.rudy"))
    return read_sdpa(os.path.join(FIX, "maxcut2000.dat-s"))


def _solve_both(name):
    problem = _instance(name)
    jr = TpuSolver(problem, TpuParams(verbose=False)).solve()
    tr = TorchSolver(problem, LoradsParams(verbose=False),
                     device="cpu").solve()
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


@pytest.mark.parametrize("name", ["maxcut300", "maxcut2000"])
def test_solve_matches_lorads_tpu(name):
    """maxcut300 takes ALM + closed-form ADMM + the exact-eigh
    certificate; maxcut2000 the Lanczos certificate."""
    jr, tr = _solve_both(name)
    _assert_agree(jr, tr)
    assert tr.admm_stats.iter == jr.admm_stats.iter
    assert tr.alm_stats.inner_iter == jr.alm_stats.inner_iter
    if name == "maxcut300":
        assert tr.admm_stats.iter > 0


@pytest.mark.slow
def test_gset_torus10000_matches_lorads_tpu():
    jr, tr = _solve_both("gset_torus10000")
    _assert_agree(jr, tr)


def test_cli_prints_dimacs_report():
    out = subprocess.run(
        [sys.executable, "-m", "lorads_torch",
         os.path.join(FIX, "maxcut2000.dat-s"), "--device", "cpu",
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


@pytest.mark.parametrize("case", ["dense_bucket", "lp_block", "shard",
                                  "f32", "multi_block"])
def test_out_of_slice_raises(case):
    params = LoradsParams(verbose=False)
    problem = t_gen.maxcut(n=300, avg_degree=4, seed=3)
    if case == "dense_bucket":        # n=60: union density > 0.1
        problem = t_read_sdpa(os.path.join(FIX, "mc_gtoy60.dat-s"))
    elif case == "lp_block":
        problem = t_read_sdpa(os.path.join(FIX, "hand_multiblock.dat-s"))
    elif case == "shard":
        params = LoradsParams(verbose=False, shard="dp")
    elif case == "f32":
        params = LoradsParams(verbose=False, dtype="f32")
    else:
        problem = t_gen.random_multiblock(n_blocks=3, dim=40, m=30,
                                          n_lp=0, seed=2)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TorchSolver(problem, params, device="cpu")
