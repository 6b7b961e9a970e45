"""lorads_torch's general split bucket of several blocks vs lorads_tpu.

merge_problems of matrix_completion(60 x 60, seed 1) and
matrix_completion(40 x 50, seed 2): two blocks of dims 120 and 90, each
on its own constraints, presolve into one general split bucket of two
blocks (the second padded to 120) on local slots, neither diag-identity
nor dense.  The whole solve runs ALM on K3p / K4 / K5 at B = 2 and ADMM
with CG over both blocks at once (their constraints are disjoint).

lorads_tpu runs on CPU at f64 (conftest); the port on CPU tensors.
Tolerances as stated in the test.
"""

import re
import time

import jax.numpy as jnp
import numpy as np

from lorads_tpu.alg.alm import ALMStats as TpuALMStats
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.alg.state import FactorVec as TpuFactorVec
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core.problem import merge_problems
from lorads_tpu.io import generators as tpu_gen
from lorads_torch.alg.alm import ALMStats
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.config import SolverStatus

OUTER_LINE = re.compile(
    r"ALM Outer:(\d+) Inner:(\d+) pObj:(\S+) dObj:(\S+) pInf\(1\):(\S+) "
    r"pInf\(Inf\):(\S+) pdGap:(\S+)")


def _outer_rows(lines):
    rows = []
    for line in lines:
        m = OUTER_LINE.search(line)
        if m:
            g = m.groups()
            rows.append((int(g[0]), int(g[1])) + tuple(map(float, g[2:])))
    return rows


def test_sparse_two_block_solve_matches_lorads_tpu():
    """Both packages log the same ALM path through outer 4 (inner counts
    and logged objectives), then one L-BFGS inner count moves by a few
    steps (CPU: 397 against 399 at outer 5); pObj within 1e-5 (CPU:
    1.6e-6)."""
    problem = merge_problems([
        tpu_gen.matrix_completion(n1=60, n2=60, frac_obs=0.05, seed=1),
        tpu_gen.matrix_completion(n1=40, n2=50, frac_obs=0.05, seed=2)])
    jlog, tlog = [], []
    js = TpuSolver(problem, TpuParams(verbose=False))
    js.log = lambda *a, **k: jlog.append(" ".join(map(str, a)))
    jr = js.solve()
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    ts.log = lambda *a, **k: tlog.append(" ".join(map(str, a)))
    tr = ts.solve()
    bk = ts.pd.buckets[0]
    assert len(ts.pd.buckets) == 1 and (bk.B, bk.n) == (2, 120)
    assert not (bk.dense or bk.diag_ident or bk.glob_ident)
    assert ts._bucket_jacobi == (True,)
    assert jr.status.value == "primal_dual_optimal"
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    jrows, trows = _outer_rows(jlog), _outer_rows(tlog)
    assert len(jrows) >= 4 and len(trows) >= 4
    for j, t in zip(jrows[:4], trows[:4]):
        assert t[:2] == j[:2]
        np.testing.assert_allclose(t[2:], j[2:], rtol=1e-5, atol=0)
    assert abs(tr.pobj - jr.pobj) <= 1e-5 * abs(jr.pobj)
    assert ts.admm_cg_total > 0
    fs, lp_vals = ts.factor_blocks()
    assert lp_vals is None
    assert [F.shape[0] for F in fs] == [120, 90]


def _outer_counts(lines):
    return [ln.split(" pObj")[0] for ln in lines
            if ln.startswith("ALM Outer")]


def test_split_matcomp_alm_parts_by_summation_order():
    """Where the two-block solve above parts from lorads_tpu: before any
    CG, in ALM outer 5 (397 inner steps in lorads_tpu, 399 in the port).
    lorads_tpu itself, from initial factors moved by one ulp, takes 398
    there, while outer 1-4 keep their counts in all three runs: the
    L-BFGS steps amplify summation order, as in the merged Max-Cut batch
    (test_merged_maxcut_batch_parts_by_summation_order)."""
    problem = merge_problems([
        tpu_gen.matrix_completion(n1=60, n2=60, frac_obs=0.05, seed=1),
        tpu_gen.matrix_completion(n1=40, n2=50, frac_obs=0.05, seed=2)])
    runs = []
    for ulp in (False, True):
        js = TpuSolver(problem, TpuParams(verbose=False))
        lines = []
        js.log = lambda *a, **k: lines.append(" ".join(map(str, a)))
        if ulp:
            js.R = TpuFactorVec(tuple(
                jnp.asarray(np.nextafter(np.asarray(c), np.inf))
                for c in js.R.cones), js.R.lp)
            js.U = js.V = js.R
        js.alm_phase(TpuALMStats(rho=js.ps.rho0), time.time(),
                     max_alm_iter=5)
        runs.append(_outer_counts(lines))
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    lines = []
    ts.log = lambda *a, **k: lines.append(" ".join(map(str, a)))
    ts.alm_phase(ALMStats(rho=ts.ps.rho0), time.time(), max_alm_iter=5)
    runs.append(_outer_counts(lines))
    ref, moved, port = runs
    assert ref[:4] == moved[:4] == port[:4]
    assert ref[4] == "ALM Outer:5 Inner:397"
    assert moved[4] == "ALM Outer:5 Inner:398"
    assert port[4] == "ALM Outer:5 Inner:399"
