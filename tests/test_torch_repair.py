"""lorads_torch's spectral dual repair over several buckets vs lorads_tpu.

merge_problems of lovasz_theta(n=30, avg_degree=4, seed=1) and
lovasz_theta(n=90, avg_degree=4, seed=2) presolves to two dense
buckets (their dims lie in different size classes).  lorads_tpu solves
it on the CPU at f64 and its failing dinf takes the spectral repair;
the port starts from lorads_tpu's state just before the repair, whose
bases then span both buckets, so the round runs the host active-set
loop (``_host_active_set``, lorads_tpu spectral_repair.py:328-381)
instead of the fused single-bucket one.

Checked: the certificate's dinf at that state (rtol 1e-7), the repair
accepted in both packages through the host loop, dinf inside the band
after, dObj unchanged (every step is b-orthogonal: rtol 1e-10).  Each
package's eigenvectors of a clustered spectrum come out in other bases,
so the rounds are not compared.
"""

import numpy as np
import pytest
import torch

from lorads_tpu.alg import solver as tpu_solver
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core.problem import merge_problems
from lorads_tpu.io import generators as tpu_gen
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import spectral_repair as t_repair
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams


def _problem():
    return merge_problems([tpu_gen.lovasz_theta(n=30, avg_degree=4, seed=1),
                           tpu_gen.lovasz_theta(n=90, avg_degree=4, seed=2)])


@pytest.fixture(scope="module")
def reference():
    """lorads_tpu's whole solve, its state captured just before the dual
    refinement, and the spectral repair's outcome."""
    js = TpuSolver(_problem(), TpuParams(verbose=False))
    seen = {}
    refine = js._try_dual_refine

    def capture(admm_stats):
        seen["state"] = dict(dual=np.asarray(js.dual),
                             scale=js.scale_obj_his, pobj=js.pobj,
                             dobj=js.dobj, gap=js.gap,
                             dinf=admm_stats.dinf_l1)
        return refine(admm_stats)

    repair = tpu_solver.try_spectral_repair

    def spy(solver, admm_stats):
        seen["repair"] = repair(solver, admm_stats)
        return seen["repair"]

    js._try_dual_refine = capture
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_solver, "try_spectral_repair", spy)
        seen["result"] = js.solve()
    seen["buckets"] = len(js.pd.buckets)
    return seen


def _dinf(ts, scale):
    lp_part, lams = ts._dual_infeas_pass()
    neg = sum(float(np.sum(np.abs(np.minimum(lam, 0.0)))) for lam in lams)
    return (lp_part + neg) / (scale * (ts.pd.c_nrm1 + 1.0))


def test_spectral_repair_over_two_buckets(reference, monkeypatch):
    assert reference["buckets"] == 2
    assert reference["result"].status.value == "primal_dual_optimal"
    assert reference["repair"] is True
    st = reference["state"]
    ts = TorchSolver(_problem(), TorchParams(verbose=False), device="cpu")
    assert len(ts.pd.buckets) == 2 and all(bk.dense for bk in ts.pd.buckets)
    ts.pd = t_aop.scale_objective(ts.pd, st["scale"])
    ts.scale_obj_his = st["scale"]
    ts.dual = torch.as_tensor(st["dual"], dtype=torch.float64)
    ts.pobj, ts.dobj, ts.gap = st["pobj"], st["dobj"], st["gap"]
    dinf = _dinf(ts, st["scale"])
    assert dinf == pytest.approx(st["dinf"], rel=1e-7)
    band = 5 * ts.params.phase2_tol
    assert dinf > band
    calls = []
    host_loop = t_repair._host_active_set

    def counted(*a, **k):
        calls.append(1)
        return host_loop(*a, **k)

    monkeypatch.setattr(t_repair, "_host_active_set", counted)
    stats = ADMMStats(rho=1.0, dobj=st["dobj"], gap=st["gap"], dinf_l1=dinf)
    assert t_repair.try_spectral_repair(ts, stats) is True
    assert calls
    info = ts.spectral_repair_info
    assert info["accepted"] and info["dinf_before"] == dinf
    assert stats.dinf_l1 == info["dinf_after"] <= band
    assert stats.dobj == pytest.approx(st["dobj"], rel=1e-10)
    # the reported dinf is the certificate of the kept dual
    assert _dinf(ts, st["scale"]) == pytest.approx(stats.dinf_l1, rel=1e-9)
