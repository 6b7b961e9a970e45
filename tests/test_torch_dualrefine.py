"""lorads_torch's CGNR dual refinement vs lorads_tpu's, from the same state.

Both packages run on the CPU at f64, with the spectral dual repair forced
to reject (monkeypatched here; no lorads_tpu file changes), so that
``_try_dual_refine`` goes on to the CGNR refinement
(lorads_tpu/alg/solver.py:1051-1101).  lorads_tpu's state on entry to
it -- factors U, V, dual, objective scale, pObj, dObj, gap, dinf -- is
captured, its refinement is run and recorded (the CGNR step and LS
norms, each candidate's re-certified dinf, the decision, the log line),
and the port starts from that state:

* theta_gtoy60 (a dense bucket: each CGNR iteration runs K4's dense A(.)
  and build_w), stopped at the refinement of its own solve: 362 CGNR
  iterations at most; no candidate lowers dinf, so the step is rejected
  and lorads_tpu's solve goes on to the level-2 reopt;
* maxcut(n=80, deg 5, seed 7) after its solve, with the dual moved
  b-orthogonally out of the band (tests/test_dual_repair.py's case): the
  step is accepted.

Tolerances: the step and the LS norms within rtol 1e-10 where the CGNR
does not amplify summation order (maxcut80's 10 iterations, theta's
first 5); each candidate's dinf within rtol 1e-8 (an exact eigh of the
slack in both).  theta_gtoy60's whole CGNR amplifies the order of its
sums geometrically, in lorads_tpu alone as well: it is held to
lorads_tpu's own spread under a one-ulp change of its dual, and its
candidates' dinf to rtol 1e-4, with the same decision and log line.
"""

import re

import jax
import numpy as np
import pytest
import torch

from lorads_tpu.alg import solver as tpu_solver
from lorads_tpu.alg.admm import ADMMStats as TpuStats
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_torch import interop
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import solver as t_solver
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.dualrefine import dual_ls_refine
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams

FIX = "tests/fixtures/"


class _Stop(Exception):
    """Ends lorads_tpu's solve once its refinement has been recorded."""


def _problem(name):
    if name == "maxcut80":
        return tpu_gen.maxcut(n=80, avg_degree=5, seed=7)
    return tpu_sdpa.read_sdpa(FIX + name + ".dat-s")


def _log_into(lines):
    return lambda *a, **k: lines.append(" ".join(map(str, a)))


def _refine_line(lines):
    """The "dual refine:" line without its wall time."""
    (line,) = [ln for ln in lines if ln.startswith("dual refine:")]
    return re.sub(r" \[[0-9.]+s\]", "", line)


def _reference_refine(js, refine, admm_stats):
    """lorads_tpu's ``refine`` (its _try_dual_refine) with the spectral
    repair forced to reject: the entry state, the CGNR output, each
    candidate's dinf, the decision and the log line."""
    seen = dict(state=dict(U=js.U, V=js.V, dual=np.asarray(js.dual),
                           scale=js.scale_obj_his, pobj=js.pobj,
                           dobj=js.dobj, gap=js.gap,
                           dinf=admm_stats.dinf_l1),
                dinfs=[])
    ls_refine = tpu_solver.dual_ls_refine
    cert = js.dual_infeasibility
    lines = []

    def ls_spy(pd, R, dual, n_iter):
        out = ls_refine(pd, R, dual, n_iter)
        seen["ls"] = [np.asarray(a) for a in jax.device_get(out)]
        seen["n_iter"] = n_iter
        return out

    def cert_spy(stats=None, repair=None):
        d = cert(stats=stats, repair=repair)
        seen["dinfs"].append(d)
        return d

    js.dual_infeasibility, log, js.log = cert_spy, js.log, _log_into(lines)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpu_solver, "try_spectral_repair", lambda s, a: False)
        mp.setattr(tpu_solver, "dual_ls_refine", ls_spy)
        seen["accepted"] = refine(admm_stats)
    js.dual_infeasibility, js.log = cert, log
    seen["line"] = _refine_line(lines)
    seen["after"] = dict(dinf=admm_stats.dinf_l1, dobj=admm_stats.dobj,
                         gap=admm_stats.gap, dual=np.asarray(js.dual))
    return seen


@pytest.fixture(scope="module")
def theta_ref():
    """lorads_tpu's theta_gtoy60 solve up to its CGNR refinement."""
    js = TpuSolver(_problem("theta_gtoy60"), TpuParams(verbose=False))
    refine = js._try_dual_refine
    out = {}

    def capture(admm_stats):
        out.update(_reference_refine(js, refine, admm_stats))
        raise _Stop

    js._try_dual_refine = capture
    with pytest.raises(_Stop):
        js.solve()
    return js, out


@pytest.fixture(scope="module")
def maxcut_ref():
    """lorads_tpu's maxcut80 solve, its dual then moved b-orthogonally
    out of the band (tests/test_dual_repair.py), and its refinement."""
    js = TpuSolver(_problem("maxcut80"), TpuParams(verbose=False))
    js.solve()
    rng = np.random.default_rng(3)
    p = rng.standard_normal(js.pd.m)
    b = np.asarray(js.pd.rhs, np.float64)
    p -= (b @ p) / (b @ b) * b
    scale = 2e-3 * max(1.0, float(np.abs(np.asarray(js.dual)).max()))
    js.dual = js.dual + scale * p
    stats = TpuStats(rho=1.0)
    stats.dinf_l1 = js.dual_infeasibility(stats=stats, repair=False)
    stats.gap = js.gap
    return js, _reference_refine(js, js._try_dual_refine, stats)


def _port_at(js, st):
    """The port's solver on lorads_tpu's problem, at the state ``st``."""
    ts = TorchSolver(js.problem, TorchParams(verbose=False), device="cpu")
    ts.pd = t_aop.scale_objective(ts.pd, st["scale"])
    ts.scale_obj_his = st["scale"]
    s = interop.state_from_numpy(U=st["U"], V=st["V"], dual=st["dual"])
    ts.U, ts.V, ts.dual = s["U"], s["V"], s["dual"]
    ts.pobj, ts.dobj, ts.gap = st["pobj"], st["dobj"], st["gap"]
    return ts


def _both_ls_refine(js, st, n_iter, dual=None):
    """(lorads_tpu's (step, ls0, ls1), the port's (step, ls0, ls1, its))
    of dual_ls_refine from the state ``st`` (``dual`` replaces its dual
    in lorads_tpu's run only)."""
    ts = _port_at(js, st)
    R = jax.tree.map(lambda u, v: 0.5 * (u + v), st["U"], st["V"])
    d = st["dual"] if dual is None else dual
    ref = jax.device_get(tpu_solver.dual_ls_refine(js.pd, R, d, n_iter))
    out = dual_ls_refine(ts.pd, ts.U.average(ts.V), ts.dual, n_iter)
    return [np.asarray(a) for a in ref], [a.numpy() for a in out]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", ["theta_gtoy60", "maxcut80"])
def test_dual_ls_refine_matches_lorads_tpu(case, theta_ref, maxcut_ref):
    """The step and both LS norms at rtol 1e-10: maxcut80's whole CGNR
    (it converges in 10 iterations), theta_gtoy60's first 5 iterations
    (see the next test for its whole run)."""
    js, ref = theta_ref if case == "theta_gtoy60" else maxcut_ref
    n_iter = ref["n_iter"] if case == "maxcut80" else 5
    assert n_iter == (160 if case == "maxcut80" else 5)
    (jstep, jls0, jls1), (step, ls0, ls1, its) = _both_ls_refine(
        js, ref["state"], n_iter)
    if case == "maxcut80":
        np.testing.assert_allclose([jstep, jls0, jls1][1:],
                                   [x for x in ref["ls"][1:]], rtol=0)
    assert 0 < int(its) <= n_iter
    assert float(ls0) == pytest.approx(float(jls0), rel=1e-10)
    assert float(ls1) == pytest.approx(float(jls1), rel=1e-10)
    assert _rel(step, jstep) <= 1e-10
    # the step keeps dObj: b^T step = 0
    b = np.asarray(js.pd.rhs, np.float64)
    assert abs(b @ step) <= 1e-10 * (np.abs(b) @ np.abs(step))


def test_dual_ls_refine_theta_parts_by_summation_order(theta_ref):
    """theta_gtoy60's whole CGNR (converged in 221 iterations on the CPU)
    amplifies summation order: lorads_tpu against itself, with its dual
    moved by one ulp, parts by 1.1e-4 in the step and 4.5e-8 in the final
    LS norm; the port parts from lorads_tpu by less (CPU: 7.0e-5 and
    2.7e-8).  Held: ls0 at rtol 1e-10, and the step and ls1 within 4x
    lorads_tpu's own one-ulp spread."""
    js, ref = theta_ref
    st = ref["state"]
    n_iter = ref["n_iter"]
    (jstep, jls0, jls1), (step, ls0, ls1, its) = _both_ls_refine(
        js, st, n_iter)
    (ustep, _, uls1), _ = _both_ls_refine(
        js, st, n_iter, dual=np.nextafter(st["dual"], np.inf))
    assert 0 < int(its) < n_iter                 # converged before the cap
    assert float(ls0) == pytest.approx(float(jls0), rel=1e-10)
    spread_step, spread_ls1 = _rel(ustep, jstep), abs(uls1 / jls1 - 1)
    assert 0 < spread_step and 0 < spread_ls1
    assert _rel(step, jstep) <= 4 * spread_step
    assert abs(float(ls1) / float(jls1) - 1) <= 4 * spread_ls1


@pytest.mark.parametrize("case", ["theta_gtoy60", "maxcut80"])
def test_try_dual_refine_matches_lorads_tpu(case, theta_ref, maxcut_ref,
                                            monkeypatch):
    """From lorads_tpu's entry state: the same candidates' dinf, the same
    decision, the same log line (wall time aside); an accepted step
    updates the stats as lorads_tpu's does, a rejected one restores the
    dual, dObj and gap."""
    js, ref = theta_ref if case == "theta_gtoy60" else maxcut_ref
    st = ref["state"]
    ts = _port_at(js, st)
    lines, dinfs = [], []
    ts.log = _log_into(lines)
    cert = ts.dual_infeasibility

    def cert_spy(stats=None, repair=None):
        d = cert(stats=stats, repair=repair)
        dinfs.append(d)
        return d

    ts.dual_infeasibility = cert_spy
    monkeypatch.setattr(t_solver, "try_spectral_repair", lambda s, a: False)
    stats = ADMMStats(rho=1.0, dobj=st["dobj"], gap=st["gap"],
                      dinf_l1=st["dinf"])
    dual0 = ts.dual.clone()
    accepted = ts._try_dual_refine(stats)
    assert accepted == ref["accepted"] == (case == "maxcut80")
    # theta's step parts from lorads_tpu's by summation order (the test
    # above), and its candidates' dinf with it (CPU: 2.9e-6)
    np.testing.assert_allclose(dinfs, ref["dinfs"],
                               rtol=1e-8 if case == "maxcut80" else 1e-4)
    assert _refine_line(lines) == ref["line"]
    info = ts.dual_refine_info
    assert info["accepted"] == accepted
    assert 0 < info["iters"] <= info["n_iter"] == ref["n_iter"]
    after = ref["after"]
    assert stats.dinf_l1 == pytest.approx(after["dinf"], rel=1e-8)
    assert stats.dobj == pytest.approx(after["dobj"], rel=1e-10)
    assert stats.gap == pytest.approx(after["gap"], rel=1e-6, abs=1e-14)
    if accepted:
        np.testing.assert_allclose(ts.dual.numpy(), after["dual"],
                                   rtol=1e-9, atol=1e-12)
    else:
        assert torch.equal(ts.dual, dual0)
        assert (ts.dobj, ts.gap) == (st["dobj"], st["gap"])
