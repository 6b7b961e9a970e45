"""lorads_torch's f32 ADMM chunk, its f64 escalation hooks and whole f32
solves, held to lorads_tpu on the CPU.

* one ADMM chunk at f32 (``chunk_loop`` against ``_make_admm_chunk``)
  from the same numpy start: statuses and counts equal, the floats
  within twice the spread measured between the packages (x86-64, one
  thread), rounded up to 1, 2 or 5 times a power of ten (``SPREAD32``);
  ``mc60_wedge`` stops on the f32 floor's wedge (lorads_tpu/alg/
  admm.py:599-611) in both, on the same iteration;
* the escalation hooks of lorads_tpu/alg/solver.py beside the
  preemptive one (tests/test_torch_f32.py): the plateau's "escalate and
  continue the same phase" (:478-487), the level-1 reopt's (:1283) and
  the level-2 reopt's (:1332), each held to lorads_tpu run here from
  the same f32 start with ``_auto_dtype`` set: its escalation reasons,
  its status and its pObj;
* whole f32 solves: maxcut(300, 4) at ``dtype="f32"`` (as
  tests/test_solver.py:333-339 runs lorads_tpu's), hand_multiblock from
  an f32 start with ``_auto_dtype`` (the level-1 hook) and theta_gtoy60
  from one (``slow``; its hooks also from lorads_tpu's own post-ALM
  state, resumed by both packages).

pObj is held within POBJ_RTOL32 (1e-4, the band of
tests/test_torch_solve.py) of lorads_tpu's from the same f32 start;
theta_gtoy60's within THETA_RTOL32.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import admm as tpu_admm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg.solver import ADMMStats as TpuADMMStats
from lorads_tpu.alg.solver import ALMStats as TpuALMStats
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.alg.state import FactorVec as TpuFV
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.alm import ALMStats
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams

FIX = "tests/fixtures/"
POBJ_RTOL32 = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(name):
    if name == "maxcut300":
        return tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    if name == "multiblock_lp":
        return tpu_gen.random_multiblock(n_blocks=8, dim=40, m=120,
                                         density=0.05, n_lp=400, seed=5)
    if name == "mc60":
        return tpu_gen.matrix_completion(n1=60, n2=60, true_rank=3,
                                         frac_obs=0.3, seed=0)
    return tpu_sdpa.read_sdpa(FIX + name + ".dat-s")


def BOUND(reading):
    """Twice ``reading``, rounded up to 1, 2 or 5 times a power of ten."""
    e = 10.0 ** np.floor(np.log10(2 * reading))
    return next(m * e for m in (1, 2, 5, 10) if m * e >= 2 * reading)


def _escalations(lines):
    return [ln.split("(", 1)[1].rstrip(")") for ln in lines
            if ln.startswith("escalating to float64")]


def _logged(solver):
    """Collect the solver's log lines (either package)."""
    lines = []
    solver.log = lambda *a, **k: lines.append(" ".join(map(str, a)))
    return lines


# ---------------------------------------------------------------------------
# One ADMM chunk at f32.
# ---------------------------------------------------------------------------

# The largest spread between the packages at f32 by case and group:
# objectives, DIMACS pinf and gap (differences of nearly equal terms; on
# mc60_wedge's f32 floor they are noise, hence above 1), the factors and
# the dual, and the CG count (each package's f32 stop tests lie within
# summation order of their tolerance, tests/test_torch_cg_parting.py)
SPREAD32 = {
    "theta_gtoy60": dict(obj=1.46e-7, dimacs=1.29e-7, vars=9.93e-7,
                         cg=5e-12),
    "hand_multiblock_gs": dict(obj=1.89e-6, dimacs=2.50e-3, vars=3.41e-6,
                               cg=3.45e-2),
    "mc60_wedge": dict(obj=2.76e-4, dimacs=1.21, vars=1.77e-3,
                       cg=7.56e-2),
}
# case: (problem, params of both packages, ALM outers or ADMM iterations
# of the port's f32 solve before the chunk, the chunk's n_steps, the
# status it ends on)
ADMM_CASES = {
    # the dense bucket's CG (K7a) at f32: no mixed-precision CG
    "theta_gtoy60": ("theta_gtoy60", {}, ("alm", 10), 4, t_admm.RUNNING),
    # K8c at f32, the LP's Gauss-Seidel sweep
    "hand_multiblock_gs": ("hand_multiblock", dict(lp_gauss_seidel=True),
                           ("alm", 10), 3, t_admm.RUNNING),
    # the f32 floor: pinf_l1 under tol, pinf_inf over it, flat for 30
    # iterations from an iterate 230 ADMM iterations in (the gap there
    # is f32 noise: its no-progress counter is not held)
    "mc60_wedge": ("mc60", dict(phase2_tol=1e-7), ("admm", 230), 60,
                   t_admm.STALLED),
}


@functools.lru_cache(maxsize=None)
def _start(name, kw, where):
    """The port's f32 solver at the chunk's start: after ``where[1]`` ALM
    outers (the ADMM phase's entry, U = V = R), or ``where[1]`` ADMM
    iterations into its phase; the state as numpy arrays."""
    ts = TorchSolver(_problem(name), TorchParams(
        verbose=False, dtype="f32", **dict(kw),
        **({"max_alm_iter": where[1]} if where[0] == "alm" else {})),
        device="cpu")
    alm_stats = ALMStats(rho=ts.ps.rho0)
    ts.alm_phase(alm_stats, time.time())
    admm_stats = ADMMStats(rho=ts.ps.rho0)
    ts.alm_to_admm(alm_stats, admm_stats)
    if where[0] == "admm":
        ts.admm_phase(admm_stats, where[1], time.time())
    np_ = lambda fv: ([x.numpy().copy() for x in fv.cones],  # noqa: E731
                      fv.lp.numpy().copy())
    return (ts, admm_stats.rho, admm_stats.iter, np_(ts.U), np_(ts.V),
            ts.dual.numpy().copy())


def _tpu_chunk(problem, kw, jacobi, U, V, dual, S, rho, rho_max, it0,
               n_steps):
    params = TpuParams(verbose=False, dtype="f32", **kw)
    pd = tpu_aop.build_problem_data(tpu_presolve.presolve(problem, params),
                                    jnp.float32)
    dt, i32 = jnp.float32, jnp.int32
    scale = jnp.asarray(1.0, dt)
    jl, jlp, jtot, packed = tpu_admm.admm_init_eval(pd, U, V, dual, scale)
    pobj, dobj, pinf, gap = (float(v) for v in jax.device_get(packed))
    fn = tpu_admm.make_admm_chunk(params, False, jacobi)
    return fn(pd, U, V, jl, jlp, jtot, dual, jnp.asarray(rho, dt),
              jnp.asarray(rho_max, dt), jnp.zeros((10,), dt),
              jnp.asarray(1e30, dt), jnp.zeros((), i32),
              jnp.asarray(it0, i32), jnp.asarray(pinf, dt),
              jnp.asarray(gap, dt), jnp.asarray(pobj, dt),
              jnp.asarray(dobj, dt), scale, jnp.asarray(100000, i32),
              jnp.asarray(n_steps, i32), jnp.asarray(gap, dt),
              jnp.zeros((), i32), jnp.asarray(pinf, dt),
              jnp.zeros((), i32), S)


@pytest.mark.parametrize("case", sorted(ADMM_CASES))
def test_admm_chunk_f32_matches_lorads_tpu(case):
    name, kw, where, n_steps, want = ADMM_CASES[case]
    kw_t = tuple(sorted(kw.items()))
    ts, rho, it0, (uc, ul), (vc, vl), dual = _start(name, kw_t, where)
    f32 = torch.float32
    U = interop.factor_from_numpy(uc, ul, f32)
    V = interop.factor_from_numpy(vc, vl, f32)
    tdual = torch.as_tensor(dual)
    tl, ttot, (pobj, dobj, pinf, gap) = t_admm.admm_init_eval(
        ts.pd, U, V, tdual, 1.0)
    carry = t_admm.make_carry(
        ts.pd, U, V, tl, ttot, tdual, rho=rho, cur_rho_max=ts.rho_max,
        pinf_buf=[0.0] * 10, old_pinf_mean=1e30, bad_pd=0, it=it0,
        pinf_l1=pinf, gap=gap, pobj=pobj, dobj=dobj, best_gap=gap,
        since_best=0, best_pinf=pinf, since_pinf=0)
    c = t_admm.admm_chunk(ts.params, ts.pd, {"carry": carry}, 1.0, 100000,
                          n_steps, jacobi=ts._bucket_jacobi, S=ts.S)
    got = c["carry"]
    S = TpuFV(tuple(jnp.asarray(x.numpy()) for x in ts.S.cones),
              jnp.asarray(ts.S.lp.numpy()))
    fv = lambda cs, lp: TpuFV(tuple(jnp.asarray(x) for x in cs),  # noqa
                              jnp.asarray(lp))
    out = _tpu_chunk(_problem(name), kw, ts._bucket_jacobi, fv(uc, ul),
                     fv(vc, vl), jnp.asarray(dual), S, rho, ts.rho_max, it0,
                     n_steps)
    assert got.U.cones[0].dtype == f32
    assert out["U"].cones[0].dtype == jnp.float32
    for f in ("status", "it", "k", "bad_pd", "since_pinf") + (
            ("since_best",) if case != "mc60_wedge" else ()):
        assert int(getattr(got, f)) == int(out[f]), f
    for f in ("rho", "cur_rho_max"):
        assert float(getattr(got, f)) == float(out[f]), f
    assert c["status"] == want
    spread = dict(
        obj=max(abs(float(getattr(got, f)) - float(out[f]))
                / abs(float(out[f])) for f in ("pobj", "dobj")),
        dimacs=max(abs(float(getattr(got, f)) - float(out[f]))
                   / abs(float(out[f])) for f in ("pinf_l1", "gap")),
        vars=max(float(np.abs(a.numpy() - np.asarray(b)).max()
                       / np.abs(np.asarray(b)).max())
                 for a, b in zip(got.U.cones + got.V.cones + (got.dual,),
                                 out["U"].cones + out["V"].cones
                                 + (out["dual"],))))
    spread["cg"] = abs(int(got.cg_iter) - int(out["cg_iter"])) / max(
        int(out["cg_iter"]), 1)
    for g, reading in SPREAD32[case].items():
        assert spread[g] <= BOUND(reading), (g, spread[g])


# ---------------------------------------------------------------------------
# The escalation hooks.
# ---------------------------------------------------------------------------

def _solver(pkg, name, auto=True, **kw):
    """Either package's solver from an f32 start (dtype="f32", with
    ``_auto_dtype`` set where ``auto``, as lorads_tpu's own tests reach
    its escalation) and its log lines."""
    if pkg == "tpu":
        s = TpuSolver(_problem(name), TpuParams(verbose=True, dtype="f32",
                                                **kw))
    else:
        s = TorchSolver(_problem(name), TorchParams(
            verbose=True, dtype="f32", **kw), device="cpu")
    s._auto_dtype = auto
    return s, _logged(s)


def _solve_both(name, auto=True, **kw):
    """{pkg: (solver, result, escalation reasons, log lines)} of both
    packages' solves of ``name`` from the same f32 start."""
    out = {}
    for pkg in ("tpu", "torch"):
        s, lines = _solver(pkg, name, auto, **kw)
        res = s.solve()
        out[pkg] = (s, res, _escalations(lines), lines)
    return out


def _same_outcome(out, rtol):
    """The port's status and escalation reasons are lorads_tpu's, its pObj
    within ``rtol`` of lorads_tpu's; returns lorads_tpu's reasons."""
    (_, jr, je, _), (ts, tr, te, _) = out["tpu"], out["torch"]
    assert tr.status.value == jr.status.value
    assert te == je
    assert [r for r, _ in ts.escalations] == je
    assert abs(tr.pobj - jr.pobj) <= rtol * abs(jr.pobj)
    return je


def _plateau(pkg):
    """alm_phase, then admm_phase(iter_celling=300) of mc60 with
    phase2_tol=1e-7 from an f32 start with auto: (solver, return value,
    stats, escalation reasons, the ADMM iteration of the f32 plateau)."""
    s, lines = _solver(pkg, "mc60", phase2_tol=1e-7)
    alm_cls, admm_cls = ((TpuALMStats, TpuADMMStats) if pkg == "tpu"
                         else (ALMStats, ADMMStats))
    alm = alm_cls(rho=s.ps.rho0)
    s.alm_phase(alm, time.time())
    stats = admm_cls(rho=s.ps.rho0)
    s.alm_to_admm(alm, stats)
    ret = s.admm_phase(stats, 300, time.time())
    k = lines.index("ADMM gap plateau at the f32 dual-noise floor")
    at = int(lines[k - 1].split()[1].split(":")[1])
    return s, ret, stats, _escalations(lines), at


def test_plateau_escalates_and_continues():
    """An f32 ADMM phase that stalls (here on the f32 floor's wedge)
    escalates and runs the same phase on at f64 to its iteration ceiling
    (lorads_tpu/alg/solver.py:478-487), as lorads_tpu's does from the
    same start."""
    _, jret, jst, jesc, jat = _plateau("tpu")
    s, ret, stats, esc, at = _plateau("torch")
    assert esc == jesc == ["ADMM gap plateau"]
    assert abs(at - jat) <= PLATEAU_SPREAD
    assert (ret, stats.iter) == (jret, jst.iter) == ("ok", 300)
    assert s.dtype == torch.float64 and s.U.cones[0].dtype == torch.float64
    assert abs(stats.pobj - jst.pobj) <= POBJ_RTOL32 * abs(jst.pobj)


# the plateau's iteration: the port's f32 ALM and ADMM trajectories part
# from lorads_tpu's by f32 summation order (263 against 264, measured)
PLATEAU_SPREAD = 2


def test_level1_reopt_escalates():
    """hand_multiblock from an f32 start with auto: ALM and ADMM both end
    short of phase2_tol at f32, so the level-1 reopt escalates first
    (lorads_tpu/alg/solver.py:1283)."""
    out = _solve_both("hand_multiblock")
    assert _same_outcome(out, POBJ_RTOL32) == ["reopt needed at f32"]
    assert out["torch"][0].dtype == torch.float64


def test_level2_reopt_escalates(monkeypatch):
    """maxcut(300, 4) from an f32 start with auto, dual_refine=False, the
    first certificate's dinf replaced by 1.0 in both packages: the
    level-2 reopt escalates (lorads_tpu/alg/solver.py:1332)."""
    calls = {}
    for pkg, cls in (("tpu", TpuSolver), ("torch", TorchSolver)):
        real = cls.dual_infeasibility
        seen = calls[pkg] = []

        def first_fails(self, *a, _real=real, _seen=seen, **k):
            v = _real(self, *a, **k)
            _seen.append(v)
            return 1.0 if len(_seen) == 1 else v
        monkeypatch.setattr(cls, "dual_infeasibility", first_fails)
    out = _solve_both("maxcut300", dual_refine=False)
    assert _same_outcome(out, POBJ_RTOL32) == ["dual reopt needed at f32"]
    # the level-2 reopt ran at f64 on the escalated data
    assert len(calls["torch"]) == len(calls["tpu"]) == 2
    assert out["torch"][0].pd.rhs.dtype == torch.float64


def test_maxcut300_f32_solve():
    """dtype="f32" (no auto) solves at f32 to the end in both packages,
    as lorads_tpu's tests/test_solver.py:333-339 runs it."""
    out = _solve_both("maxcut300", auto=False)
    assert _same_outcome(out, POBJ_RTOL32) == []
    s, res, _, lines = out["torch"]
    assert res.pinf_l1 <= 1e-5
    assert res.R.cones[0].dtype == torch.float32 == s.pd.rhs.dtype
    assert "dtype=float32" in lines[1]


def _resumed(pkg, name, path, auto=True, **kw):
    """``pkg``'s solve of ``name`` from an f32 start (with auto where
    ``auto``), its ALM phase replaced by the state of the checkpoint at
    ``path`` (either package's): (solver, result, escalation reasons, log
    lines)."""
    s, lines = _solver(pkg, name, auto, **kw)
    real, first = s.alm_phase, [True]

    def alm_phase(stats, t0, **k):
        if not first[0]:
            return real(stats, t0, **k)
        first[0] = False
        for f, v in s.load(path)["alm"].items():
            setattr(stats, f, v)
        return "ok"
    s.alm_phase = alm_phase
    res = s.solve()
    return s, res, _escalations(lines), lines


def _admm_exit(lines):
    """(iteration, pObj, pinf_l1, gap) of the last ADMM line before the
    first reopt or certificate."""
    last = None
    for ln in lines:
        if ln.startswith("ADMM Iter"):
            last = ln
        elif ln.startswith(("escalating", "******", "Dual infeas")):
            break
    f = dict(t.split(":") for t in last.replace("pInf(1)", "pinf").split()
             if t.count(":") == 1)
    return int(f["Iter"]), float(f["pObj"]), float(f["pinf"]), \
        float(f["pdGap"])


@pytest.mark.slow
def test_theta_gtoy60_f32_auto_solve(tmp_path):
    """theta_gtoy60 from an f32 start with auto (~70 s on one thread).

    The whole solves: the status, and pObj within THETA_RTOL32 of
    lorads_tpu's.  The hooks after the ALM phase, from one state:
    lorads_tpu's own at the end of its f32 ALM phase, saved as a
    checkpoint and resumed by both packages (their f32 ALM trajectories
    part from outer 2 on by summation order; tests/test_torch_f32.py
    holds the first outer).  From there the f32 ADMM phases end on the
    same iteration with pObj and pinf within THETA_ADMM_SPREAD, but the
    gap there is f32 dual noise (~rho eps32 at rho 1.8e4: 1.1e-4 in
    lorads_tpu, 3.7e-6 in the port, measured), and the level-1 reopt
    escalates on that gap.  So each package's escalations are held to
    lorads_tpu's rule (solver.py:1266-1283) on its own ADMM exit, and
    the certified pObj within THETA_RTOL32."""
    out = _solve_both("theta_gtoy60")
    (_, jr, _, _), (_, tr, _, _) = out["tpu"], out["torch"]
    assert tr.status.value == jr.status.value == "primal_dual_optimal"
    assert abs(tr.pobj - jr.pobj) <= THETA_RTOL32 * abs(jr.pobj)

    path = str(tmp_path / "post_alm.npz")
    js, lines = _solver("tpu", "theta_gtoy60")
    real, first = js.alm_phase, [True]

    def alm_then_save(stats, t0, **k):
        act = real(stats, t0, **k)
        if first[0]:
            first[0] = False
            js.save(path, stats, None, "post_alm")
        return act
    js.alm_phase = alm_then_save
    js.solve()
    got = {pkg: _resumed(pkg, "theta_gtoy60", path)
           for pkg in ("tpu", "torch")}
    tol = TorchParams().phase2_tol
    exits = {}
    for pkg, (s, res, esc, lines) in got.items():
        exits[pkg] = it, pobj, pinf, gap = _admm_exit(lines)
        level1 = gap > tol or pinf > tol
        assert esc == (["reopt needed at f32"] if level1 else []), pkg
        assert res.status.value == "primal_dual_optimal", pkg
    (ji, jp, jpi, _), (ti, tp, tpi, _) = exits["tpu"], exits["torch"]
    assert ti == ji
    assert abs(tp - jp) <= THETA_ADMM_SPREAD * abs(jp)
    assert abs(tpi - jpi) <= THETA_ADMM_SPREAD * abs(jpi)
    assert abs(got["torch"][1].pobj - got["tpu"][1].pobj) \
        <= THETA_RTOL32 * abs(got["tpu"][1].pobj)


# theta_gtoy60's certified pObj: lorads_tpu's escalated run and its f64 run
# lie 1.8e-4 apart (-24.21378 against -24.20950), the port's f32 run
# 4.4e-4 from lorads_tpu's f32 one (measured, one thread); twice that
THETA_RTOL32 = 1e-3
# the ADMM exit from lorads_tpu's post-ALM state: pObj and pinf_l1 of the
# two packages (as logged, 6 digits) lie 4e-6 and 1.6e-3 apart (measured,
# one thread); twice the larger, rounded up
THETA_ADMM_SPREAD = 5e-3


@pytest.mark.slow
def test_multiblock_lp_f32_from_the_cards_alm_exit():
    """multiblock_lp at pure f32 (lp_gauss_seidel), the rest of the solve
    resumed in both packages from the card's state at the end of its f32
    ALM phase (``python -m lorads_torch.probes.f32_parting --save``, on
    an NVIDIA H100 80GB HBM3; ~5 min here).  From the CPU's own ALM exit
    both certify it; from the card's, whose dObj lies 3e-3 away, ADMM's
    retry ends inside the gap continuation's window, the continuation
    plateaus and the f32 reopts take tau = 0: both end max_iter without
    an escalation, as the port does on the card (chip_smoke.py's
    FROM_CARD_ALM).  pObj, uncertified, within twice the measured spread
    (1.0e-4) of lorads_tpu's."""
    torch.set_num_threads(4)
    got = {pkg: _resumed(pkg, "multiblock_lp", CARD_POST_ALM, auto=False,
                         lp_gauss_seidel=True)
           for pkg in ("tpu", "torch")}
    (_, jr, je, jl), (_, tr, te, tl) = got["tpu"], got["torch"]
    assert tr.status.value == jr.status.value == "max_iter"
    assert te == je == []
    for lines in (jl, tl):
        assert any(ln.startswith("ADMM gap continuation") for ln in lines)
    assert abs(tr.pobj - jr.pobj) <= BOUND(1.0e-4) * abs(jr.pobj)


CARD_POST_ALM = FIX + "multiblock_lp_f32_card_post_alm.npz"


def test_admm_chunk_nan_is_a_numerical_error():
    """A NaN in the iterate ends the chunk with NUM_ERR on that iteration
    (the port's guard fails a NaN; lorads_tpu's comparisons pass it, and
    its chunk runs on).  multiblock_lp's f32 ADMM diverges so: pObj 6e9,
    gap 0.9933 at its fifth iteration, NaN at its sixth."""
    ts, rho, it0, (uc, ul), (vc, vl), dual = _start(
        "hand_multiblock", (("lp_gauss_seidel", True),), ("alm", 10))
    f32 = torch.float32
    U = interop.factor_from_numpy(uc, ul, f32)
    ul = ul.copy()
    ul[0] = np.nan
    V = interop.factor_from_numpy(vc, ul, f32)
    tdual = torch.as_tensor(dual)
    tl, ttot, (pobj, dobj, pinf, gap) = t_admm.admm_init_eval(
        ts.pd, U, V, tdual, 1.0)
    carry = t_admm.make_carry(
        ts.pd, U, V, tl, ttot, tdual, rho=rho, cur_rho_max=ts.rho_max,
        pinf_buf=[0.0] * 10, old_pinf_mean=1e30, bad_pd=0, it=it0,
        pinf_l1=pinf, gap=gap, pobj=pobj, dobj=dobj, best_gap=gap,
        since_best=0, best_pinf=pinf, since_pinf=0)
    c = t_admm.admm_chunk(ts.params, ts.pd, {"carry": carry}, 1.0, 100000,
                          5, jacobi=ts._bucket_jacobi, S=ts.S)
    assert c["status"] == t_admm.NUM_ERR and int(c["carry"].k) == 1
