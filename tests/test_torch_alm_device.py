"""lorads_torch's ALM phase as one device loop (alg/alm.py ``outer_loop``)
held to lorads_tpu's ``outer_chunk`` on the CPU, and the CGNR
(alg/dualrefine.py ``cgnr_loop``) to lorads_tpu's ``dual_ls_refine``.

The same factor, dual and history (lorads_tpu's start, carried over as
numpy arrays by ``interop``) go through one run of each package's outer
loop: lorads_tpu's jitted nested while_loops and the port's
device-decided loops, run here eagerly (the host reads each exit test).
The packed integers (k, max_sub, the counters, the exits, the outers
done, the inner steps) and the log buffer's k and inner-step columns
must be equal; the packed floats, the log buffer's other columns and the
iterates agree within rtol 1e-11 of each field's scale, or within a
bound of twice the largest spread measured between the two packages on
the CPU (x86-64, one thread), rounded up to 1, 2 or 5 times a power of
ten, stated per case (``SPREAD``).  Whole ALM phases are held to the
counts and the bits of pObj, dObj and rho that the port gave before its
ALM became one device loop (``PHASE``, recorded on the CPU with the
masked inner chunks and the host's middle and outer loops).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import alm as tpu_alm
from lorads_tpu.alg import dualrefine as tpu_refine
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_torch import device as t_dev
from lorads_torch import interop
from lorads_torch.alg import alm as t_alm
from lorads_torch.alg import devloop
from lorads_torch.alg.dualrefine import cgnr_loop, dual_ls_refine
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
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


def _problem(name):
    if name == "maxcut300":
        return tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    return tpu_sdpa.read_sdpa(FIX + name + ".dat-s")


# The largest spread between the packages over each field's scale, by
# case and group: the objectives (packed and logged pObj, dObj), the
# DIMACS values (pinf_l1, pinf_inf, gap: differences of nearly equal
# terms), the first-order values (cert, tau, the gradient: small near a
# pass's exit) and the iterates (R, the dual, A(RR^T)).  rho and the rho
# factor are equal.
SPREAD = {
    "maxcut300": dict(obj=2.67e-14, dimacs=7.63e-10, step=5.02e-10,
                      vars=1.20e-11),
    "matcomp500": dict(obj=1.10e-14, dimacs=3.91e-10, step=1.45e-10,
                       vars=2.10e-13),
    "theta_gtoy60": dict(obj=8.80e-13, dimacs=6.74e-11, step=2.39e-10,
                         vars=5.57e-13),
    "hand_multiblock": dict(obj=1.61e-14, dimacs=3.96e-13, step=4.47e-13,
                            vars=6.36e-15),
}
# case: (instance, outers a run, max_alm_iter)
CASES = {
    # the whole phase in one run (its five outers)
    "maxcut300": ("maxcut300", 16, 200),
    # the general sparse path (K3p, K4, K5) to the phase's end
    "matcomp500": ("matcomp500", 16, 200),
    # the dense path; stopped after 8 outers (the run's limit), before
    # the grind where summation order parts the packages
    "theta_gtoy60": ("theta_gtoy60", 8, 200),
    # two blocks and an LP block; the k budget ends the phase (O_KMAX)
    "hand_multiblock": ("hand_multiblock", 16, 2),
}


def BOUND(reading):
    """Twice ``reading``, rounded up to 1, 2 or 5 times a power of ten;
    at least 1e-11."""
    if reading <= 5e-12:
        return 1e-11
    e = 10.0 ** np.floor(np.log10(2 * reading))
    return next(m * e for m in (1, 2, 5, 10) if m * e >= 2 * reading)


def _rel(got, want):
    """|got - want| over the largest |want| (0 where both are 0)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    diff = np.abs(got - want).max() if want.size else 0.0
    return diff / scale if scale else diff


def _both_runs(case):
    """(lorads_tpu's outer_chunk output as numpy, the port's pack and
    carry) of one run from lorads_tpu's start."""
    name, outers, max_alm_iter = CASES[case]
    problem = _problem(name)
    js = TpuSolver(problem, TpuParams(verbose=False))
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    p, jp = ts.params, js.params
    assert p.alm_rho_factor == jp.alm_rho_factor
    rho = js.ps.rho0
    # lorads_tpu's start, carried over
    st = interop.state_from_numpy(
        R=js.R, dual=np.asarray(js.dual), hist=js.hist)
    jcs, jg, jcert = tpu_alm.alm_recompute(js.pd, js.R, js.dual, rho)
    dt = jnp.float64
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    out = tpu_alm.outer_chunk(
        js.pd, js.R, jg, js.hist, js.dual, jcs, jcert, jnp.asarray(rho, dt),
        jnp.asarray(jp.alm_rho_factor, dt), i32(0), i32(0), i32(0),
        i32(max_alm_iter), i32(5000), i32(0), i32(0),
        i32(jp.rank_flag_thres), jnp.asarray(bool(js.is_rank_max())),
        i32(1), jnp.asarray(1e30, dt), jnp.asarray(1e30, dt),
        jnp.asarray(1e30, dt), jnp.asarray(1e30, dt), jnp.asarray(1.0, dt),
        jnp.asarray(jp.end_alm_sub_tol, dt), jnp.asarray(jp.end_tau_tol, dt),
        jnp.asarray(jp.phase1_tol, dt), jnp.asarray(jp.phase2_tol, dt),
        high_acc_mode=jp.high_acc_mode, max_outers=outers)
    out = jax.device_get(out)

    carry, fixed = t_alm.alm_start(
        ts.pd, p, st["R"], st["dual"], st["hist"], t_alm.ALMStats(rho=rho),
        1.0, ts.is_rank_max(), p.alm_rho_factor, 5000, outers,
        max_alm_iter)
    loop = t_alm.outer_loop(ts.pd, t_alm.ALMInputs(
        budget=torch.tensor(2 ** 30), grind_armed=torch.tensor(False),
        **fixed), carry, high_acc_mode=p.high_acc_mode)
    got, pack = devloop.run(loop)
    return out, pack, got


GROUPS = {"obj": ("pobj", "dobj"), "dimacs": ("pinf_l1", "pinf_inf", "gap"),
          "step": ("cert_val", "tau"), "exact": ("rho", "rho_factor")}
# the log buffer's columns after k and the inner steps
LOGGED = ("pobj", "dobj", "pinf_l1", "pinf_inf", "gap", "rho")


def _spreads(out, pack, got):
    """(outers done, the packs' integers, the logged counts, each group's
    spread) of the two runs."""
    nf, ni = len(t_alm.PACK_F), len(t_alm.PACK_I)
    jpk = np.asarray(out["packed"], np.float64)
    n = int(pack[nf + t_alm.PACK_I.index("n_done")])
    jlog = jpk[nf + ni:].reshape(-1, tpu_alm.LOG_COLS)[:n]
    tlog = np.asarray(pack[nf + ni:]).reshape(-1, t_alm.LOG_COLS)[:n]
    ints = (list(pack[nf:nf + ni]), list(jpk[nf:nf + ni]))
    counts = (tlog[:, :2].tolist(), jlog[:, :2].tolist())
    field = {f: _rel(pack[i], jpk[i]) for i, f in enumerate(t_alm.PACK_F)}
    for c, f in enumerate(LOGGED, start=2):
        field[f] = max(field[f], _rel(tlog[:, c], jlog[:, c]))
    spread = {g: max(field[f] for f in fs) for g, fs in GROUPS.items()}
    spread["step"] = max(spread["step"], _rel(got.grad.cones[0].numpy(),
                                              out["grad"].cones[0]))
    pairs = [(a, b) for a, b in zip(got.R.cones, out["R"].cones)]
    pairs += [(got.R.lp, out["R"].lp), (got.dual, out["dual"]),
              (got.constr_sum, out["constr_sum"])]
    spread["vars"] = max(_rel(a.numpy(), b) for a, b in pairs)
    return n, ints, counts, spread


@pytest.mark.parametrize("case", sorted(CASES))
def test_outer_loop_matches_lorads_tpu(case):
    out, pack, got = _both_runs(case)
    n, ints, counts, spread = _spreads(out, pack, got)
    assert ints[0] == ints[1]
    assert counts[0] == counts[1] and n > 0
    assert spread.pop("exact") == 0.0
    for group, reading in SPREAD[case].items():
        assert spread[group] <= BOUND(reading), (group, spread[group])
    oexit = ints[0][t_alm.PACK_I.index("oexit")]
    if case == "theta_gtoy60":
        assert n == 8 and oexit == t_alm.O_LIMIT
    elif case == "hand_multiblock":
        assert oexit == t_alm.O_KMAX
    else:
        assert oexit == t_alm.O_DONE


# The port's ALM phase before it became one device loop (CPU, one
# thread): action, outers, inner steps, and the bits of pObj, dObj, rho.
PHASE = {
    "maxcut300": ("done", 5, 103, "-0x1.f8abc1b9d1642p+8",
                  "-0x1.f897cb2e54f8cp+8", "0x1.c0f293e7300d2p+3"),
    "matcomp500": ("done", 6, 40, "0x1.79a2280cf8ad2p+11",
                   "0x1.79a4c32db2094p+11", "0x1.030dc4ea03a72p+1"),
    "hand_multiblock": ("done", 4, 11, "0x1.c1012210cb3e8p-3",
                        "0x1.dc13d9d2a6272p-3", "0x1.c9f25c5bfedd9p+2"),
    "mc_gtoy60": ("done", 6, 51, "-0x1.907ee35f20cfcp+6",
                  "-0x1.90cf6252a5396p+6", "0x1.08654a2d4f6dap+3"),
}


@pytest.mark.parametrize("name", sorted(PHASE))
def test_alm_phase_counts_and_bits(name):
    """A whole ALM phase through the solver (runs of 16 outers): the
    counts and the bits of the parent's host-driven loops; every ALM
    read labelled alm or alm_inner (on the CPU: an exit test a step, one
    pack a run)."""
    ts = TorchSolver(_problem(name), TorchParams(verbose=False),
                     device="cpu")
    stats = t_alm.ALMStats(rho=ts.ps.rho0)
    t_dev.reset_host_syncs()
    action = ts.alm_phase(stats, time.time())
    got = (action, stats.outer_iter, stats.inner_iter, stats.pobj.hex(),
           stats.dobj.hex(), stats.rho.hex())
    assert got == PHASE[name]
    by = {k: v for k, v in t_dev.HOST_SYNCS_BY.items() if v}
    assert set(by) == {"alm", "alm_inner"}
    # one exit test an inner step and one at each pass's end
    assert by["alm_inner"] > stats.inner_iter


def test_cgnr_matches_lorads_tpu():
    """The CGNR from maxcut300's start with a seeded dual (it converges
    in 11 iterations): the step, both LS norms and the count, and one
    pack read a run."""
    problem = _problem("maxcut300")
    js = TpuSolver(problem, TpuParams(verbose=False))
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    dual = 0.1 * np.random.default_rng(7).standard_normal(problem.m)
    n_iter = 12
    jstep, jls0, jls1 = (np.asarray(a) for a in jax.device_get(
        tpu_refine.dual_ls_refine(js.pd, js.R, jnp.asarray(dual), n_iter)))
    st = interop.state_from_numpy(R=js.R, dual=dual)
    t_dev.reset_host_syncs()
    step, ls0, ls1, its = dual_ls_refine(ts.pd, st["R"], st["dual"], n_iter)
    # the exit test before each iteration and after the last, one pack
    assert t_dev.HOST_SYNCS_BY["repair"] == its + 2 == 13
    assert ls0 == pytest.approx(float(jls0), rel=1e-12)
    assert ls1 == pytest.approx(float(jls1), rel=1e-10)
    assert _rel(step.numpy(), jstep) <= 1e-10
    # the loop's pack: (iterations, ls0, ls1)
    loop = cgnr_loop(ts.pd, st["R"], st["dual"], 3)
    state, pack = devloop.run(loop)
    assert pack[0] == 3 and pack[1] == ls0
    assert not bool(loop.running(loop.inputs, state))
