"""lorads_torch's FIX_INI_POINT debugging mode vs lorads_tpu
(``fix_init_point``): the all-ones start and the per-step trace
(``nrm2U: %.20f`` every inner step, ``tau: %.20f`` every accepted one,
lorads_alm.c:1081-1089, 1116-1118), which the port's ALM inner loop
writes into its chunk's state and prints after each read.

The all-ones start gives every column of R the same values, and every
step keeps them equal, so the solve follows a rank-one factor from a
symmetric point.  On Max-Cut (C's rows sum to zero) the first step
lands on x = 1/sqrt(r) in every row, where the gradient is rounding
noise in both packages: the trace from there on is decided by
summation order (lorads_tpu's and the port's part at the third line, by
1e-4 on maxcut(24) and maxcut(300)), so maxcut(24) is held to
lorads_tpu's trace up to that point, and to its form and count after
it.  hand_multiblock's whole trace (24 lines) is held line for line;
its steps amplify summation order too: measured worst 1.2e-8 relative
(1e-9 holds to line 14), so 2e-8.

lorads_tpu runs on CPU at f64 (conftest); the port on CPU tensors.
"""

import re

import jax
import numpy as np
import pytest
import torch

from lorads_tpu.alg import alm as tpu_alm
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_torch.alg import alm as t_alm
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams

FIX = "tests/fixtures/"
TRACE_LINE = re.compile(r"^(nrm2U|tau): (-?\d+\.\d{20})$", re.M)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(out):
    return [(k, float(v)) for k, v in TRACE_LINE.findall(out)]


def _fix_ini_traces(problem, capfd, **kw):
    """(lorads_tpu's trace, the port's trace, the port's result)."""
    kw = dict(verbose=False, fix_init_point=True, max_alm_iter=2, **kw)
    capfd.readouterr()
    # lorads_tpu reads its flag when it traces the ALM graphs: drop the
    # graphs an earlier solve in this process left, before and after
    jax.clear_caches()
    try:
        TpuSolver(problem, TpuParams(**kw)).solve()
        jax.effects_barrier()
    finally:
        tpu_alm.TRACE_FIX_INI = False
        jax.clear_caches()
    jt = _trace(capfd.readouterr().out)
    try:
        res = TorchSolver(problem, TorchParams(**kw), device="cpu").solve()
    finally:
        t_alm.TRACE_FIX_INI = False
    tt = _trace(capfd.readouterr().out)
    return jt, tt, res


def _form(trace, res):
    """One nrm2U line per inner step of the solve, each accepted step's
    tau line right after its nrm2U line, every value finite."""
    keys = [k for k, _ in trace]
    assert keys.count("nrm2U") == res.alm_stats.inner_iter > 0
    assert keys[0] == "nrm2U"
    assert all(a == "nrm2U" for a, b in zip(keys, keys[1:]) if b == "tau")
    assert all(np.isfinite(v) for _, v in trace)


def _same_lines(got, ref, rtol):
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a == pytest.approx(b, rel=rtol)


def test_fix_ini_trace_maxcut24(capfd):
    """tests/test_solver.py's instance: the same first step (two lines)
    from the all-ones start, which lands on the symmetric point where
    the gradient is rounding noise; the trace's form and count."""
    problem = tpu_gen.maxcut(n=24, avg_degree=4, seed=2)
    jt, tt, res = _fix_ini_traces(problem, capfd, max_admm_iter=5)
    _form(tt, res)
    _same_lines(tt[:2], jt[:2], 1e-9)
    # after the first step every row of R is 1/sqrt(r) and the gradient
    # is rounding noise
    s = TorchSolver(problem, TorchParams(verbose=False,
                                         fix_init_point=True), device="cpu")
    t_alm.TRACE_FIX_INI = False
    rho, p = s.ps.rho0, s.params
    cs, g, cert = t_alm.alm_recompute(s.pd, s.R, s.dual, rho)
    R, g, _, _, info, _ = t_alm._inner_loop(
        s.pd, s.R, g, s.hist, s.dual, cs, float(cert), rho, 0.1 / rho,
        p.end_alm_sub_tol, p.end_tau_tol, p.phase1_tol, True, 1)
    X = R.cones[0].numpy()
    np.testing.assert_allclose(np.abs(X), 1 / np.sqrt(X.shape[2]),
                               rtol=1e-14)
    assert np.all(X == X[0, 0, 0])
    assert info["cert_val"] < 1e-14


def test_fix_ini_trace_hand_multiblock_line_for_line(capfd):
    problem = tpu_sdpa.read_sdpa(FIX + "hand_multiblock.dat-s")
    jt, tt, res = _fix_ini_traces(problem, capfd, max_admm_iter=5)
    _form(tt, res)
    assert len(tt) == len(jt) == 24
    _same_lines(tt, jt, 2e-8)
    _same_lines(tt[:14], jt[:14], 1e-9)


def test_fix_init_point_start_and_loop_key():
    """All-ones SDP factors and e_1 LP columns, S's LP draw after them
    (the rng stream of lorads_tpu), and the trace in the ALM loop's key:
    with it on the phase's carry holds one more tensor, the FIX_INI
    buffer of one outer's steps, and its log buffer one outer a run; the
    inner loop's state two more (the buffer and its next row)."""
    from lorads_torch.alg import devloop
    problem = tpu_sdpa.read_sdpa(FIX + "hand_multiblock.dat-s")
    try:
        js = TpuSolver(problem, TpuParams(verbose=False,
                                          fix_init_point=True))
        ts = TorchSolver(problem, TorchParams(verbose=False,
                                              fix_init_point=True),
                         device="cpu")
        assert t_alm.TRACE_FIX_INI
    finally:
        tpu_alm.TRACE_FIX_INI = t_alm.TRACE_FIX_INI = False
    for a, b in zip(ts.R.cones, js.R.cones):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.R.lp.numpy(), [1.0, 0.0])
    np.testing.assert_array_equal(ts.S.lp.numpy(), np.asarray(js.S.lp))
    p = ts.params
    stats = t_alm.ALMStats(rho=ts.ps.rho0)
    on, off = (t_alm.alm_start(ts.pd, p, ts.R, ts.dual, ts.hist, stats, 1.0,
                               False, p.alm_rho_factor, 5000,
                               1 if trace else ts.alm_max_outers,
                               p.max_alm_iter, trace)[0]
               for trace in (True, False))
    assert on.trace.shape == (t_alm.MAX_SUB_CAP + t_alm.PASS_CAP, 4)
    assert off.trace is None
    assert on.logbuf.shape == (1, t_alm.LOG_COLS)
    assert off.logbuf.shape == (ts.alm_max_outers, t_alm.LOG_COLS) \
        == (16, 10)
    (lon, kon), (loff, koff) = devloop.flatten(on), devloop.flatten(off)
    assert len(lon) == len(loff) + 1 and kon != koff
    rho = ts.ps.rho0
    cs, g, cert = t_alm.alm_recompute(ts.pd, ts.R, ts.dual, rho)
    args = (ts.pd, ts.R, g, ts.hist, ts.dual, cs, cert, rho, 0.1,
            1e-10, 1e-16, 1e-3, True, 10)
    row = torch.zeros((), dtype=torch.int64)
    inner_on = t_alm.inner_loop(*args, trace=(on.trace, row))
    inner_off = t_alm.inner_loop(*args)
    assert inner_on.key != inner_off.key
    assert inner_on.key[:-1] == inner_off.key[:-1]
    assert len(inner_on.state) == len(inner_off.state) + 2 == 13
    assert inner_off.kind(24) is True and inner_off.kind(23) is False
