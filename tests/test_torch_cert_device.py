"""The certificate's restarted Lanczos and the spectral repair's active set
as device-decided loops (alg/lanczos.py, alg/spectral_repair.py,
alg/devloop.py), on the CPU.

On CPU tensors both loops run their steps eagerly, the host reading the
exit test before each step, and kernel K9 (``kernels.sym_eig_small``)
takes its plain version, torch.linalg.eigh; the step solve is
torch.linalg.solve_ex.  Checked here:

* the certificate's eigenvalues, restart counts and Ritz vectors, and the
  repair's rounds, active-set runs (constraints, iterations, step) and
  final dual, bit for bit against the values the port gave before the two
  loops became device loops (``PARENT``: its host-driven loops with
  torch.linalg.eigh and torch.linalg.solve, run on this machine's CPU),
  at the states in tests/fixtures/cert_states.npz (each the dual a CPU
  solve of the port certified or repaired: maxcut2000, theta_gtoy60,
  four maxcut(300) merged into one bucket of B = 4);
* the Lanczos loop against lorads_tpu's ``lanczos_min_eig_device`` on the
  same operator, start and dual: at f64 (no refinement) and at f32 with
  the f64 Rayleigh refinement (the solver's path), on K2's r = 1 matvec
  (maxcut2000), the dense matvec (theta_gtoy60, ``_DENSE_EIG_DIM``
  lowered) and B = 4: equal restart counts, eigenvalues within
  LAM_RTOL (both packages sum the matvec in another order, which the
  restarts amplify where the lowest eigenvalues cluster);
* the host reads of the CPU path: the exit test before each restart or
  iteration and one pack read a run, under the loop's label, and none
  labelled ``other`` for a Lanczos bucket;
* K9's plain version's contract (ascending eigenvalues, column j the
  eigenvector of eigenvalue j, the lower triangle read) against numpy,
  and the wrapper's shape checks; devloop.repeat on the CPU.

One intra-op thread (the test workers share the cores).
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg import solver as tpu_solver
from lorads_tpu.alg.lanczos import lanczos_min_eig_device as tpu_lanczos
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.core.problem import merge_problems as tpu_merge
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_tpu.ops import pattern as tpu_pat
from lorads_torch import device as t_dev
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import devloop
from lorads_torch.alg import solver as t_solver
from lorads_torch.alg import spectral_repair as t_repair
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.lanczos import lanczos_min_eig_device
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as t_pat

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
STATES = np.load(os.path.join(FIX, "cert_states.npz"))

# the Lanczos certificates at the fixture states: (lambda_min per block
# as float.hex, restarts, sha256 of the unit Ritz vectors' bytes, first 16
# hex digits), from the port before the loops became device loops
PARENT = {
    "maxcut2000": (["-0x1.35f49701fe3f7p-10"], 12, "42838fb3ae2072b4"),
    "theta_gtoy60": (["-0x1.28b157671977cp+0"], 1, "38555104d31629e5"),
    "maxcut300x4": (["-0x1.3bf59c13b8617p-12", "-0x1.593c01ccd0918p-13",
                     "-0x1.4d05c9b3f51e4p-11", "-0x1.d241d8937842dp-12"],
                    17, "75629448e887d6e4"),
}
# theta_gtoy60's spectral repair from its fixture state, as the port ran
# it before: accepted, rounds, dinf after (hex), each active-set run's
# (constraints, iterations, sha256 of the step's bytes), the final dual's
# sha256 and dObj (hex)
PARENT_REPAIR = (True, 4, "0x1.fd6fb2938fc29p-17",
                 [(76, 12, "e710d150bc31e094"), (63, 12, "cc168552e8d6b8ac"),
                  (69, 12, "d8e811facf3729de")],
                 "a4436ef74abd88e2", "-0x1.835cbe5108b8ep+4")
# the seeds of each case's start vectors
SEED = {"maxcut2000": 21, "theta_gtoy60": 14, "maxcut300x4": 5}
# eigenvalues against lorads_tpu's on the same operator, relative, by
# case: the two sum the matvec in another order, and the restarts amplify
# that where the lowest eigenvalues cluster (a Max-Cut slack at its
# optimum).  Measured (f64 loop, f32 loop with the f64 refinement):
# theta_gtoy60 4e-15 and 2.3e-10 (one restart), maxcut2000 4.0e-6 and
# 1.2e-6 (12 restarts), maxcut300x4 9.8e-5 and 2.2e-4 (17 restarts, the
# cap; blocks near 0).  Each bound is 4-10x its measure and inside the
# loop's own tol 1e-2.
LAM_RTOL = {"theta_gtoy60": 1e-9, "maxcut2000": 2e-5, "maxcut300x4": 1e-3}


def _digest(t):
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _problem(name, tpu=False):
    gen = tpu_gen if tpu else None
    if name == "maxcut300x4":
        if tpu:
            return tpu_merge([gen.maxcut(n=300, avg_degree=4, seed=s)
                              for s in (3, 4, 5, 6)])
        from lorads_torch.core.problem import merge_problems
        from lorads_torch.io import generators
        return merge_problems([generators.maxcut(n=300, avg_degree=4, seed=s)
                               for s in (3, 4, 5, 6)])
    path = os.path.join(FIX, f"{name}.dat-s")
    if tpu:
        return tpu_sdpa.read_sdpa(path)
    from lorads_torch.io.sdpa import read_sdpa
    return read_sdpa(path)


def _dense_dim(name):
    """``_DENSE_EIG_DIM`` that sends the case's bucket to Lanczos."""
    return {"maxcut2000": 1024, "theta_gtoy60": 59, "maxcut300x4": 299}[name]


def _case(name, monkeypatch):
    """(port ProblemData, dual [m], start vectors per bucket) of a case,
    the bucket sent to Lanczos."""
    monkeypatch.setattr(t_solver, "_DENSE_EIG_DIM", _dense_dim(name))
    ps = tpu_presolve.presolve(_problem(name, tpu=True), TpuParams())
    pd = t_aop.build_problem_data(ps, torch.float64, "cpu")
    rng = np.random.default_rng(SEED[name])
    v0s = [torch.as_tensor(rng.standard_normal((bk.B, bk.n)))
           for bk in pd.buckets]
    return ps, pd, torch.as_tensor(STATES[f"{name}_dual"]), v0s


@pytest.mark.parametrize("name", sorted(PARENT))
def test_certificate_matches_parent_bit_for_bit(name, monkeypatch):
    """The certificate at the fixture state: eigenvalues, restarts and
    Ritz vectors equal the parent's bit for bit; its host reads are the
    Lanczos loop's (an exit test a restart, one more, one pack read), none
    labelled ``other``."""
    _, pd, dual, v0s = _case(name, monkeypatch)
    t_dev.reset_host_syncs()
    lams, restarts, vecs, lams_k = t_solver._dual_infeas_device(pd, dual, v0s)
    lam_hex, its, vec_digest = PARENT[name]
    assert [float(x).hex() for x in lams[0]] == lam_hex
    assert restarts == [its]
    assert _digest(vecs[0]) == vec_digest
    assert lams_k[0][:, 0].tolist() == lams[0].tolist()
    by = {k: v for k, v in t_dev.HOST_SYNCS_BY.items() if v}
    assert by == {"lanczos": its + 2}


def _tpu_operator(ps, name, dual, dtype):
    """lorads_tpu's (matvec, matvec_hi or None, ws) of the case's bucket
    at ``dtype`` (f32: the f32 cast with the f64 operator as matvec_hi,
    as its certificate runs)."""
    jpd = tpu_aop.build_problem_data(ps, jnp.float64)
    bk = jpd.buckets[0]
    w_loc = tpu_pat.gather_w(bk, -jnp.asarray(dual.numpy()))
    kind, op, ws = tpu_solver._slack_operator(bk, w_loc)
    assert kind == "lanczos"
    if dtype == torch.float64:
        return op, None, ws
    _, op32, _ = tpu_solver._slack_operator(tpu_pat.cast_floats(bk),
                                            w_loc.astype(jnp.float32))
    return op32, op, ws


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(PARENT))
def test_lanczos_loop_matches_lorads_tpu(name, dtype, monkeypatch):
    """The Lanczos loop against lorads_tpu's lanczos_min_eig_device on
    the same normalized slack, start and dual: equal restarts, lambda_min
    (times ws) within LAM_RTOL."""
    ps, pd, dual, v0s = _case(name, monkeypatch)
    monkeypatch.setattr(tpu_solver, "_DENSE_EIG_DIM", _dense_dim(name))
    bk = pd.buckets[0]
    w_loc = t_pat.gather_w(bk, -dual)
    kind, (mv, ops), ws = t_solver._slack_operator(bk, w_loc)
    assert kind == "lanczos"
    jmv, jhi, jws = _tpu_operator(ps, name, dual, dtype)
    v0 = v0s[0]
    if dtype == torch.float64:
        lam, its = lanczos_min_eig_device(mv, v0, ops=ops, scale=ws)
        jlam, jits = tpu_lanczos(jmv, jnp.asarray(v0.numpy()))
    else:
        lo = t_solver._f32_bucket(bk)
        _, (mv32, ops32), _ = t_solver._slack_operator(
            lo, w_loc.to(torch.float32))
        lam, its = lanczos_min_eig_device(
            mv32, v0.to(torch.float32), matvec_hi=mv, ops=ops32,
            ops_hi=ops, scale=ws)
        jlam, jits = tpu_lanczos(jmv, jnp.asarray(v0.numpy(), jnp.float32),
                                 matvec_hi=jhi)
    jlam = np.asarray(jlam, np.float64) * np.asarray(jws, np.float64)
    assert its == int(jits) >= 1
    np.testing.assert_allclose(lam, jlam, rtol=LAM_RTOL[name], atol=0)


def _repair_solver():
    """The port's theta_gtoy60 solver on the CPU at the fixture state
    (the dual its CPU solve reached just before the dual refinement)."""
    st = {k: STATES["theta_gtoy60_" + k] for k in ("dual", "scale", "pobj",
                                                   "dobj", "gap", "dinf")}
    ts = TorchSolver(_problem("theta_gtoy60"), TorchParams(verbose=False),
                     device="cpu")
    ts.pd = t_aop.scale_objective(ts.pd, float(st["scale"]))
    ts.scale_obj_his = float(st["scale"])
    ts.dual = torch.as_tensor(st["dual"])
    ts.pobj, ts.dobj, ts.gap = (float(st[k]) for k in ("pobj", "dobj", "gap"))
    stats = ADMMStats(rho=1.0, dobj=float(st["dobj"]), gap=float(st["gap"]),
                      dinf_l1=float(st["dinf"]))
    return ts, stats


def test_repair_matches_parent_bit_for_bit(monkeypatch):
    """theta_gtoy60's spectral repair from the fixture state: accepted in
    the parent's rounds, each active-set run's constraints, iterations
    and step, the final dual and dObj bit for bit; each active-set run
    reads the host before each iteration, once more, and once for its
    pack (label ``repair``)."""
    ts, stats = _repair_solver()
    runs, run = [], t_repair._active_set

    def kept(*a, **k):
        before = t_dev.HOST_SYNCS_BY["repair"]
        d, n, it = run(*a, **k)
        runs.append((n, it, _digest(d)))
        assert t_dev.HOST_SYNCS_BY["repair"] - before == it + 2
        return d, n, it

    monkeypatch.setattr(t_repair, "_active_set", kept)
    accepted = t_repair.try_spectral_repair(ts, stats)
    info = ts.spectral_repair_info
    got = (accepted, info["rounds"], info["dinf_after"].hex(), runs,
           _digest(ts.dual), stats.dobj.hex())
    assert got == PARENT_REPAIR


def test_active_set_loop_pack_and_state():
    """One active-set run: its pack [d_tot | constraints | iterations]
    agrees with its final state, the exit test is false at the end, and
    the inputs delta and sigma are 0-d tensors (a graph would freeze a
    number)."""
    ts, _ = _repair_solver()
    bk = ts.pd.buckets[0]
    rng = np.random.default_rng(2)
    Bm, _ = np.linalg.qr(rng.standard_normal((bk.n, 6)))
    Bmat = torch.zeros((1, bk.n, t_repair.P_CAP), dtype=torch.float64)
    Bmat[0, :, :6] = torch.as_tensor(Bm)
    pm = torch.zeros((1, t_repair.P_CAP), dtype=torch.float64)
    pm[0, :6] = 1.0
    loop = t_repair.active_set_loop(bk, Bmat, pm, ts.dual, ts.pd.rhs, 0.5,
                                    1e-2)
    assert all(t.dim() == 0 for t in loop.inputs[4:])
    state, out = devloop.run(loop)
    m = ts.pd.m
    assert out[:m] == state.d_tot.tolist()
    assert out[m] == float(state.rv.sum()) and out[m + 1] == int(state.it)
    assert 1 <= out[m + 1] <= t_repair.N_ITERS
    assert not bool(loop.running(loop.inputs, state))
    # a b-orthogonal step leaves dObj alone
    assert abs(float(torch.dot(ts.pd.rhs, state.d_tot))) <= 1e-9 * float(
        state.d_tot.abs().max() * ts.pd.rhs.abs().sum() + 1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 12, 36, 48, 64])
def test_sym_eig_small_plain_contract(n, dtype):
    """K9's plain version on CPU tensors, [B=3, n, n]: eigenvalues
    ascending and equal to numpy's eigh of the lower triangle (within
    8 n eps ||A||), column j the eigenvector of eigenvalue j (residual
    within 8 n eps ||A||), orthonormal columns; no launch counted."""
    rng = np.random.default_rng(n)
    X = rng.standard_normal((3, n, n))
    A = torch.as_tensor(X, dtype=dtype)
    before = kernels.LAUNCHES["sym_eig_small"]
    w, V = kernels.sym_eig_small(A)
    assert kernels.LAUNCHES["sym_eig_small"] == before
    assert w.shape == (3, n) and V.shape == (3, n, n) and w.dtype == dtype
    low = np.tril(X) + np.swapaxes(np.tril(X, -1), 1, 2)
    wn = np.linalg.eigvalsh(low)
    ne = 8 * n * float(torch.finfo(dtype).eps)
    scale = np.abs(wn).max(axis=1, keepdims=True)
    assert np.all(np.diff(w.numpy(), axis=1) >= 0)
    assert np.all(np.abs(w.numpy() - wn) <= ne * scale)
    Vd, wd = V.double().numpy(), w.double().numpy()
    res = np.linalg.norm(low @ Vd - Vd * wd[:, None, :], axis=1)
    assert np.all(res <= ne * scale)
    eye = np.eye(n)
    assert np.abs(np.swapaxes(Vd, 1, 2) @ Vd - eye).max() <= ne


@pytest.mark.parametrize("shape", [(3, 0, 0), (2, 65, 65), (2, 4, 5),
                                   (4, 4)])
def test_sym_eig_small_rejects_shapes(shape):
    with pytest.raises(ValueError):
        kernels.sym_eig_small(torch.zeros(shape))


def _sym_eig_case(case, n, dtype, rng):
    """[3, n, n] inputs of K9's masked and decoupled cases: ``masked`` the
    repair's projected slack built as spectral_repair.py:179-188 builds it
    (a symmetric P masked to the real basis width, big = delta + |delta| +
    1 on the padded diagonal, delta = 0.5), at real widths 1, n // 2 and
    n; ``decoupled`` a symmetric matrix whose rows 0, n // 2 and n - 1 have
    exactly-zero off-diagonal entries, their diagonal row 1's (Lanczos
    breakdown slots re-pointed at alpha_0) -> (A, decoupled indices)."""
    X = rng.standard_normal((3, n, n))
    A = X + np.swapaxes(X, 1, 2)
    if case == "masked":
        big = 0.5 + abs(0.5) + 1.0
        out = np.empty_like(A)
        for b, pw in enumerate((1, n // 2, n)):
            m = (np.arange(n) < pw).astype(float)
            m2 = m[:, None] * m[None, :]
            out[b] = A[b] * m2 + big * (1.0 - m2) * np.eye(n)
        return torch.as_tensor(out, dtype=dtype)
    for i in {0, n // 2, n - 1}:
        d = A[:, 1, 1].copy()
        A[:, i, :] = 0.0
        A[:, :, i] = 0.0
        A[:, i, i] = d
    return torch.as_tensor(A, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [2, 12, 36, 48, 64])
@pytest.mark.parametrize("case", ["masked", "decoupled"])
def test_sym_eig_small_plain_masked_and_decoupled(case, n, dtype):
    """K9's plain version (CPU tensors) on the masked and decoupled cases:
    eigenvalues ascending and equal to numpy's eigh within 8 n eps ||A||,
    residuals within 8 n eps ||A||, orthonormal columns, no launch; each
    decoupled index's diagonal is an eigenvalue within 8 n eps ||A||."""
    A = _sym_eig_case(case, n, dtype, np.random.default_rng(n))
    before = kernels.LAUNCHES["sym_eig_small"]
    w, V = kernels.sym_eig_small(A)
    assert kernels.LAUNCHES["sym_eig_small"] == before
    Ad = A.double().numpy()
    wn = np.linalg.eigvalsh(Ad)
    ne = 8 * n * float(torch.finfo(dtype).eps)
    scale = np.abs(wn).max(axis=1, keepdims=True)
    wd, Vd = w.double().numpy(), V.double().numpy()
    assert np.all(np.diff(wd, axis=1) >= 0)
    assert np.all(np.abs(wd - wn) <= ne * scale)
    res = np.linalg.norm(Ad @ Vd - Vd * wd[:, None, :], axis=1)
    assert np.all(res <= ne * scale)
    assert np.abs(np.swapaxes(Vd, 1, 2) @ Vd - np.eye(n)).max() <= ne
    off = np.abs(np.tril(Ad, -1)) > 0
    free = ~(off.any(axis=1) | off.any(axis=2))
    for b, i in zip(*np.nonzero(free)):
        assert np.abs(wd[b] - Ad[b, i, i]).min() <= ne * scale[b, 0]


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(FIX), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_sym_eig_shapes_and_rounds():
    """chip_smoke's seeded K9 shapes and what it counts for them: the
    masked slack couples its 24 real indices, its padded diagonal is big
    = 2 with exactly zero coupling; the decoupled matrix couples all but
    rows 0, 17 and 35, whose off-diagonal entries are exactly zero; the
    operation count runs M - 1 rounds a sweep over the coupled count M
    padded to even (33 -> 34: 33 rounds), not n - 1."""
    cs = _chip_smoke()
    shapes = cs.sym_eig_shapes("cpu")
    masked = shapes["masked width 24"]
    free = shapes["decoupled rows 0, 17, 35"]
    assert masked.shape == (1, 48, 48) and masked.dtype == torch.float64
    assert free.shape == (1, 36, 36) and free.dtype == torch.float32
    assert cs._coupled(masked).tolist() == [24]
    assert cs._coupled(free).tolist() == [33]
    pad = masked[0, 24:, :]
    assert torch.equal(pad[:, 24:], 2.0 * torch.eye(24, dtype=torch.float64))
    assert not bool(pad[:, :24].any())
    for i in (0, 17, 35):
        row = free[0, i].clone()
        row[i] = 0
        assert not bool(row.any()) and not bool(free[0, :, i].ne(0).sum() > 1)
    h = 17
    one_sweep = 33 * (12 * h * (h - 1) + 4 * h + 6 * 34 * h) + 2 * 34 * 34
    assert cs._jacobi_flops(1, 34) == one_sweep
    assert cs._jacobi_flops(6, 34) == 6 * one_sweep


def test_k9_phases_finds_its_points():
    """The K9 phase probe (lorads_torch/probes/k9_phases.py) finds every
    point it instruments in csrc/sym_eig.cu: each copy holds its stamps
    once, the fixed-sweep copies stop at 6 sweeps instead of K9's rule,
    and the two ablations keep one side of the round each."""
    from lorads_torch.probes import k9_phases
    v = k9_phases.variants()
    assert set(v) == {"as is", "6 sweeps", "warp 0 alone", "updaters alone"}
    for name, src in v.items():
        assert src.count("clock64()") == 7 and "lt_k9_probe_read" in src
        assert ("if (!(off > stop)) break;" in src) == (name == "as is")
        assert ("if (sweep >= 6) break;" in src) == (name != "as is")
    assert "// A's blocks" not in v["warp 0 alone"]
    assert "// the next round's rotations" in v["warp 0 alone"]
    assert "// the next round's rotations" not in v["updaters alone"]
    assert "// A's blocks" in v["updaters alone"]


def test_step_solve_ex_equals_solve():
    """The active set's f32 step solve: torch.linalg.solve_ex (no host
    check) gives torch.linalg.solve's bits on CPU tensors, so the repair
    keeps the parent's arithmetic."""
    rng = np.random.default_rng(4)
    G = rng.standard_normal((144, 300))
    M = torch.as_tensor(G @ G.T + 3.0 * np.eye(144), dtype=torch.float32)
    t = torch.as_tensor(rng.standard_normal(144), dtype=torch.float32)
    got, info = torch.linalg.solve_ex(M, t)
    assert int(info) == 0
    assert torch.equal(got, torch.linalg.solve(M, t))


def test_repeat_runs_count_steps_without_reads():
    """devloop.repeat on CPU tensors: the step ``count`` times with j =
    0, 1, ..., no host read; the count's rows written through j."""
    t_dev.reset_host_syncs()
    rows = torch.zeros((5, 3))

    def step(inp, st, j):
        x, rows = st
        rows.index_copy_(0, j.reshape(1), (x * inp[0])[None])
        return (x + 1, rows)

    x, rows = devloop.repeat(step, (torch.full((3,), 2.0),),
                             (torch.zeros(3), rows), 5)
    assert t_dev.HOST_SYNCS == 0
    assert torch.equal(x, torch.full((3,), 5.0))
    assert torch.equal(rows[:, 0], torch.tensor([0.0, 2.0, 4.0, 6.0, 8.0]))
