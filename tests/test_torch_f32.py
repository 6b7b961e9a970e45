"""lorads_torch at f32 and its escalation to f64, held to lorads_tpu on
the CPU.

``LoradsParams(dtype="f32")`` runs the port at float32 throughout;
``dtype="auto"`` starts at float64 in both packages on the CPU, and a
solve started at f32 with ``_auto_dtype`` set (lorads_tpu's own CPU
tests reach its escalation so, tests/test_robustness.py:52-54) escalates
at lorads_tpu's hooks.  The same numpy inputs go through both packages:

* the f32 ProblemData field by field, bit for bit, and the solver's
  per-(presolve, dtype) memo;
* the line search at f32 (``alm_line_search``): the same quartic
  coefficients through each package's cubic at f32.  The normalized
  cubic is ill-conditioned where a root is small beside the others, and
  XLA and torch round its chain differently, so tau is held to the f64
  tau of the same inputs: the port's f32 error at most FLOOR32 plus
  LS_FACTOR times lorads_tpu's in each of 64 seeded cases;
* one ALM run at f32 (``outer_loop`` against ``outer_chunk``): the
  counts equal, the floats within twice the spread measured between the
  packages on the CPU (x86-64, one thread), rounded up to 1, 2 or 5
  times a power of ten, per case and group (``SPREAD32``);
* ``maybe_escalate_f64``'s state after the call, against lorads_tpu's;
* f32 checkpoints read both ways, and across an escalation;
* the f32 CG budget (24000, lorads_tpu/alg/admm.py:504);
* the preemptive escalation at ADMM entry, a twin of
  tests/test_robustness.py:42-60 run in both packages.

The ADMM chunk at f32, the other escalation hooks and whole f32 solves
are in tests/test_torch_f32_solve.py.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import alm as tpu_alm
from lorads_tpu.alg import aop as tpu_aop
from lorads_tpu.alg import linesearch as tpu_ls
from lorads_tpu.alg.solver import ADMMStats as TpuADMMStats
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.alg.state import FactorVec as TpuFV
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_torch import device as t_dev
from lorads_torch import interop
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import alm as t_alm
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg import devloop
from lorads_torch.alg import linesearch as t_ls
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.alm import ALMStats
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.alg.state import FactorVec as TorchFV
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.ops import lp as t_lp
from lorads_torch.ops import pattern as t_pat

FIX = "tests/fixtures/"
EPS32 = float(np.finfo(np.float32).eps)


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


def _rel(got, want):
    """|got - want| over the largest |want| (0 where both are 0)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    diff = np.abs(got - want).max() if want.size else 0.0
    return diff / scale if scale else diff


# ---------------------------------------------------------------------------
# dtype and ProblemData.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,want", [("auto", torch.float64),
                                       ("f64", torch.float64),
                                       ("f32", torch.float32)])
def test_resolve_dtype(name, want):
    assert t_dev.resolve_dtype(name) is want
    s = TorchSolver(tpu_gen.maxcut(n=40, avg_degree=4, seed=1),
                    TorchParams(verbose=False, dtype=name), device="cpu")
    assert s.dtype is want and s.pd.rhs.dtype is want
    assert s.R.cones[0].dtype is want and s.dual.dtype is want
    assert s._auto_dtype == (name == "auto")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_dev.resolve_dtype("bf16")


def _same_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), what)


@pytest.mark.parametrize("name", ["maxcut300", "matcomp500", "theta_gtoy60",
                                  "hand_multiblock"])
def test_problem_data_f32_bit_for_bit(name):
    """Every field lorads_tpu's f32 ProblemData holds, bit for bit; every
    float tensor of the port's (its own fields too) at f32."""
    problem = _problem(name)
    ps = tpu_presolve.presolve(problem, TpuParams())
    jpd = tpu_aop.build_problem_data(ps, jnp.float32)
    tpd = t_aop.build_problem_data(ps, torch.float32, "cpu")
    _same_bits(tpd.rhs.numpy(), jpd.rhs, "rhs")
    for f in ("m", "c_nrm1", "c_nrm2", "c_nrm_inf", "b_nrm1", "b_nrm2",
              "b_nrm_inf"):
        assert getattr(tpd, f) == getattr(jpd, f), f
    assert len(tpd.buckets) == len(jpd.buckets)
    for tbk, jbk in zip(tpd.buckets, jpd.buckets):
        if tbk.dense:
            meta = t_pat.DENSE_META_FIELDS
            fields = t_pat.DENSE_FIELDS + (t_pat.DENSE_DD_FIELDS
                                           if tbk.a_single_dense else ())
        else:
            meta = tuple(f for f in t_pat.META_FIELDS if f != "Ks")
            fields = t_pat.INT_FIELDS + t_pat.FLOAT_FIELDS
        for f in meta:
            assert getattr(tbk, f) == getattr(jbk, f), f
        for f in fields:
            _same_bits(getattr(tbk, f).numpy(), getattr(jbk, f), f)
        for t in vars(tbk).values():
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                assert t.dtype == torch.float32
        # interop builds the same bucket from lorads_tpu's arrays
        ibk = interop.bucket_from_numpy(jbk, torch.float32)
        for f in fields:
            _same_bits(getattr(ibk, f).numpy(), getattr(tbk, f).numpy(), f)
    assert (tpd.lp is None) == (jpd.lp is None)
    if tpd.lp is not None:
        for f in t_lp.LP_INT_FIELDS + t_lp.LP_FLOAT_FIELDS:
            _same_bits(getattr(tpd.lp, f).numpy(), getattr(jpd.lp, f), f)
        assert tpd.lp.obj.dtype == torch.float32


def test_problem_data_memo_per_dtype():
    """The solver's ProblemData is memoized per (presolve, dtype); the f64
    data come from the presolve, bit for bit a fresh f64 build, not the
    f32 cast widened."""
    s = TorchSolver(_problem("matcomp500"),
                    TorchParams(verbose=False, dtype="f32"), device="cpu")
    assert s._problem_data(torch.float32) is s.pd
    pd64 = s._problem_data(torch.float64)
    assert s._problem_data(torch.float64) is pd64
    fresh = t_aop.build_problem_data(s.ps, torch.float64, "cpu")
    bk, bk32, ref = pd64.buckets[0], s.pd.buckets[0], fresh.buckets[0]
    for f in t_pat.FLOAT_FIELDS:
        _same_bits(getattr(bk, f).numpy(), getattr(ref, f).numpy(), f)
    _same_bits(pd64.rhs.numpy(), fresh.rhs.numpy(), "rhs")
    # matcomp500's right-hand side holds values an f32 cast rounds
    assert not torch.equal(pd64.rhs, s.pd.rhs.double())
    assert bk32.a_val_o.dtype == torch.float32


# ---------------------------------------------------------------------------
# The line search at f32.
# ---------------------------------------------------------------------------

# the port's f32 tau against the f64 tau of the same f32 inputs: within
# FLOOR32 plus LS_FACTOR times lorads_tpu's f32 error, case by case
# (LS_FACTOR: twice the largest ratio measured over the 64 cases, 1.93,
# rounded up)
FLOOR32 = 64 * EPS32
LS_FACTOR = 4.0


def _ls_inputs(seed, n=40):
    """(rho, lam, p1, p2, q0, q1, q2) as f32 numpy: rho from 0.1 to 1e5,
    the q's at a seeded scale, lam at rho's."""
    rng = np.random.default_rng(seed)
    rho = 10 ** rng.uniform(-1, 5)
    sc = 10 ** rng.uniform(-4, 1)
    q0 = rng.standard_normal(n) * sc * 10
    q1 = rng.standard_normal(n) * sc
    q2 = rng.standard_normal(n) * sc * sc
    lam = rng.standard_normal(n) * rho * sc
    p1 = rng.standard_normal() * sc * 100
    p2 = abs(rng.standard_normal()) * sc * sc * 100
    return tuple(np.asarray(x, np.float32)
                 for x in (rho, lam, p1, p2, q0, q1, q2))


# jitted, as it runs inside lorads_tpu's ALM step
_tpu_ls = jax.jit(tpu_ls.alm_line_search)


def _taus(args):
    """(tau at f64 from the f32 inputs, lorads_tpu's f32 (tau, roots), the
    port's)."""
    t64, _ = _tpu_ls(*(jnp.asarray(x, jnp.float64) for x in args))
    tj, nj = _tpu_ls(*(jnp.asarray(x) for x in args))
    tt, nt = t_ls.alm_line_search(*(torch.tensor(x) for x in args))
    assert tt.dtype == torch.float32
    return float(t64), (float(tj), int(nj)), (float(tt), int(nt))


def test_line_search_f32_matches_lorads_tpu():
    for seed in range(64):
        t64, (tj, nj), (tt, nt) = _taus(_ls_inputs(seed))
        assert nt == nj, seed
        scale = max(abs(t64), 1e-30)
        ej, et = abs(tj - t64) / scale, abs(tt - t64) / scale
        assert et <= FLOOR32 + LS_FACTOR * ej, (seed, t64, tj, tt)
    # the f64 path stays the f64 one: coefficients at f64, tau at f64
    args = _ls_inputs(0)
    t64, _ = t_ls.alm_line_search(*(torch.tensor(x, dtype=torch.float64)
                                    for x in args))
    assert t64.dtype == torch.float64


def test_line_search_f32_rho_scaled_overflow():
    """Coefficients whose raw discriminant B^2 - 4AC overflows f32 (rho
    1e8, factors of 1e3): both packages solve the normalized cubic to a
    finite tau in (0, 1], the port's as close to the f64 tau."""
    rng = np.random.default_rng(5)
    n = 40
    q1 = rng.standard_normal(n) * 1e3
    q2 = rng.standard_normal(n) * 1e3
    # q0 along q1, so that the slope at 0 is negative: a descent step
    q0 = 0.5 * q1 + rng.standard_normal(n) * 1e2
    args = tuple(np.asarray(x, np.float32) for x in (
        1e8, rng.standard_normal(n), -1e12, 1e10, q0, q1, q2))
    a, b, c, d = (float(v) for v in t_ls.quartic_coeffs(
        *(torch.tensor(x, dtype=torch.float64) for x in args)))
    A, B, C = 9 * b * b - 24 * a * c, 6 * b * c - 36 * a * d, \
        4 * c * c - 6 * b * d
    assert B * B - 4 * A * C > float(np.finfo(np.float32).max)
    t64, (tj, nj), (tt, nt) = _taus(args)
    assert nj == nt > 0 and np.isfinite(tt) and 0.0 < tt <= 1.0
    ej = abs(tj - t64) / t64
    assert abs(tt - t64) / t64 <= FLOOR32 + LS_FACTOR * ej


# ---------------------------------------------------------------------------
# One ALM run and one ADMM chunk at f32.
# ---------------------------------------------------------------------------

# The largest spread between the packages at f32 over each field's scale,
# by case and group (as tests/test_torch_alm_device.py and
# test_torch_admm_device.py group them); the bounds are BOUND(reading)
SPREAD32 = {
    "alm_maxcut300": dict(obj=8.75e-6, dimacs=8.94e-3, step=9.31e-3,
                          vars=8.68e-5),
    "alm_theta_gtoy60": dict(obj=2.94e-7, dimacs=2.70e-7, step=1.32e-4,
                             vars=3.97e-5),
    "alm_hand_multiblock": dict(obj=1.22e-5, dimacs=1.14e-4, step=1.38e-3,
                                vars=4.65e-6),
}
# ALM case: (instance, outers a run, max_alm_iter), as
# tests/test_torch_alm_device.py's; theta_gtoy60 stops after its first
# outer (at f32 the packages' theta trajectories part in the second:
# its first line search's tau already differs by ~1e-5, summation order
# amplified by the cancelling dot products of the quartic's coefficients)
ALM_CASES = {
    "alm_maxcut300": ("maxcut300", 16, 200),
    "alm_theta_gtoy60": ("theta_gtoy60", 1, 200),
    "alm_hand_multiblock": ("hand_multiblock", 16, 2),
}
GROUPS = {"obj": ("pobj", "dobj"), "dimacs": ("pinf_l1", "pinf_inf", "gap"),
          "step": ("cert_val", "tau"), "exact": ("rho", "rho_factor")}
LOGGED = ("pobj", "dobj", "pinf_l1", "pinf_inf", "gap", "rho")


def _alm_runs(case):
    """(lorads_tpu's outer_chunk output, the port's pack and carry) of one
    f32 run from lorads_tpu's f32 start."""
    name, outers, max_alm_iter = ALM_CASES[case]
    problem = _problem(name)
    js = TpuSolver(problem, TpuParams(verbose=False, dtype="f32"))
    ts = TorchSolver(problem, TorchParams(verbose=False, dtype="f32"),
                     device="cpu")
    p, jp = ts.params, js.params
    rho = js.ps.rho0
    st = interop.state_from_numpy(R=js.R, dual=np.asarray(js.dual),
                                  hist=js.hist, dtype=torch.float32)
    jcs, jg, jcert = tpu_alm.alm_recompute(js.pd, js.R, js.dual, rho)
    dt = jnp.float32
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    out = jax.device_get(tpu_alm.outer_chunk(
        js.pd, js.R, jg, js.hist, js.dual, jcs, jcert, jnp.asarray(rho, dt),
        jnp.asarray(jp.alm_rho_factor, dt), i32(0), i32(0), i32(0),
        i32(max_alm_iter), i32(5000), i32(0), i32(0),
        i32(jp.rank_flag_thres), jnp.asarray(bool(js.is_rank_max())),
        i32(1), jnp.asarray(1e30, dt), jnp.asarray(1e30, dt),
        jnp.asarray(1e30, dt), jnp.asarray(1e30, dt), jnp.asarray(1.0, dt),
        jnp.asarray(jp.end_alm_sub_tol, dt), jnp.asarray(jp.end_tau_tol, dt),
        jnp.asarray(jp.phase1_tol, dt), jnp.asarray(jp.phase2_tol, dt),
        high_acc_mode=jp.high_acc_mode, max_outers=outers))
    carry, fixed = t_alm.alm_start(
        ts.pd, p, st["R"], st["dual"], st["hist"], ALMStats(rho=rho), 1.0,
        ts.is_rank_max(), p.alm_rho_factor, 5000, outers, max_alm_iter)
    assert carry.rho.dtype == torch.float32 == fixed["phase2_tol"].dtype
    got, pack = devloop.run(t_alm.outer_loop(ts.pd, t_alm.ALMInputs(
        budget=torch.tensor(2 ** 30), grind_armed=torch.tensor(False),
        **fixed), carry, high_acc_mode=p.high_acc_mode))
    return out, pack, got


@pytest.mark.parametrize("case", sorted(ALM_CASES))
def test_alm_outer_f32_matches_lorads_tpu(case):
    out, pack, got = _alm_runs(case)
    nf, ni = len(t_alm.PACK_F), len(t_alm.PACK_I)
    jpk = np.asarray(out["packed"], np.float64)
    n = int(pack[nf + t_alm.PACK_I.index("n_done")])
    jlog = jpk[nf + ni:].reshape(-1, tpu_alm.LOG_COLS)[:n]
    tlog = np.asarray(pack[nf + ni:]).reshape(-1, t_alm.LOG_COLS)[:n]
    assert list(pack[nf:nf + ni]) == list(jpk[nf:nf + ni])
    assert n > 0 and tlog[:, :2].tolist() == jlog[:, :2].tolist()
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
    assert got.R.cones[0].dtype == torch.float32
    assert spread.pop("exact") == 0.0
    for group, reading in SPREAD32[case].items():
        assert spread[group] <= BOUND(reading), (group, spread[group])


# ---------------------------------------------------------------------------
# maybe_escalate_f64's state, and f32 checkpoints.
# ---------------------------------------------------------------------------

def _solver(pkg, name="hand_multiblock", **kw):
    if pkg == "tpu":
        s = TpuSolver(_problem(name), TpuParams(verbose=False, dtype="f32",
                                                **kw))
    else:
        s = TorchSolver(_problem(name), TorchParams(
            verbose=False, dtype="f32", **kw), device="cpu")
    s._auto_dtype = True
    return s


def _fv(pkg, cones, lp):
    if pkg == "tpu":
        return TpuFV(tuple(jnp.asarray(x) for x in cones), jnp.asarray(lp))
    return TorchFV(tuple(torch.tensor(x) for x in cones), torch.tensor(lp))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _set_state(s, pkg, scale):
    """Seeded f32 R, U, V, S and dual (U and V aliases of R, as at the
    start), and the objective scaled as a reopt leaves it."""
    rng = np.random.default_rng(23)
    shapes = [tuple(x.shape) for x in s.R.cones]
    n_lp = s.R.lp.shape[0]

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    s.R = _fv(pkg, [f32(*sh) for sh in shapes], f32(n_lp))
    s.U = s.V = s.R
    s.S = _fv(pkg, [f32(*sh) for sh in shapes], f32(n_lp))
    dual = f32(s.m)
    s.dual = jnp.asarray(dual) if pkg == "tpu" else torch.tensor(dual)
    s.scale_obj_his = scale
    s.pd = (tpu_aop if pkg == "tpu" else t_aop).scale_objective(s.pd, scale)


def test_maybe_escalate_f64_state_matches_lorads_tpu():
    js, ts = _solver("tpu"), _solver("torch")
    for s, pkg in ((js, "tpu"), (ts, "torch")):
        _set_state(s, pkg, 5.0)
    lines = []
    ts.log = lambda *a, **k: lines.append(" ".join(map(str, a)))
    wide = {k: [_np(x) for x in getattr(ts, k).cones]
            + [_np(getattr(ts, k).lp)] for k in "RUVS"}
    dual32 = _np(ts.dual)
    assert js.maybe_escalate_f64("test") and ts.maybe_escalate_f64("test")
    assert lines[0] == "escalating to float64 (test)"
    assert "dtype=float64" in lines[1]
    assert [r for r, _ in ts.escalations] == ["test"]
    assert ts.dtype == torch.float64 and js.dtype == jnp.float64
    for k in "RUVS":
        got, want = getattr(ts, k), getattr(js, k)
        for a, b, w in zip(got.cones + (got.lp,), want.cones + (want.lp,),
                           wide[k]):
            assert a.dtype == torch.float64
            _same_bits(a.numpy(), np.asarray(b), k)
            np.testing.assert_array_equal(a.numpy(), w.astype(np.float64))
    assert ts.U is ts.R and ts.V is ts.R
    _same_bits(ts.dual.numpy(), np.asarray(js.dual), "dual")
    np.testing.assert_array_equal(ts.dual.numpy(), dual32)
    # the f64 data from the presolve, the objective scaled by 5 again
    for tbk, jbk in zip(ts.pd.buckets, js.pd.buckets):
        fields = t_pat.DENSE_FIELDS if tbk.dense else t_pat.FLOAT_FIELDS
        for f in fields:
            if getattr(tbk, f).is_floating_point():
                _same_bits(getattr(tbk, f).numpy(), getattr(jbk, f), f)
    _same_bits(ts.pd.lp.obj.numpy(), js.pd.lp.obj, "lp.obj")
    assert ts.pd.buckets[0] is not ts._problem_data(torch.float64).buckets[0]
    # the memo keeps the f64 data only: the f32 data were evicted
    assert [k[0] for k in ts.ps._pd_cache] == [torch.float64]
    # a fresh history at f64
    assert int(ts.hist.n_valid) == 0 and ts.hist.beta.dtype == torch.float64
    assert not bool(ts.hist.s.cones[0].any())
    # once only, and never without auto
    assert not ts.maybe_escalate_f64("again") and len(lines) == 2
    plain = _solver("torch")
    plain._auto_dtype = False
    assert not plain.maybe_escalate_f64("x") and plain.dtype == torch.float32


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("writer,reader", [("torch", "tpu"),
                                           ("tpu", "torch")])
def test_f32_checkpoint_crosses_packages(writer, reader, tmp_path):
    """An f32 solve's checkpoint (float32 arrays) loads bit for bit in the
    other package; saved after an escalation (float64 arrays), both
    packages' f32 solvers cast it alike."""
    w = _solver(writer)
    _set_state(w, writer, 1.0)
    first = str(tmp_path / "f32.ckpt")
    w.save(first, phase="post_alm")
    written = _arrays(first)
    assert {a.dtype for a in written.values()} == {np.dtype(np.float32)}
    r = _solver(reader)
    r.load(first)
    for p in "RUVS":
        fv = getattr(r, p)
        for i, x in enumerate(fv.cones):
            _same_bits(_np(x), written[f"{p}_cone{i}"], p)
        _same_bits(_np(fv.lp), written[f"{p}_lp"], p)
    _same_bits(_np(r.dual), written["dual"], "dual")
    # across an escalation: the writer at f64 now
    w.maybe_escalate_f64("test")
    second = str(tmp_path / "f64.ckpt")
    w.save(second, phase="post_admm")
    assert _arrays(second)["dual"].dtype == np.float64
    loaded = []
    for pkg in ("tpu", "torch"):
        s = _solver(pkg)
        s.load(second)
        loaded.append([_np(x) for x in s.R.cones + (s.R.lp, s.dual)])
    for a, b in zip(*loaded):
        assert a.dtype == np.float32
        _same_bits(a, b, "cast")


# ---------------------------------------------------------------------------
# The f32 CG budget and the preemptive escalation.
# ---------------------------------------------------------------------------

def test_cg_budget_at_f32():
    """The chunk returns once its CG count reaches 24000 at f32 (with or
    without the mixed CG, which f32 never takes), 4000 at f64 without the
    mixed CG (lorads_tpu/alg/admm.py:504)."""
    for dtype, mixed, budget in (("f32", True, 24000), ("f32", False, 24000),
                                 ("f64", False, 4000), ("f64", True, 24000)):
        ts = TorchSolver(_problem("maxcut300"), TorchParams(
            verbose=False, dtype=dtype, admm_mixed_cg=mixed), device="cpu")
        tl, ttot, (pobj, dobj, pinf, gap) = t_admm.admm_init_eval(
            ts.pd, ts.U, ts.V, ts.dual, 1.0)
        carry = t_admm.make_carry(
            ts.pd, ts.U, ts.V, tl, ttot, ts.dual, rho=1.0, cur_rho_max=5e3,
            pinf_buf=[0.0] * 10, old_pinf_mean=1e30, bad_pd=0, it=0,
            pinf_l1=pinf, gap=gap, pobj=pobj, dobj=dobj, best_gap=gap,
            since_best=0, best_pinf=pinf, since_pinf=0)
        c = t_admm.chunk_start(ts.params, ts.pd, carry)
        loop = t_admm.chunk_loop(ts.params, ts.pd, c["carry"], c["plan"],
                                 1.0, 100, 10)
        st = loop.init(loop.inputs, loop.state)
        for n, runs in ((budget - 1, True), (budget, False)):
            st = st.__class__(**{**vars(st), "cg_iter": torch.tensor(n)})
            assert bool(loop.running(loop.inputs, st)) is runs, (dtype, n)


# the one f64 ADMM iteration after the preemptive escalation: its CG
# sweeps run at f32 (the mixed CG), so the packages part by f32 summation
# order there; twice the largest relative spread measured (2.12e-9,
# pinf_l1), rounded up
PREEMPT_RTOL = 5e-9


def test_preemptive_escalation_twin():
    """tests/test_robustness.py:42-60 in both packages: the ADMM exit's
    pinf_l1 target under 5e-10 escalates at the phase's entry; the same
    reason, and the one f64 iteration that follows from the same start."""
    problem = _problem("mc60")
    out = {}
    for pkg in ("tpu", "torch"):
        if pkg == "tpu":
            s = TpuSolver(problem, TpuParams(verbose=False, dtype="f32",
                                             phase2_tol=1e-9))
            stats = TpuADMMStats(rho=s.ps.rho0)
        else:
            s = TorchSolver(problem, TorchParams(
                verbose=False, dtype="f32", phase2_tol=1e-9), device="cpu")
            stats = ADMMStats(rho=s.ps.rho0)
        s._auto_dtype = True
        need = 1e-9 * (1 + float(s.pd.b_nrm_inf)) / (1 + float(s.pd.b_nrm1))
        assert need < 5e-10, "test instance lost its premise"
        lines = _logged(s)
        stats.gap = stats.pinf_l1 = 1.0
        ret = s.admm_phase(stats, 1, time.time())
        out[pkg] = (ret, _escalations(lines), stats)
    assert s.dtype == torch.float64
    (jr, je, js), (tr, te, tst) = out["tpu"], out["torch"]
    assert tr == jr == "ok" and te == je
    assert te == [f"ADMM pinf target {need:.1e} below the f32 floor"]
    assert tst.iter == js.iter == 1
    for f in ("pobj", "dobj", "pinf_l1", "gap", "rho"):
        a, b = getattr(tst, f), getattr(js, f)
        assert abs(a - b) <= PREEMPT_RTOL * max(abs(b), 1e-30), f
