"""lorads_torch's presolve and device-data memo across solves, and
``group_buckets``, held to lorads_tpu on the CPU.

* the memo (lorads_tpu/alg/solver.py:71-92, :174-186): a second
  construction of one problem object reuses the presolve and the
  ProblemData, as lorads_tpu's does; each params field presolve reads,
  and ``group_buckets``, keys it (a change builds a new presolve, in
  both packages alike), fields outside the key do not, and
  ``delattr(problem, "_lorads_ps_cache")`` drops it;
* of two solves in a row of one problem object, the second (from the
  memo) equals the first (a fresh object's) bit for bit, each held to
  lorads_tpu's solve within the band of tests/test_torch_solve.py (pObj
  within 1e-4 relative); no solve, one whose reopt scales the objective
  included, writes into the memo's tensors;
* an escalated auto solve from an f32 start evicts the f32 data: a
  solver that still holds them, and a later f32 construction that
  builds them again, each solve as a fresh object's f32 solve does, bit
  for bit; the escalated solve is held to lorads_tpu's from the same
  start;
* ``group_buckets=False`` (the twin of tests/test_solver.py::
  test_ungrouped_buckets_match_grouped): lorads_tpu's buckets, its
  status and, within the multi-block band of tests/
  test_torch_multiblock.py (1e-5 relative), its pObj;
* a sharded construction after an unsharded one of the same problem on
  2 gloo ranks (tests/torch_shard_worker.py).
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_f32_solve as f32_solve
import torch_shard_worker as worker
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_tpu.io.sdpa import read_sdpa
from lorads_torch.alg import aop as t_aop
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams
from lorads_torch.config import SolverStatus
from lorads_torch.core.presolve import Presolved
from test_torch_sharded import _spawn
from test_torch_shard_layouts import REF_RTOL, ref_problem, tpu_reference

FIX = "tests/fixtures/"
POBJ_RTOL = 1e-4              # tests/test_torch_solve.py
MULTIBLOCK_RTOL = 1e-5        # tests/test_torch_multiblock.py
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(name):
    """A fresh problem object (lorads_tpu's generators and reader)."""
    if name == "maxcut300":
        return tpu_gen.maxcut(n=300, avg_degree=4, seed=3)
    if name == "multiblock4":
        return tpu_gen.random_multiblock(n_blocks=4, dim=10, m=8, seed=6)
    if name == "hand_multiblock_gs":
        return read_sdpa(FIX + "hand_multiblock.dat-s")
    return read_sdpa(FIX + name + ".dat-s")


PARAMS = {"hand_multiblock_gs": dict(lp_gauss_seidel=True)}


def _torch(problem, group_buckets=True, **kw):
    return TorchSolver(problem, TorchParams(**{"verbose": False, **kw}),
                       group_buckets=group_buckets, device="cpu")


def _tpu(problem, group_buckets=True, **kw):
    return TpuSolver(problem, TpuParams(**{"verbose": False, **kw}),
                     group_buckets=group_buckets)


def _tensors(tree, out=None):
    """Every tensor of a ProblemData (its buckets, their tile schedules,
    the LP block), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            _tensors(getattr(tree, f), out)
    return out


def _memo_tensors(ps):
    return [t for pd in ps._pd_cache.values() for t in _tensors(pd)]


def _same_result(a, b):
    """Two SolveResults bit for bit: status, objectives, residuals,
    counts, factors and dual."""
    assert a.status is b.status
    for f in ("pobj", "dobj", "pinf_l1", "pinf_inf", "dinf_l1", "dinf_inf",
              "gap"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.alm_stats.outer_iter, a.alm_stats.inner_iter,
            a.admm_stats.iter, a.admm_stats.cg_iter) == (
        b.alm_stats.outer_iter, b.alm_stats.inner_iter,
        b.admm_stats.iter, b.admm_stats.cg_iter)
    assert a.ranks == b.ranks
    for x, y in zip(a.R.cones + (a.R.lp,), b.R.cones + (b.R.lp,)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.dual, b.dual)


def _agrees(jr, tr):
    """The band of tests/test_torch_solve.py: both certified, pObj within
    1e-4 relative."""
    assert jr.status.value == "primal_dual_optimal"
    assert tr.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert abs(tr.pobj - jr.pobj) <= POBJ_RTOL * abs(jr.pobj)


# ---------------------------------------------------------------------------
# The memo's key.
# ---------------------------------------------------------------------------

def test_second_construction_reuses_both_memos():
    """maxcut(300, 4) constructed twice: the same presolve and the same
    ProblemData tensors, as lorads_tpu's two constructions of the same
    problem object share its presolve and its _pd_cache entry.  Both
    packages' entries sit in the one ``_lorads_ps_cache`` dict, apart."""
    problem = _problem("maxcut300")
    s1, s2 = _torch(problem), _torch(problem)
    j1, j2 = _tpu(problem), _tpu(problem)
    assert isinstance(s1.ps, Presolved)
    assert s2.ps is s1.ps and s2.pd is s1.pd
    assert all(a is b for a, b in zip(_tensors(s1.pd), _tensors(s2.pd)))
    assert list(s1.ps._pd_cache) == [(torch.float64, CPU)]
    assert j2.ps is j1.ps and j2.pd is j1.pd
    assert list(j1.ps._pd_cache) == ["float64"]
    assert s1.ps is not j1.ps
    assert sorted(len(k) for k in problem._lorads_ps_cache) == [6, 7]


# a value other than the default for each params field presolve reads,
# and for group_buckets (the constructor's)
KEY_FIELDS = {"times_log_rank": 2.0, "init_rho": 0.5,
              "per_matrix_dense_threshold": 0.3, "dense_dim_threshold": 8,
              "dense_threshold": 0.3, "group_buckets": False}
OUTSIDE_KEY = {"seed": 7, "dtype": "f32", "verbose": True}


def _with(field, value):
    """(params keywords, group_buckets) with ``field`` set to value."""
    if field == "group_buckets":
        return {}, value
    return {field: value}, True


@pytest.mark.parametrize("field", sorted(KEY_FIELDS))
def test_each_key_field_rebuilds(field):
    """Changing one key field builds a new presolve (and new device data
    on it) in both packages; a second construction with that change
    reuses the new one."""
    problem = _problem("multiblock4")
    kw, grp = _with(field, KEY_FIELDS[field])
    t0, j0 = _torch(problem), _tpu(problem)
    t1, j1 = _torch(problem, grp, **kw), _tpu(problem, grp, **kw)
    assert (t1.ps is t0.ps) is (j1.ps is j0.ps) is False
    assert t1.pd is not t0.pd
    assert _torch(problem, grp, **kw).ps is t1.ps
    assert _tpu(problem, grp, **kw).ps is j1.ps
    assert _torch(problem).ps is t0.ps


@pytest.mark.parametrize("field", sorted(OUTSIDE_KEY))
def test_fields_outside_the_key_reuse(field):
    """seed, dtype and verbose are not read by presolve: the presolve is
    reused in both packages (dtype keys the device data instead)."""
    problem = _problem("multiblock4")
    kw = {field: OUTSIDE_KEY[field]}
    t0, j0 = _torch(problem), _tpu(problem)
    t1, j1 = _torch(problem, **kw), _tpu(problem, **kw)
    assert t1.ps is t0.ps and j1.ps is j0.ps
    assert (t1.pd is t0.pd) is (field != "dtype")


def test_delattr_drops_the_memo():
    """``delattr(problem, "_lorads_ps_cache")`` (bench.py's full pass)
    drops both memos in both packages; a problem that refuses the
    attribute solves without a memo."""
    problem = _problem("multiblock4")
    t0, j0 = _torch(problem), _tpu(problem)
    delattr(problem, "_lorads_ps_cache")
    t1, j1 = _torch(problem), _tpu(problem)
    assert t1.ps is not t0.ps and j1.ps is not j0.ps
    assert t1.pd is not t0.pd
    assert _torch(problem).ps is t1.ps

    class Sealed:
        __slots__ = ("_p",)

        def __init__(self, p):
            object.__setattr__(self, "_p", p)

        def __getattr__(self, k):
            return getattr(object.__getattribute__(self, "_p"), k)

    sealed = Sealed(_problem("multiblock4"))
    assert _torch(sealed).ps is not _torch(sealed).ps


# ---------------------------------------------------------------------------
# Repeat solves.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["maxcut300", "matcomp500",
                                  "hand_multiblock_gs"])
def test_two_solves_in_a_row_equal_fresh_solves(name):
    """Two solves in a row of one problem object: the first on a fresh
    object, the second on the memo's presolve and data; the second bit
    for bit the first, and each held to lorads_tpu's solve.
    hand_multiblock's reopt scales the objective (scale_objective gives
    the solver new tensors)."""
    kw = PARAMS.get(name, {})
    problem = _problem(name)
    first = _torch(problem, **kw)
    fresh = first.solve()
    second = _torch(problem, **kw)
    assert second.ps is first.ps
    assert all(a is b for a, b in zip(_tensors(second.pd),
                                      _tensors(first.ps._pd_cache[
                                          (torch.float64, CPU)])))
    again = second.solve()
    _same_result(again, fresh)
    jr = _tpu(_problem(name), **kw).solve()
    for tr in (fresh, again):
        _agrees(jr, tr)


def test_no_solve_writes_into_the_memo(monkeypatch):
    """Every tensor of the memo's ProblemData, snapshot before a solve
    whose reopt scales the objective: equal after it, at the same
    address."""
    problem = _problem("hand_multiblock_gs")
    s = _torch(problem, **PARAMS["hand_multiblock_gs"])
    pd = s.pd
    before = [(t, t.clone(), t.data_ptr()) for t in _memo_tensors(s.ps)]
    assert before
    scaled = []
    real = t_aop.scale_objective

    def counted(p, v):
        scaled.append(v)
        return real(p, v)
    monkeypatch.setattr(t_aop, "scale_objective", counted)
    res = s.solve()
    assert res.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert scaled and s.scale_obj_his != 1.0
    assert s.ps._pd_cache[(torch.float64, CPU)] is pd
    after = _memo_tensors(s.ps)
    assert len(after) == len(before)
    for (t, copy, ptr), u in zip(before, after):
        assert u is t and u.data_ptr() == ptr
        assert torch.equal(u, copy)


# ---------------------------------------------------------------------------
# The f64 escalation's eviction.
# ---------------------------------------------------------------------------

def test_escalation_then_f32_solves(monkeypatch):
    """hand_multiblock: an f32 solver constructed first (it holds the f32
    data), then an auto solve from an f32 start (test_torch_f32_solve's
    ``_solver``) escalates at the level-1 reopt and evicts the f32
    entries, held to lorads_tpu's run from the same start; the solver
    still holding the evicted data, and an f32 construction after the
    escalation (which builds them again), each equal a fresh object's
    f32 solve bit for bit."""
    name = "hand_multiblock"
    problem = _problem(name)
    fresh_problem = f32_solve._problem
    monkeypatch.setattr(f32_solve, "_problem", lambda _: problem)
    hold = _torch(problem, dtype="f32")
    pd32 = hold.pd
    s, lines = f32_solve._solver("torch", name)
    assert s.pd is pd32
    res = s.solve()
    esc = f32_solve._escalations(lines)
    assert esc == ["reopt needed at f32"] and s.dtype == torch.float64
    assert [k[0] for k in s.ps._pd_cache] == [torch.float64]
    monkeypatch.setattr(f32_solve, "_problem", fresh_problem)
    j, jlines = f32_solve._solver("tpu", name)
    jr = j.solve()
    assert f32_solve._escalations(jlines) == esc
    assert res.status.value == jr.status.value
    assert abs(res.pobj - jr.pobj) <= f32_solve.POBJ_RTOL32 * abs(jr.pobj)
    want = _torch(_problem(name), dtype="f32").solve()
    _same_result(hold.solve(), want)
    again = _torch(problem, dtype="f32")
    assert again.ps is s.ps and again.pd is not pd32
    assert sorted(str(k[0]) for k in s.ps._pd_cache) == [
        "torch.float32", "torch.float64"]
    _same_result(again.solve(), want)


# ---------------------------------------------------------------------------
# group_buckets.
# ---------------------------------------------------------------------------

def test_ungrouped_buckets_match_grouped_and_lorads_tpu():
    """random_multiblock(4 blocks of dim 10, m=8, seed 6): the ungrouped
    solve (one B = 1 bucket a block) within 5e-3 of the grouped one (the
    twin of tests/test_solver.py:110-116), lorads_tpu's buckets, and
    lorads_tpu's ungrouped status and pObj within 1e-5; grouped and
    ungrouped constructions take different memo entries."""
    problem = _problem("multiblock4")
    grouped, ungrouped = _torch(problem), _torch(problem, False)
    j = _tpu(problem, False)
    assert ungrouped.ps is not grouped.ps
    assert ungrouped.pd is not grouped.pd
    assert [(bp.B, bp.n) for bp in grouped.ps.buckets] == [(4, 10)]
    assert [(bp.B, bp.n) for bp in ungrouped.ps.buckets] == [
        (bp.B, bp.n) for bp in j.ps.buckets] == [(1, 10)] * 4
    assert ungrouped._bucket_jacobi == (False,) * 4
    r1, r2, jr = grouped.solve(), ungrouped.solve(), j.solve()
    assert r2.pobj == pytest.approx(r1.pobj, rel=5e-3, abs=5e-3)
    assert jr.status.value == "primal_dual_optimal"
    assert r2.status is SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert abs(r2.pobj - jr.pobj) <= MULTIBLOCK_RTOL * abs(jr.pobj)
    assert [x.shape[0] for x in r2.R.cones] == [1] * 4


# ---------------------------------------------------------------------------
# Sharding.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one_rank_sp():
    return _torch(ref_problem("sp")).solve()


def test_sharded_after_unsharded_two_ranks(tmp_path):
    """On 2 gloo ranks, an unsharded construction and solve of the sp
    instance, then a sharded one of the same problem object: the sharded
    solve equals a sharded solve of a fresh object bit for bit, on every
    rank, and its status and pObj lorads_tpu's; the unsharded solve
    equals the one-rank run here.  The placed entry sits beside the
    unsharded one, which stays."""
    worker.save_problem(tmp_path / "sp.npz", ref_problem("sp"))
    got = _spawn(tmp_path, ["solve_sp", "memo_sp"])
    status, pobj = tpu_reference("sp")
    one = _one_rank_sp()
    for g in got:
        assert bool(g["memo_sp.same_ps"]) and bool(g["memo_sp.unsharded_kept"])
        assert list(g["memo_sp.memo"]) == ["torch.float642",
                                           "torch.float643"]
        assert "sp buckets [0]" in str(g["memo_sp.note"])
        assert str(g["memo_sp.status"]) == status
        assert float(g["memo_sp.pobj"]) == pytest.approx(
            pobj, rel=REF_RTOL["sp"])
        for k in [k for k in g if k.startswith("solve_sp.R")] + [
                "solve_sp.dual", "solve_sp.pobj"]:
            np.testing.assert_array_equal(
                g[k.replace("solve_sp", "memo_sp")], g[k], err_msg=k)
        assert str(g["memo_sp.base_status"]) == one.status.value
        assert float(g["memo_sp.base_pobj"]) == pytest.approx(one.pobj,
                                                              rel=1e-9)
    for k in ("memo_sp.R0", "memo_sp.dual", "memo_sp.pobj"):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
