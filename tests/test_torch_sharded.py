"""lorads_torch's sharding across processes: gloo ranks on the CPU.

Each test spawns its ranks (the ``spawn`` start method: the pytest worker
has JAX loaded, and a forked child would inherit it) through
tests/torch_shard_worker.py, which imports lorads_torch only; the ranks
join a gloo group over a FileStore under ``tmp_path``, read their inputs
from .npz files and write their results to .npz files.  A join that
outlasts its timeout kills every rank and fails the test.

* the building blocks at 2 ranks against lorads_tpu's own on a 2-device
  virtual mesh (parallel/sharded.py, pattern_sharded.py, row_sharded.py);
* one dp ALM outer iteration and one ADMM chunk at 2 ranks against the
  same at one rank, within twice the largest spread measured between
  the two, at least 1e-11 (``SPREAD``, as tests/test_torch_alm_device.py
  holds the port to lorads_tpu);
* whole sharded solves at 2 ranks (sp here; dp and tp ``slow``) against
  lorads_tpu's unsharded status and pObj, every rank returning the same
  bits;
* ``shard_choice`` against the layouts lorads_tpu's solvers take on
  conftest's virtual CPU devices (solver.py:207-228), with no group; the
  import and two-rank all_reduce twins of tests/test_multihost.py.
"""

import contextlib
import dataclasses
import functools
import io
import multiprocessing
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shard_worker as worker
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.alg.solver import shard_choice
from lorads_torch.config import LoradsParams as TorchParams
from test_torch_shard_layouts import REF_RTOL, ref_problem, tpu_reference

WORLD = 2
JOIN_TIMEOUT = 240.0
# per field of one dp ALM outer and one ADMM chunk, the largest
# |one rank - two ranks| measured (x86-64, one thread a rank), relative
# to the field's scale, rounded up to 1, 2 or 5 times a power of ten;
# the test allows twice it, at least 1e-11.  The dp sums add the ranks'
# partials in another order; the chunk's mixed-precision CG carries such
# a difference into an f32 rounding of its sweeps.
SPREAD = {"alm_R": 1e-15, "alm_dual": 5e-15, "alm_f": 1e-14,
          "admm_U": 2e-8, "admm_V": 1e-8, "admm_dual": 1e-13,
          "admm_f": 5e-10}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(tmp_path, tasks, world=WORLD):
    """Run ``tasks`` on ``world`` spawned gloo ranks -> per-rank result
    dicts; a rank that outlasts JOIN_TIMEOUT or fails fails the test."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=worker.run, args=(
        r, world, store, str(tmp_path), list(tasks), outs[r]))
        for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} outlasted {JOIN_TIMEOUT} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    res = []
    for o in outs:
        with np.load(o) as z:
            res.append({k: z[k] for k in z.files})
    return res


def _mesh2():
    return jax.sharding.Mesh(np.array(jax.devices()[:2]), ("blk",))


# lorads_tpu's building blocks on a 2-device mesh, recorded (their
# shard_map compiles take minutes on the CPU): inputs and outputs of
# each, written by lorads_tpu_mesh_oracles; test_mesh_oracles reruns
# lorads_tpu and holds the file to it
ORACLES = "tests/fixtures/shard_mesh_oracles.npz"
ORACLE_OUT = {"step": ("U1", "V1", "total", "grad"),
              "sp_grad": ("total", "grad", "cert"),
              "tp_grad": ("total", "grad", "cert")}


def _oracle_problem(kind):
    if kind == "step":
        return tpu_gen.random_multiblock(n_blocks=8, dim=12, m=10, seed=3)
    if kind == "sp_grad":
        return tpu_gen.maxcut(n=200, avg_degree=6, seed=3)
    return tpu_gen.random_multiblock(n_blocks=1, dim=18, m=14,
                                     density=0.6, seed=11)


def lorads_tpu_mesh_oracles() -> dict:
    """lorads_tpu's sharded_solver_step (make_mesh(2)),
    make_sharded_gradient and make_row_sharded_gradient (2 shards on a
    2-device mesh, dual from seed 0, rho 1.7), with their inputs."""
    from lorads_tpu.parallel import pattern_sharded as psh
    from lorads_tpu.parallel import row_sharded as rsh
    from lorads_tpu.parallel.sharded import make_mesh, sharded_solver_step
    out = {}
    s = TpuSolver(_oracle_problem("step"), TpuParams(verbose=False))
    res = sharded_solver_step(make_mesh(2), s.pd, s.U, s.V, s.dual, 1.0)
    out.update({"step.U": s.U.cones[0], "step.V": s.V.cones[0],
                "step.dual": s.dual, "step.rho": 1.0})
    out.update({f"step.{k}": v for k, v in zip(ORACLE_OUT["step"], res)})
    for kind, sh in (("sp_grad", psh), ("tp_grad", rsh)):
        problem = _oracle_problem(kind)
        s = TpuSolver(problem, TpuParams(verbose=False))
        plan = s.ps.plans[0]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), (sh.AXIS,))
        if kind == "sp_grad":
            data = sh.build_pattern_shards(plan, problem.m, 2, s.dtype)
            step = sh.make_sharded_gradient(mesh, data, s.pd.rhs,
                                            s.pd.c_nrm_inf)
        else:
            data = sh.build_row_shards(plan, problem.m, 2, s.dtype)
            step = sh.make_row_sharded_gradient(mesh, data,
                                                s.pd.c_nrm_inf)
        dual = np.random.default_rng(0).standard_normal(problem.m)
        U = np.asarray(s.R.cones[0][0])
        res = step(data, jnp.asarray(U), s.pd.rhs, jnp.asarray(dual),
                   jnp.asarray(1.7, s.dtype))
        out.update({f"{kind}.U": U, f"{kind}.dual": dual,
                    f"{kind}.rho": 1.7, f"{kind}.D": 2})
        out.update({f"{kind}.{k}": v
                    for k, v in zip(ORACLE_OUT[kind], res)})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.slow
def test_mesh_oracles():
    got = lorads_tpu_mesh_oracles()
    with np.load(ORACLES) as z:
        assert sorted(z.files) == sorted(got)
        for k in z.files:
            np.testing.assert_allclose(got[k], z[k], rtol=1e-13,
                                       atol=1e-14, err_msg=k)


def _inputs(tmp_path, kind):
    """Write the oracle's problem and inputs for the ranks -> its
    outputs."""
    worker.save_problem(tmp_path / f"{kind}.npz", _oracle_problem(kind))
    with np.load(ORACLES) as z:
        np.savez(tmp_path / f"{kind}_in.npz",
                 **{k.split(".", 1)[1]: z[k] for k in z.files
                    if k.startswith(kind + ".")
                    and k.split(".", 1)[1] not in ORACLE_OUT[kind]})
        return [z[f"{kind}.{k}"] for k in ORACLE_OUT[kind]]


@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    """One spawn: the building blocks, the dp ALM outer and ADMM chunk,
    the sp solve and the all_reduce twin; with lorads_tpu's oracles and
    the one-rank runs."""
    tmp = tmp_path_factory.mktemp("fast")
    want = {k: _inputs(tmp, k) for k in ORACLE_OUT}
    for name in ("sp", "dp", "tp"):
        worker.save_problem(tmp / f"{name}.npz", ref_problem(name))
    worker.save_problem(tmp / "dp2.npz", tpu_gen.random_multiblock(
        n_blocks=2, dim=8, m=6, seed=1))
    one = _one_rank_dp(tmp)
    got = _spawn(tmp, ["step", "sp_grad", "tp_grad", "dp_alm", "dp_admm",
                       "solve_sp", "solve_dp2", "sp_escalate",
                       "tp_placed", "dp_checkpoint", "all_reduce"])
    return tmp, want, got, one


def _one_rank_dp(tmp):
    """The dp instance's ALM outer and ADMM chunk at one rank (no group),
    and the chunk's start: its ALM phase's end, at 5x the handoff rho
    (the handoff rho diverges in one rank and two alike, and admm_phase
    retries at 5x)."""
    def mk():
        return TorchSolver(worker.load_problem(tmp / "dp.npz"),
                           TorchParams(verbose=False), device="cpu")
    worker.alm_admm_state(mk(), tmp / "dp_state.npz", rho_factor=5.0)
    one = worker.alm_outer(mk())
    one.update(worker.admm_chunk_from(mk(), tmp / "dp_state.npz"))
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in one.items()}


def test_sharded_solver_step_matches_lorads_tpu_mesh(fast_run):
    _, want, got, _ = fast_run
    U1, V1, total, grad = want["step"]
    cat = lambda k: np.concatenate([g[f"step.{k}"] for g in got])  # noqa
    np.testing.assert_allclose(cat("grad"), grad, rtol=1e-9, atol=1e-10)
    for g in got:
        np.testing.assert_allclose(g["step.total"], total, rtol=1e-9,
                                   atol=1e-10)
        # one all_reduce for the values, two for the sweep's changes
        assert int(g["step.comm.scatter_constr"]) == 3
    np.testing.assert_allclose(cat("U1"), U1, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(cat("V1"), V1, rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("kind", ["sp_grad", "tp_grad"])
def test_sharded_gradients_match_lorads_tpu_mesh(fast_run, kind):
    _, want, got, _ = fast_run
    total, grad, cert = want[kind]
    for g in got:
        np.testing.assert_allclose(g[f"{kind}.total"], total, rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_allclose(g[f"{kind}.grad"], grad, rtol=1e-9,
                                   atol=1e-10)
        assert float(g[f"{kind}.cert"]) == pytest.approx(float(cert),
                                                         rel=1e-9)
    # every rank the same bits
    for k in ("total", "grad", "cert"):
        np.testing.assert_array_equal(got[0][f"{kind}.{k}"],
                                      got[1][f"{kind}.{k}"])


def _close(a, b, name):
    scale = max(float(np.max(np.abs(b))), 1.0)
    tol = max(2 * SPREAD[name.split("[")[0]], 1e-11) * scale
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_dp_alm_outer_and_admm_chunk_match_one_rank(fast_run):
    _, _, got, one = fast_run
    for g in got:
        for k in ("alm_i", "admm_i"):
            task = "dp_alm" if k.startswith("alm") else "dp_admm"
            np.testing.assert_array_equal(g[f"{task}.{k}"], one[k],
                                          err_msg=k)
        for k in SPREAD:
            task = "dp_alm" if k.startswith("alm") else "dp_admm"
            if k.endswith("_f"):
                for i, (a, b) in enumerate(zip(g[f"{task}.{k}"], one[k])):
                    _close(a, b, f"{k}[{i}]")
            else:
                _close(g[f"{task}.{k}"], one[k], k)
    for k in SPREAD:
        task = "dp_alm" if k.startswith("alm") else "dp_admm"
        np.testing.assert_array_equal(got[0][f"{task}.{k}"],
                                      got[1][f"{task}.{k}"])
    # the block scan: one all_reduce a block and side, on every rank
    assert int(got[0]["dp_admm.comm.block_scan"]) == \
        int(got[1]["dp_admm.comm.block_scan"]) > 0


def _check_solve(got, case):
    status, pobj = tpu_reference(case)
    for g in got:
        assert str(g[f"solve_{case}.status"]) == status
        assert float(g[f"solve_{case}.pobj"]) == pytest.approx(
            pobj, rel=REF_RTOL[case])
    keys = [k for k in got[0] if k.startswith(f"solve_{case}.R")] + [
        f"solve_{case}.dual", f"solve_{case}.pobj"]
    for k in keys:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def test_sp_solve_two_ranks(fast_run):
    _, _, got, _ = fast_run
    _check_solve(got, "sp")
    assert int(got[0]["solve_sp.comm.w_mul"]) > 0


def test_dp_one_block_a_rank_matches_one_rank(fast_run):
    """Two blocks over two ranks, one each: the block Gauss-Seidel scan
    runs across the ranks (a block's change reaches the other rank
    before its block), so the solve follows the one-rank solve: the
    same status and, within 1e-9, pObj; every rank the same bits."""
    tmp, _, got, _ = fast_run
    one = TorchSolver(worker.load_problem(tmp / "dp2.npz"),
                      TorchParams(verbose=False), device="cpu").solve()
    for g in got:
        assert "dp buckets [0]" in str(g["solve_dp2.note"])
        assert str(g["solve_dp2.status"]) == one.status.value
        assert float(g["solve_dp2.pobj"]) == pytest.approx(one.pobj,
                                                           rel=1e-9)
        assert int(g["solve_dp2.comm.block_scan"]) > 0
    for k in ("solve_dp2.R0", "solve_dp2.dual", "solve_dp2.pobj"):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def test_sp_aug_rank_and_f64_escalation(fast_run):
    """The twin of test_sharded.py:257-278 at 2 ranks: the layout is
    rebuilt at f64 from the presolve, not widened, and keyed in the memo
    by dtype and layout."""
    _, _, got, _ = fast_run
    for g in got:
        r0, r1 = g["sp_escalate.ranks"]
        assert r1 > r0 and int(g["sp_escalate.R_rows"]) == 1
        assert bool(g["sp_escalate.escalated"])
        assert bool(g["sp_escalate.summed_f64"])
        assert bool(g["sp_escalate.same_bits"])
        # the f64 data placed, and nothing else: the f32 entries
        # evicted, no unsharded entry kept
        assert list(g["sp_escalate.memo"]) == ["torch.float643"]
        assert str(g["sp_escalate.status"]) == "primal_dual_optimal"
        assert float(g["sp_escalate.pinf"]) <= 1e-5


def test_tp_rank_holds_its_slab_alone(fast_run):
    """A tp solver's data on each of 2 ranks: the dense cone's C as one
    [1, n_loc, n] row slab, the memo holding that placed data alone (no
    whole n x n bucket is built on the rank's device or kept)."""
    _, _, got, _ = fast_run
    for g in got:
        n = int(g["tp_placed.n"])
        assert bool(g["tp_placed.rowshard"])
        assert list(g["tp_placed.c_full"]) == [1, -(-n // WORLD), n]
        assert list(g["tp_placed.memo"]) == ["torch.float643"]


def test_dp_checkpoint_two_ranks(fast_run):
    """A checkpoint of a dp solve at 2 ranks holds the gathered state in
    lorads_tpu's file layout: its R is the one-rank solver's whole
    random start bit for bit, lorads_tpu loads it, and a dp solver that
    loads it holds its own blocks of it on each rank."""
    tmp, _, got, _ = fast_run
    path = str(tmp / "dp_ck.npz")
    problem = worker.load_problem(tmp / "dp.npz")
    one = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    with np.load(path) as z:
        R = z["R_cone0"]
    np.testing.assert_array_equal(R, one.R.cones[0].numpy())
    np.testing.assert_array_equal(
        np.concatenate([g["dp_checkpoint.R_local"] for g in got]), R)
    for g in got:
        assert bool(g["dp_checkpoint.loaded_same"])
    ts = TpuSolver(ref_problem("dp"), TpuParams(verbose=False, seed=7))
    ts.load(path)
    np.testing.assert_array_equal(np.asarray(ts.R.cones[0]), R)


def test_cli_shard_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node=2 -m
    lorads_torch FILE --shard sp --device cpu``: the group from
    torchrun's environment (a localhost store), one report, rank 0's."""
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc_per_node=2", "--master_addr", "127.0.0.1",
         "--master_port", str(port), "-m", "lorads_torch",
         os.path.join(repo, "tests", "fixtures", "maxcut2000.dat-s"),
         "--shard", "sp", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("End Program with status "
                            "`primal_dual_optimal`") == 1
    assert "sharding: 2-device mesh, dp buckets [], sp buckets [0]" in \
        out.stdout


@pytest.mark.slow
def test_dp_tp_solves_two_ranks(tmp_path):
    for name in ("dp", "tp"):
        worker.save_problem(tmp_path / f"{name}.npz", ref_problem(name))
    got = _spawn(tmp_path, ["solve_dp", "solve_tp"])
    _check_solve(got, "dp")
    _check_solve(got, "tp")


def test_two_rank_all_reduce(fast_run):
    _, _, got, _ = fast_run
    for g in got:
        np.testing.assert_array_equal(g["all_reduce.sum"], np.full(4, 3.0))
        np.testing.assert_array_equal(
            g["all_reduce.gather"], np.stack([np.full(4, 1.0),
                                              np.full(4, 2.0)]))
        assert int(g["all_reduce.comm.test"]) == 2


def test_import_initializes_no_group_and_no_cuda():
    """Importing the port's distributed layer initialises no process
    group and no CUDA context (the twin of test_multihost.py's import
    test)."""
    code = (
        "import torch, torch.distributed as dist\n"
        "import lorads_torch\n"
        "from lorads_torch.parallel import distributed, comm, sharded\n"
        "from lorads_torch.parallel import pattern_sharded, row_sharded\n"
        "import lorads_torch.alg.solver\n"
        "assert not dist.is_initialized()\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert distributed.world() == (0, 1)\n"
        "assert distributed.solver_mesh() is None\n"
        "import sys; assert 'jax' not in sys.modules\n"
        "print('clean')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, (
        out.stdout + out.stderr)


_CHOICE_M = 12
# the buckets of _choice_problem: (blocks, dim, dense, off-diagonal
# objective entries of a sparse block); between them they take every
# branch of lorads_tpu's rules on 2, 3, 4 and 8 devices
_CHOICE_SHAPES = ((8, 40, False, 20), (6, 10, True, 0), (1, 300, False, 600),
                  (1, 30, False, 10), (1, 40, True, 0), (1, 5, True, 0),
                  (2, 100, True, 0))


@functools.lru_cache(maxsize=None)
def _choice_problem():
    """One problem whose presolve gives a bucket of each of
    _CHOICE_SHAPES: 8 sparse blocks, 6 small dense ones, one sparse cone
    of K = 900 and one of K = 40 (16 nd in between), dense cones of
    n = 40 and n = 5 (2 nd in between), 2 dense blocks; constraint i the
    diagonal entry i mod n of every block."""
    from lorads_tpu.core.problem import SDPBlockData, SDPProblem
    rng = np.random.default_rng(0)
    k = np.arange(_CHOICE_M)
    blocks = []
    for B, n, dense, n_off in _CHOICE_SHAPES:
        for _ in range(B):
            if dense:
                r, c = np.tril_indices(n)
            else:
                off = set()
                while len(off) < n_off:
                    i, j = sorted(rng.integers(0, n, 2))
                    if i != j:
                        off.add((j, i))
                off = sorted(off)
                r = np.r_[np.arange(n), [o[0] for o in off]]
                c = np.r_[np.arange(n), [o[1] for o in off]]
            blocks.append(SDPBlockData(
                dim=n, m=_CHOICE_M, obj_row=r.astype(np.int32),
                obj_col=c.astype(np.int32),
                obj_val=rng.standard_normal(r.size),
                a_con=k.astype(np.int32), a_row=(k % n).astype(np.int32),
                a_col=(k % n).astype(np.int32), a_val=np.ones(_CHOICE_M)))
    return SDPProblem(m=_CHOICE_M, rhs=np.ones(_CHOICE_M), blocks=blocks)


_SHARDING = re.compile(r"dp buckets \[(.*?)\], sp buckets \[(.*?)\], "
                       r"tp buckets \[(.*?)\]")


def _tpu_layout(lines):
    """(dp, sp, tp) bucket indices from lorads_tpu's ``sharding:`` log
    line, or three empty lists without one."""
    found = [_SHARDING.search(x) for x in lines if "sharding:" in x]
    if not found:
        return [], [], []
    assert len(found) == 1 and found[0], lines
    return tuple([int(i) for i in g.split(",") if i.strip()]
                 for g in found[0].groups())


def _indices(choice):
    return tuple([i for i, ok in enumerate(x) if ok] for x in choice)


@pytest.mark.parametrize("mode", ["off", "auto", "dp", "sp", "tp"])
@pytest.mark.parametrize("nd", [2, 3, 4, 8])
def test_shard_choice_table(mode, nd):
    """shard_choice on the port's presolve of _choice_problem against
    the layout a lorads_tpu solver takes with shard=mode and
    n_devices=nd on conftest's virtual CPU devices (its log line)."""
    from lorads_torch.core.presolve import presolve
    problem = _choice_problem()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ts = TpuSolver(problem, TpuParams(verbose=True, shard=mode,
                                          n_devices=nd))
    ps = presolve(problem, TorchParams())
    shape = lambda bs: [(b.B, b.n, b.K, b.dense) for b in bs]  # noqa
    assert shape(ps.buckets) == shape(ts.ps.buckets)
    assert len(ps.buckets) == len(_CHOICE_SHAPES)
    want = _tpu_layout(out.getvalue().splitlines())
    assert _indices(shard_choice(mode, nd, ps.buckets)) == want
    assert (ts.mesh is not None) == any(want)


@dataclasses.dataclass
class _NoData:
    buckets: tuple
    rhs: object


@pytest.mark.parametrize("n", [4095, 4096])
def test_shard_choice_auto_tp_from_n_4096(n):
    """Under auto, lorads_tpu takes tp for a dense cone from n = 4096.
    A dense bucket of that size takes minutes and gigabytes to build on
    the CPU, so lorads_tpu's own _maybe_shard runs on a stand-in solver
    that holds the bucket's plan shape and no bucket data (it places
    none), and its log line is read."""
    from lorads_tpu.alg.state import FactorVec as TpuFV
    lines = []
    plan = types.SimpleNamespace(B=1, n=n, K=n * (n + 1) // 2, dense=True)
    fv = TpuFV((), jnp.zeros(0))
    for nd in (2, 8):
        stand = types.SimpleNamespace(
            params=TpuParams(shard="auto", n_devices=nd),
            ps=types.SimpleNamespace(buckets=[plan]),
            pd=_NoData(buckets=(), rhs=jnp.zeros(1)), m=1,
            dtype=jnp.float64, scale_obj_his=1.0, R=fv, U=fv, V=fv, S=fv,
            dual=jnp.zeros(1), lbfgs_len=3, log=lines.append)
        TpuSolver._maybe_shard(stand)
        want = _tpu_layout(lines[-1:] if lines else [])
        assert want == ([], [], [0] if n >= 4096 else [])
        assert _indices(shard_choice("auto", nd, [plan])) == want
        lines.clear()


def test_shard_on_one_rank_runs_unsharded():
    """Without a process group (one rank) a sharded solve runs
    unsharded and says so, as lorads_tpu's does on one device."""
    problem = tpu_gen.maxcut(n=60, avg_degree=4, seed=2)
    s = TorchSolver(problem, TorchParams(verbose=False, shard="auto"),
                    device="cpu")
    assert s.mesh is None and "unsharded" in s.shard_note
    with pytest.raises(ValueError):
        TorchSolver(problem, TorchParams(verbose=False, shard="xy"),
                    device="cpu")
