"""lorads_torch's device-resident loops (alg/devloop.py) on the CPU.

CG and the refinement passes are device-decided loops: run at the top
(a read of the exit test before each iteration) they must give what
they give nested in a device-decided step, as the ADMM iteration runs
them.  Checked here: cg_solve and cg_solve_ir on a matcomp500 bucket and
on a hand_multiblock block slice, each also against lorads_tpu's on the
same numpy inputs; a done block's no-op with an inf / NaN direction; the
host-read labels and the replay-aware launch counts.  (The ALM's loops:
tests/test_torch_alm_device.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import cg as tpu_cg
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.core import presolve as tpu_presolve
from lorads_tpu.io import sdpa as tpu_sdpa
from lorads_tpu.ops import pattern as tpu_pat
from lorads_torch import device as t_dev
from lorads_torch.alg import admm as t_admm
from lorads_torch.alg import cg as t_cg
from lorads_torch.alg import devloop
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as t_pat


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIX = "tests/fixtures/"


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x, dtype=np.float64)).to(dtype)


def _jop(bk, Fx):
    """lorads_tpu's CG operator x + A^*(A(sym(x F^T))) @ F."""
    def op(x):
        uv = tpu_pat.uvt_half_cached(bk, x, Fx, None)
        if bk.dense and bk.a_single_dense:
            Wop = tpu_pat.a_adj_a_dense(bk, uv)
        elif not bk.dense and bk.a_off_unique:
            Wop = tpu_pat.a_adj_a(bk, uv)
        else:
            Wop = tpu_pat.build_w(bk, tpu_pat.constr_vals(bk, uv),
                                  include_obj=False)
        return x + tpu_pat.w_mul_cached(bk, Wop, Fx, None)
    return op


CG_CASES = {
    # matcomp500's bucket (K6 and K5 on the CPU: their plain versions)
    "matcomp500": ("matcomp500.dat-s", None),
    # block 0 of hand_multiblock's first bucket, a bucket_slice view
    "hand_multiblock": ("hand_multiblock.dat-s", 0),
}


@pytest.fixture(scope="module", params=sorted(CG_CASES))
def cg_case(request):
    """(name, lorads_tpu op_hi, op_lo, port op, port bucket lo, F, x0,
    b) on one bucket (or block slice)."""
    fname, block = CG_CASES[request.param]
    problem = tpu_sdpa.read_sdpa(FIX + fname)
    bp = tpu_presolve.presolve(problem, TpuParams()).buckets[0]
    jbk = tpu_pat.build_bucket_data(bp, problem.m, jnp.float64)
    tbk = t_pat.build_bucket_data(bp, problem.m, torch.float64, "cpu")
    if block is not None:
        assert bp.B == 1     # lorads_tpu's bucket is the block
        tbk = t_pat.bucket_slice(tbk, block)
    n, r = tbk.n, bp.rank
    rng = np.random.default_rng(21)
    F = 0.3 * rng.standard_normal((1, n, r))
    x0 = 0.1 * rng.standard_normal((1, n, r))
    b = rng.standard_normal((1, n, r))
    Fj = jnp.asarray(F)
    return (request.param, _jop(jbk, Fj),
            _jop(tpu_pat.cast_floats(jbk), Fj.astype(jnp.float32)),
            tbk, t_pat.cast_floats(tbk, torch.float32), F, x0, b)


def _port_cg(case, tol, ir):
    _, _, _, tbk, tbk_lo, F, x0, b = case
    if ir:
        op_lo = t_cg.Bound(t_admm._cg_operator(tbk_lo),
                           (_t(F, torch.float32),), devloop.ident(tbk_lo))
        return t_cg.cg_solve_ir(t_admm._cg_operator(tbk, _t(F)), op_lo,
                                _t(x0), _t(b), tol, 800)
    op = t_cg.Bound(t_admm._cg_operator(tbk), (_t(F),), devloop.ident(tbk))
    return t_cg.cg_solve(op, _t(x0), _t(b), tol, 800)


@pytest.mark.parametrize("ir", [False, True], ids=["cg", "cg_ir"])
def test_cg_chunks_match_single_steps(cg_case, ir):
    """The solve run at the top (a host read of the exit test before each
    iteration or pass) gives the solve nested in a device-decided step
    (the ADMM iteration's path, its count a 0-d tensor) bit for bit,
    iteration count included."""
    x1, k1 = _port_cg(cg_case, 1e-8, ir)
    with devloop._stepping():
        xk, kk = _port_cg(cg_case, 1e-8, ir)
    assert isinstance(kk, torch.Tensor) and int(kk) == k1 > 0
    assert torch.equal(xk, x1)


def test_cg_chunks_match_lorads_tpu(cg_case, tol=1e-8):
    """cg_solve and cg_solve_ir against lorads_tpu's on the
    same numpy inputs: equal counts; cg_solve's x within 1e-11 of the
    solution's largest entry (f64 sums in two orders: an error relative
    to the terms' scale, not to each entry), cg_solve_ir's within what
    the stop test leaves
    (its f32 sweeps round differently: ||x_t - x_j|| <= ||r_t|| +
    ||r_j||, op = I + PSD)."""
    _, jhi, jlo, _, _, _, x0, b = cg_case
    jx, jk = tpu_cg.cg_solve(jhi, jnp.asarray(x0), jnp.asarray(b), tol, 800)
    tx, tk = _port_cg(cg_case, tol, False)
    assert tk == int(jk) > 0
    jx = np.asarray(jx)
    assert np.abs(tx.numpy() - jx).max() <= 1e-11 * np.abs(jx).max()
    jx, jk = tpu_cg.cg_solve_ir(jhi, jlo, jnp.asarray(x0), jnp.asarray(b),
                                tol, 800)
    tx, tk = _port_cg(cg_case, tol, True)
    assert tk == int(jk) > 0
    jx = np.asarray(jx)
    tbk, F = cg_case[3], cg_case[5]
    r_t = float(torch.linalg.vector_norm(
        _t(b) - t_admm._cg_operator(tbk)(tx, _t(F))))
    r_j = float(np.linalg.norm(np.asarray(b) - np.asarray(
        jhi(jnp.asarray(jx)))))
    l1b = np.abs(b).sum()
    assert r_t / l1b < tol and r_j / l1b < tol
    assert np.linalg.norm(tx.numpy() - jx) <= r_t + r_j


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _cg_steps(loop, state, start, n):
    """``n`` CG iterations from ``state``, the first at ``start``."""
    for p in range(start, start + n):
        state = loop.step(loop.inputs, state, loop.kind(p))
    return state


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_masked_cg_step_is_a_no_op(bad):
    """A done block whose direction p holds inf or NaN: its x, r and p
    stay the same bit for bit, the live block advances as it does
    alone, and once every block is done the loop runs no iteration: the
    state, its count included, comes back as it was."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((2, 6, 6))
    M = _t(np.einsum("bij,bkj->bik", M, M) + 6 * np.eye(6))
    b = _t(rng.standard_normal((2, 6, 2)))
    loop = t_cg.cg_loop(lambda y: torch.matmul(M, y), torch.zeros_like(b),
                        b, 1e-12, 800)
    x, r, p, done, best, since, k = loop.state
    p = p.clone()
    p[1] = bad
    loop.state = (x, r, p, torch.tensor([False, True]), best, since, k)
    st = _cg_steps(loop, loop.state, 0, 3)
    for new, old in zip(st[:3], loop.state[:3]):
        assert _same_bits(new[1], old[1])
    assert bool(torch.isfinite(st[0]).all()) and int(st[6]) == 3
    alone = t_cg.cg_loop(lambda y: torch.matmul(M[:1], y),
                         torch.zeros_like(b[:1]), b[:1], 1e-12, 800)
    assert _same_bits(st[0][0], _cg_steps(alone, alone.state, 0, 3)[0][0])
    # every block done: nothing moves, the count included
    loop.state = st[:3] + (torch.tensor([True, True]),) + st[4:]
    assert not bool(loop.running(loop.inputs, loop.state))
    for new, old in zip(devloop.run(loop)[0], loop.state):
        assert _same_bits(new, old)


# ---------------------------------------------------------------------------
# Counters.
# ---------------------------------------------------------------------------

def test_host_read_labels_and_reset():
    t_dev.reset_host_syncs()
    t_dev.host_read(torch.ones(()), "cg")
    t_dev.host_read(torch.ones(2), "alm_inner")
    t_dev.host_read(torch.ones(2), "alm_inner")
    assert t_dev.HOST_SYNCS == 3
    assert t_dev.HOST_SYNCS_BY["alm_inner"] == 2
    assert t_dev.HOST_SYNCS_BY["cg"] == 1
    with pytest.raises(KeyError):
        t_dev.host_read(torch.ones(()), "nowhere")
    t_dev.reset_host_syncs()
    assert t_dev.HOST_SYNCS == 0
    assert not any(t_dev.HOST_SYNCS_BY.values())


def test_launches_recorded_count_per_replay():
    """A launch inside ``recording`` (a graph's capture) is not counted
    there; each ``replayed`` adds the graph's launches."""
    kernels.reset_launches()
    with kernels.recording() as tally:
        kernels._bump("launches", "adj_a_offdiag")
        kernels._bump("launches", "wmul_csr", 2)
        kernels._bump("one_dot", "uvt_split")
    assert kernels.LAUNCHES["adj_a_offdiag"] == 0
    for _ in range(3):
        kernels.replayed(tally)
    assert kernels.LAUNCHES["adj_a_offdiag"] == 3
    assert kernels.LAUNCHES["wmul_csr"] == 6
    assert kernels.ONE_DOT_LAUNCHES["uvt_split"] == 3
    assert kernels.GRAPHS == {"captured": 0, "replayed": 3, "launches": 9}
    kernels._bump("launches", "adj_a_offdiag")
    assert kernels.LAUNCHES["adj_a_offdiag"] == 4
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())
    assert not any(kernels.GRAPHS.values())


def test_cpu_reads_by_label():
    """On the CPU a CG solve reads its exit test before each iteration
    and after the last, and its pack once (label cg)."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((1, 8, 8))
    M = _t(np.einsum("bij,bkj->bik", M, M) + 8 * np.eye(8))
    b = _t(rng.standard_normal((1, 8, 3)))
    op = lambda x: torch.matmul(M, x)  # noqa: E731
    t_dev.reset_host_syncs()
    _, k = t_cg.cg_solve(op, torch.zeros_like(b), b, 1e-12, 800)
    assert t_dev.HOST_SYNCS_BY["cg"] == t_dev.HOST_SYNCS == k + 2
