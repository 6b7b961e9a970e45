"""Where lorads_torch and lorads_tpu part on multi-block solves with CG.

The two multi-block instances whose whole solves agree with lorads_tpu
only to ~2e-6 (tests/test_torch_multiblock.py,
tests/test_torch_split_multiblock.py), bisected on the CPU at f64 with
both packages' own paths:

* random_multiblock(3 blocks of dim 15, m=12, 4 LP columns, seed 13):
  the ALM paths agree through their exit; the first CG solve of the
  first ADMM sweep (block 0's U update, whose mixed-precision CG runs
  its sweeps at f32) is where the counts first differ: 16 inner
  iterations in lorads_tpu, 17 in the port, with solutions 2e-6 apart.
  Its f32 right-hand sides agree to two f32 ulps.  At lorads_tpu's
  stop the test's quantity (the residual over ||b||_1 and tol) is 0.65
  in lorads_tpu and 1.24 in the port, and lorads_tpu's own moves to
  0.93 when its right-hand side moves by one f32 ulp: the stop decision
  lies within summation-order error of the tolerance.
* the split two-block matrix completion parts before any CG, in ALM
  outer 5 (tests/test_torch_split_multiblock.py).

So both part by summation order, amplified by the f32 inner CG and by
ALM's L-BFGS steps (as the merged Max-Cut batch does,
test_merged_maxcut_batch_parts_by_summation_order), not by a port fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lorads_tpu.alg import cg as tpu_cg
from lorads_tpu.alg.solver import LoradsSolver as TpuSolver
from lorads_tpu.config import LoradsParams as TpuParams
from lorads_tpu.io import generators as tpu_gen
from lorads_torch.alg import cg as t_cg
from lorads_torch.alg.solver import LoradsSolver as TorchSolver
from lorads_torch.config import LoradsParams as TorchParams


class _Stop(Exception):
    """Ends a solve once its first inner CG solve has been captured."""


def _first_inner_solve_tpu(problem):
    """lorads_tpu's first inner (f32) CG solve of its first ADMM sweep:
    (op, x0, b, tol, max_iter), its first ADMM chunk run without jit so
    that the call can be captured."""
    js = TpuSolver(problem, TpuParams(verbose=False))
    seen = {}
    chunk = js._admm_chunk

    def spy(op, x0, b, tol, max_iter):
        seen["args"] = (op, x0, b, tol, max_iter)
        raise _Stop

    def first(*a, **k):
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            mp.setattr(tpu_cg, "cg_solve", spy)
            return chunk(*a, **k)

    js._admm_chunk = first
    with pytest.raises(_Stop):
        js.solve()
    return seen["args"]


def _first_inner_solve_torch(problem):
    ts = TorchSolver(problem, TorchParams(verbose=False), device="cpu")
    seen = {}

    def spy(op, x0, b, tol, max_iter):
        seen["args"] = (op, x0, b, tol, max_iter)
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_cg, "cg_solve", spy)
        with pytest.raises(_Stop):
            ts.solve()
    return seen["args"]


def test_multiblock_cg_parts_by_summation_order():
    problem = tpu_gen.random_multiblock(n_blocks=3, dim=15, m=12, n_lp=4,
                                        seed=13)
    jop, jx0, jb, jtol, jmax = _first_inner_solve_tpu(problem)
    top, tx0, tb, ttol, tmax = _first_inner_solve_torch(problem)
    assert (float(jtol), int(jmax)) == (ttol, tmax) == (1e-5, 800)
    assert jb.dtype == jnp.float32 and tb.dtype == torch.float32
    b = np.asarray(jb)
    # the same right-hand side to two f32 ulps (CPU: 72 of 75 equal)
    ulps = np.abs(tb.numpy().view(np.int32) - b.view(np.int32))
    assert ulps.max() <= 2
    xj, kj = tpu_cg.cg_solve(jop, jx0, jb, jtol, jmax)
    xt, kt = t_cg.cg_solve(top, tx0, tb, ttol, tmax)
    assert (int(kj), kt) == (16, 17)
    # the stop test's quantity, the true residual over ||b||_1 and tol,
    # after lorads_tpu's 16 iterations: within summation-order error of
    # 1 -- lorads_tpu's own moves by 44 % when b moves by one f32 ulp
    # (CPU: 0.648, and 0.933 / 0.930 for b moved up / down; the port
    # 1.241, so it takes one more iteration)

    def j_ratio(x, bb):
        r = bb - jop(x)
        return float(jnp.sqrt(jnp.sum(r * r)) / jnp.sum(jnp.abs(bb)) / jtol)

    k = int(kj)
    ratio_j = j_ratio(tpu_cg.cg_solve(jop, jx0, jb, jtol, k)[0], jb)
    r = tb - top(t_cg.cg_solve(top, tx0, tb, ttol, k)[0])
    ratio_t = float(torch.sqrt(torch.sum(r * r)) / torch.sum(torch.abs(tb))
                    / ttol)
    moved = []
    for d in (np.inf, -np.inf):
        ju = jnp.asarray(np.nextafter(b, np.float32(d)))
        moved.append(j_ratio(tpu_cg.cg_solve(jop, jx0, ju, jtol, k)[0], ju))
    assert ratio_j < 1 < ratio_t < 2
    assert all(0.5 < m < 1 for m in moved)
    assert max(abs(m / ratio_j - 1) for m in moved) > 0.2
    # the solutions themselves agree to the CG's tolerance
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()
