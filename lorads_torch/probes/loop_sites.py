"""Every exit test and branch predicate that loop_cond evaluates, with
seeded adversarial states, for holding the recorded programs to torch.

``sites(device, dtype)`` builds each device-decided loop of the port as
the solver builds it (a small Max-Cut solver gives the ALM, ADMM and
CGNR loops their real inputs and states; CG, the refinement passes,
Lanczos, the active set, ``devloop.repeat`` and the two branches are
built on small tensors of the dtypes their callers pass) and returns
each as a ``Site``: its test ``fn`` and the argument trees it reads.
``seeded(site, rng)`` replaces every tensor the test reads by one of the
same dtype and shape whose elements come from a small pool: the
program's own numbers, their neighbours one ulp or one unit away, 0, ±1,
NaN and ±inf, so that ties at each tolerance, the iteration caps and
NaN reach every comparison.  ``check(site, trials, rng)`` records the
program of each seeded state and holds ``Program.plain`` (and, on CUDA
tensors, ``kernels.loop_cond``: its decision, its copies of the state's
leaves and its counter) to ``fn`` bit for bit.  tests/test_torch_loop_cond.py
runs it on the CPU, chip_smoke.py on the card.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from lorads_torch.alg import devloop, looptest
from lorads_torch.ops import kernels


@dataclasses.dataclass
class Site:
    """A test ``fn(*args)`` of the loop ``name`` (at ``where``, a line of
    the port); ``args[state]`` is the loop's state (None: a branch)."""

    name: str
    where: str
    fn: Callable
    args: tuple
    state: Optional[int] = 1


def _solver(device, dtype):
    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.io import generators
    return LoradsSolver(
        generators.maxcut(n=24, avg_degree=4, seed=1),
        LoradsParams(verbose=False,
                     dtype="f32" if dtype == torch.float32 else "f64"),
        device=device)


def _alm_sites(s):
    from lorads_torch.alg import alm
    p, pd = s.params, s.pd
    carry, fixed = alm.alm_start(
        pd, p, s.R, s.dual, s.hist, alm.ALMStats(rho=s.ps.rho0),
        s.scale_obj_his, s.is_rank_max(), p.alm_rho_factor,
        s.max_alm_sub_iter, 4, p.max_alm_iter)

    def i(v, dt=torch.int64):
        return devloop.scalar(v, dt, pd.rhs.device)
    out = []
    inputs = alm.ALMInputs(budget=i(2 ** 30), grind_armed=i(True, torch.bool),
                           **fixed)
    loop = alm.outer_loop(pd, inputs, carry)
    out.append(Site("alm_outer", "alm.py:535", loop.running,
                    (loop.inputs, loop.state)))
    for check in (True, False):
        loop = alm.inner_loop(
            pd, carry.R, carry.grad, carry.hist, carry.dual,
            carry.constr_sum, carry.cert_val, carry.rho, 0.1, 1e-3, 1e-6,
            p.phase1_tol, True, 40, check_pinf_conv=check)
        out.append(Site("alm_inner" + ("" if check else " (reopt)"),
                        "alm.py:155", loop.running,
                        (loop.inputs, loop.state)))
    zero = torch.zeros_like(carry.k)
    m = alm._Middle(
        R=carry.R, grad=carry.grad, hist=carry.hist, caches=carry.caches,
        dual=carry.dual, constr_sum=carry.constr_sum,
        cert_val=carry.cert_val, pinf_l1=carry.pinf_l1,
        tau=torch.zeros_like(carry.tau),
        best_cert=torch.full_like(carry.cert_val, float("inf")),
        no_improve=zero, ema_cur=torch.zeros_like(carry.tau),
        ema_old=torch.zeros_like(carry.tau), ema_n=zero + 1,
        iter_counter=zero + 1, total_inner=zero, rank_flag=carry.rank_flag,
        difficulty=zero + alm.HARD, exit=zero + alm.M_RUNNING)
    go = torch.ones((), dtype=torch.bool, device=zero.device)
    loop = alm._middle_loop(pd, m, (carry.rho, 0.1 / carry.rho, fixed[
        "end_sub_tol"], fixed["end_tau_tol"], fixed["phase1_tol"], go,
        carry.max_sub, fixed["rank_flag_thres"], go, go), True, False, 25)
    out.append(Site("alm_middle", "alm.py:335", loop.running,
                    (loop.inputs, loop.state)))
    loop = alm._rho_loop(pd, m, carry.rho, carry.rho_factor, go)
    out.append(Site("alm_rho", "alm.py:414", loop.running,
                    (loop.inputs, loop.state)))
    it = torch.zeros((), dtype=torch.int64, device=zero.device)
    out.append(Site("alm_refresh", "alm.py:136", alm.refresh_due(25), (it,),
                    None))
    return out


def _admm_site(s):
    from lorads_torch.alg import admm
    from lorads_torch.alg.admm import ADMMStats
    from lorads_torch.alg.alm import ALMStats
    stats = ADMMStats(rho=s.ps.rho0)
    s.alm_to_admm(ALMStats(rho=s.ps.rho0), stats)
    locals_, total, vals = admm.admm_init_eval(s.pd, s.U, s.V, s.dual,
                                               s.scale_obj_his)
    s._set_admm_stats(stats, vals)
    c = s._admm_start(stats, locals_, total)
    _, loop = admm.prepare_chunk(s.params, s.pd, c, s.scale_obj_his,
                                 s.params.max_admm_iter, 10,
                                 jacobi=s._bucket_jacobi, S=s.S)
    return Site("admm", "admm.py:556", loop.running,
                (loop.inputs, loop.init(loop.inputs, loop.state)))


def sites(device="cpu", dtype=torch.float64) -> list:
    """Every site of loop_cond's programs, built on ``device`` at
    ``dtype``."""
    from lorads_torch.alg import cg, dualrefine, lanczos, spectral_repair
    dev = torch.device(device)
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=dev)
    out = []
    loop = cg.cg_loop(lambda x: x, t(3, 4, 2), t(3, 4, 2), 1e-6, 50)
    out.append(Site("cg", "cg.py:94", loop.running, (loop.inputs, loop.state)))
    loop = cg.ir_loop(lambda x: x, lambda x: x, t(3, 4, 2), t(3, 4, 2),
                      1e-6, 50)
    out.append(Site("cg_ir", "cg.py:197", loop.running,
                    (loop.inputs, loop.state)))
    k = torch.zeros((), dtype=torch.int64, device=dev)
    out.append(Site("cg_restart", "cg.py:50", cg.restart_due, (k,), None))
    s = _solver(dev, dtype)
    out += _alm_sites(s)
    out.append(_admm_site(s))
    loop = dualrefine.cgnr_loop(s.pd, s.R, s.dual, 20)
    out.append(Site("cgnr", "dualrefine.py:83", loop.running,
                    (loop.inputs, loop.state)))
    for B in (1, 3):
        loop = lanczos.lanczos_loop(lambda x: x, t(B, 8), k=4, maxit=40)
        out.append(Site(f"lanczos B={B}", "lanczos.py:158", loop.running,
                        (loop.inputs, loop.state)))
    loop = spectral_repair.active_set_loop(
        None, t(1, 6, 4), torch.ones((1, 4), dtype=dtype, device=dev),
        t(5), t(5), 0.1, 0.01)
    out.append(Site("active_set", "spectral_repair.py:247", loop.running,
                    (loop.inputs, loop.state)))
    j = torch.zeros((), dtype=torch.int64, device=dev)
    out.append(Site("repeat", "devloop.py:489", devloop.count_test(36),
                    ((), (j, t(2))), 1))
    return out


def _tested(site):
    """(program on the site's tensors, the tensors it reads)."""
    prog = looptest.record(site.fn, site.name, site.args, site.state)
    st = (devloop.flatten(site.args[site.state])[0]
          if site.state is not None else None)
    return prog, prog.leaves(st)


def _pool(prog, dtype):
    """The values a seeded element of ``dtype`` takes: the program's
    numbers and their neighbours, 0, ±1, and for floats NaN, ±inf and
    the type's largest."""
    nums = {0, 1, -1, 2}
    for n in prog.nodes:
        nums.update(a for a in n.args if isinstance(a, (int, float))
                    and not isinstance(a, bool))
    if dtype == torch.bool:
        return np.array([False, True])
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        vals = {int(v) + d for v in nums if math.isfinite(v)
                for d in (-1, 0, 1)}
        return np.array(sorted(v for v in vals if info.min <= v <= info.max),
                        dtype=np.int64)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    vals = set()
    with np.errstate(over="ignore"):
        for v in nums:
            x = npdt(v)
            vals.update((x, np.nextafter(x, npdt(np.inf)),
                         np.nextafter(x, npdt(-np.inf))))
    vals.update((npdt(np.nan), npdt(np.inf), npdt(-np.inf),
                 np.finfo(npdt).max, npdt(0.5), npdt(1.5)))
    return np.array(sorted(vals, key=lambda x: (np.isnan(x), x)), dtype=npdt)


def seeded(site, rng):
    """The site with each tensor its test reads, or half of them at
    random, replaced by a seeded one (same dtype, shape and device;
    elements drawn from _pool, one small draw of the pool a leaf, so that
    leaves meet in ties; the others keep the loop's own values, so that
    both outcomes occur)."""
    prog, leaves = _tested(site)
    new = {}
    for t in leaves:
        if id(t) in new:
            continue
        if rng.random() < 0.5:      # half the leaves keep their value
            new[id(t)] = t
            continue
        pool = _pool(prog, t.dtype)
        pick = rng.choice(pool, size=min(len(pool), 4), replace=False)
        vals = rng.choice(pick, size=tuple(t.shape))
        new[id(t)] = torch.as_tensor(np.asarray(vals), dtype=t.dtype,
                                     device=t.device)
    args = []
    for a in site.args:
        ls, layout = devloop.flatten(a)
        args.append(devloop.unflatten(layout, [new.get(id(x), x)
                                               for x in ls]))
    return dataclasses.replace(site, args=tuple(args))


def _bytes(t):
    return t.reshape(-1).view(torch.uint8) if t.numel() else t.reshape(-1)


def check(site, trials: int, rng) -> dict:
    """``trials`` seeded states of ``site``: the program's plain version
    against the test itself, and on CUDA tensors the kernel's decision,
    copies (every leaf of the state or the arguments into fresh buffers)
    and counter against the plain version's, each bit for bit; raises
    AssertionError on the first difference -> {"trials", "true", "ops",
    "launch_ms"}."""
    n_true, ops, ms = 0, 0, []
    for j in range(trials):
        s = seeded(site, rng)
        prog, leaves = _tested(s)
        ops = len(prog.table()[0])
        want = s.fn(*s.args)
        got = prog.plain(leaves)
        if got.dtype != torch.bool or not torch.equal(got, want.reshape(())):
            raise AssertionError(f"{site.name} #{j}: plain {got} != test "
                                 f"{want}")
        n_true += bool(want)
        if not leaves[0].is_cuda:
            continue
        srcs = devloop.flatten(s.args[s.state] if s.state is not None
                               else s.args)[0]
        srcs = [x.contiguous() for x in srcs]
        dst_k = [torch.full_like(x, 7) for x in srcs]
        dst_p = [torch.full_like(x, 7) for x in srcs]
        ctr = torch.zeros(2, dtype=torch.int64, device=srcs[0].device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk = kernels.loop_cond(prog, leaves, list(zip(srcs, dst_k)), ctr[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        dp = kernels.loop_cond_plain(prog, leaves, list(zip(srcs, dst_p)),
                                     ctr[1])
        if not torch.equal(dk, dp) or int(ctr[0]) != 1 or int(ctr[1]) != 1:
            raise AssertionError(f"{site.name} #{j}: kernel {dk}, plain "
                                 f"{dp}, counters {ctr.tolist()}")
        for a, b in zip(dst_k, dst_p):
            if not torch.equal(_bytes(a), _bytes(b)):
                raise AssertionError(f"{site.name} #{j}: a copy differs")
    return {"trials": trials, "true": n_true, "ops": ops,
            "launch_ms": float(np.median(ms)) if ms else None}
