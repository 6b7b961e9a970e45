"""One rank of tests/test_torch_sharded.py's process groups.

Imports lorads_torch (and torch, numpy) only: the test spawns its ranks
with the ``spawn`` start method and hands them their inputs as .npz files
(``save_problem``, ``save_arrays``); each rank joins a gloo group over a
FileStore, runs the tasks it is given and writes its results to an .npz
file of its own.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_BLOCK = ("obj_row", "obj_col", "obj_val", "a_con", "a_row", "a_col",
          "a_val")


def save_problem(path, problem) -> None:
    """An SDPProblem-like (either package's) as .npz (no LP block)."""
    arrs = {"m": problem.m, "rhs": np.asarray(problem.rhs),
            "dims": np.asarray([b.dim for b in problem.blocks])}
    for i, b in enumerate(problem.blocks):
        for k in _BLOCK:
            arrs[f"b{i}_{k}"] = np.asarray(getattr(b, k))
    np.savez(path, **arrs)


def load_problem(path):
    from lorads_torch.core.problem import SDPBlockData, SDPProblem
    with np.load(path) as z:
        m = int(z["m"])
        blocks = [SDPBlockData(dim=int(d), m=m, **{
            k: z[f"b{i}_{k}"] for k in _BLOCK})
            for i, d in enumerate(z["dims"])]
        return SDPProblem(m=m, rhs=z["rhs"], blocks=blocks)


def _solver(in_dir, name, **kw):
    from lorads_torch.alg.solver import LoradsSolver
    from lorads_torch.config import LoradsParams
    return LoradsSolver(load_problem(f"{in_dir}/{name}.npz"),
                        LoradsParams(verbose=False, **kw), device="cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def task_step(in_dir, mesh):
    """sharded_solver_step on this rank's blocks."""
    from lorads_torch.alg.state import FactorVec
    from lorads_torch.parallel.sharded import sharded_solver_step
    s = _solver(in_dir, "step")
    with np.load(f"{in_dir}/step_in.npz") as z:
        U = FactorVec((_t(z["U"]),), _t(np.zeros(0)))
        V = FactorVec((_t(z["V"]),), _t(np.zeros(0)))
        dual, rho = _t(z["dual"]), float(z["rho"])
    U1, V1, total, grad = sharded_solver_step(mesh, s.pd, U, V, dual, rho)
    return dict(U1=U1, V1=V1, total=total, grad=grad)


def task_sp_grad(in_dir, mesh):
    from lorads_torch.parallel.pattern_sharded import (
        build_pattern_shards, make_sharded_gradient)
    s = _solver(in_dir, "sp_grad")
    with np.load(f"{in_dir}/sp_grad_in.npz") as z:
        U, dual, rho, D = _t(z["U"]), _t(z["dual"]), float(z["rho"]), \
            int(z["D"])
    bk = build_pattern_shards(s.ps.plans[0], s.m, D, torch.float64,
                              device="cpu")
    step = make_sharded_gradient(mesh, bk, s.pd.rhs, s.pd.c_nrm_inf)
    total, grad, cert = step(U, s.pd.rhs, dual, rho)
    return dict(total=total, grad=grad, cert=cert)


def task_tp_grad(in_dir, mesh):
    from lorads_torch.parallel.row_sharded import (
        build_row_shards, make_row_sharded_gradient)
    s = _solver(in_dir, "tp_grad")
    with np.load(f"{in_dir}/tp_grad_in.npz") as z:
        U, dual, rho, D = _t(z["U"]), _t(z["dual"]), float(z["rho"]), \
            int(z["D"])
    rs = build_row_shards(s.ps.plans[0], s.m, D, torch.float64,
                          device="cpu")
    step = make_row_sharded_gradient(mesh, rs, s.pd.c_nrm_inf)
    total, grad, cert = step(U, s.pd.rhs, dual, rho)
    return dict(total=total, grad=grad, cert=cert)


def alm_outer(s) -> dict:
    """One ALM outer iteration (alm_phase with max_alm_iter 1) on solver
    ``s``: the gathered factor, the dual and the stats."""
    from lorads_torch.alg.alm import ALMStats
    st = ALMStats(rho=s.ps.rho0)
    s.alm_phase(st, time.time(), max_alm_iter=1)
    return dict(alm_R=s._gather_fv(s.R).cones[0], alm_dual=s.dual,
                alm_f=np.array([st.rho, st.pobj, st.dobj, st.pinf_l1,
                                st.gap]),
                alm_i=np.array([st.outer_iter, st.inner_iter]))


def admm_chunk_from(s, path) -> dict:
    """An ADMM phase capped at 10 iterations (one chunk) on solver ``s``
    from the state in ``path`` (a whole factor R, the dual and the ADMM
    entry rho, pinf and gap: U = V = R): the gathered iterates, the
    dual and the stats."""
    from lorads_torch.alg.admm import ADMMStats
    from lorads_torch.alg.state import FactorVec
    with np.load(path) as z:
        R = s._local_fv(FactorVec((_t(z["R"]),), s.R.lp))
        s.R = s.U = s.V = R
        s.dual = _t(z["dual"])
        ad = ADMMStats(rho=float(z["rho"]), pinf_l1=float(z["pinf"]),
                       gap=float(z["gap"]))
    s.admm_phase(ad, 10, time.time())
    return dict(admm_U=s._gather_fv(s.U).cones[0],
                admm_V=s._gather_fv(s.V).cones[0], admm_dual=s.dual,
                admm_f=np.array([ad.rho, ad.pobj, ad.dobj, ad.pinf_l1,
                                 ad.gap]),
                admm_i=np.array([ad.iter, s.admm_retries,
                                 s.admm_cg_total]))


def alm_admm_state(s, path, rho_factor: float = 1.0) -> None:
    """Run ``s`` through its ALM phase and write the ADMM entry state for
    admm_chunk_from to ``path``, its rho times ``rho_factor``."""
    from lorads_torch.alg.admm import ADMMStats
    from lorads_torch.alg.alm import ALMStats
    st = ALMStats(rho=s.ps.rho0)
    s.alm_phase(st, time.time())
    ad = ADMMStats(rho=s.ps.rho0)
    s.alm_to_admm(st, ad)
    np.savez(path, R=s.R.cones[0].numpy(), dual=s.dual.numpy(),
             rho=ad.rho * rho_factor, pinf=ad.pinf_l1, gap=ad.gap)


def task_dp_alm(in_dir, mesh):
    return alm_outer(_solver(in_dir, "dp", shard="dp"))


def task_dp_admm(in_dir, mesh):
    return admm_chunk_from(_solver(in_dir, "dp", shard="dp"),
                           f"{in_dir}/dp_state.npz")


def _solve(in_dir, name, mode):
    return _solve_with(_solver(in_dir, name, shard=mode))


def _solve_with(s):
    res = s.solve()
    out = dict(status=np.array(res.status.value),
               pobj=np.array(res.pobj), dual=res.dual,
               note=np.array(s.shard_note))
    for i, x in enumerate(res.R.cones):
        out[f"R{i}"] = x
    return out


def task_solve_sp(in_dir, mesh):
    return _solve(in_dir, "sp", "sp")


def task_solve_tp(in_dir, mesh):
    return _solve(in_dir, "tp", "tp")


def task_solve_dp(in_dir, mesh):
    return _solve(in_dir, "dp", "dp")


def task_solve_dp2(in_dir, mesh):
    """dp with one block a rank: the block scan across the ranks."""
    return _solve(in_dir, "dp2", "dp")


def task_memo_sp(in_dir, mesh):
    """An unsharded solve of the sp instance, then a sharded one of the
    same problem object: the sharded solver takes the unsharded one's
    presolve from the memo and adds its placed data beside the unsharded
    entry, which stays."""
    from lorads_torch.alg.solver import LoradsSolver
    from lorads_torch.config import LoradsParams
    problem = load_problem(f"{in_dir}/sp.npz")

    def solver(**kw):
        return LoradsSolver(problem, LoradsParams(verbose=False, **kw),
                            device="cpu")
    base = solver()
    res0 = base.solve()
    s = solver(shard="sp")
    out = _solve_with(s)
    out.update(base_status=np.array(res0.status.value),
               base_pobj=np.array(res0.pobj),
               same_ps=np.array(s.ps is base.ps),
               unsharded_kept=np.array(
                   s.ps._pd_cache[(torch.float64, torch.device("cpu"))]
                   is base.pd and s.pd is not base.pd),
               memo=np.array(sorted(repr(k[0]) + str(len(k))
                                    for k in s.ps._pd_cache)))
    return out


def task_sp_escalate(in_dir, mesh):
    """An sp solve started at f32: rank augmentation keeps the factors
    [1, n, r'], the f64 escalation rebuilds the shards from the presolve
    (the same bits as an f64 layout built fresh, never the f32 shards
    widened), the memo keys on the layout, and the solve then runs."""
    from lorads_torch.ops import pattern as pat
    from lorads_torch.parallel.pattern_sharded import build_pattern_shards
    s = _solver(in_dir, "sp", shard="sp", dtype="f32")
    r0 = s.ranks[0]
    s.aug_rank(1.5)
    out = dict(ranks=np.array([r0, s.ranks[0]]),
               R_rows=np.array(s.R.cones[0].shape[0]))
    s._auto_dtype = True
    out["escalated"] = np.array(s.maybe_escalate_f64("test"))
    bk = s.pd.buckets[0]
    fresh = pat.local_bucket(build_pattern_shards(
        s.ps.plans[0], s.m, mesh.size, torch.float64, summed=True,
        device="cpu"), mesh)
    out["same_bits"] = np.array(all(
        torch.equal(getattr(bk, k), getattr(fresh, k))
        for k in pat.FLOAT_FIELDS + pat.SYM_FLOAT_FIELDS + ("a_val_d_full",)))
    out["summed_f64"] = np.array(bk.summed and bk.dtype == torch.float64
                                 and s.dual.dtype == torch.float64)
    out["memo"] = np.array(sorted(repr(k[0]) + str(len(k))
                                  for k in s.ps._pd_cache))
    res = s.solve()
    out.update(status=np.array(res.status.value),
               pinf=np.array(res.pinf_l1))
    return out


def task_dp_checkpoint(in_dir, mesh):
    """A dp solver's checkpoint: every rank gathers the state and rank 0
    writes it (``dp_ck.npz``); a dp solver of another seed that loads it
    takes this rank's blocks of it."""
    import torch.distributed as dist
    s = _solver(in_dir, "dp", shard="dp")
    path = f"{in_dir}/dp_ck.npz"
    s.save(path)
    dist.barrier()
    t = _solver(in_dir, "dp", shard="dp", seed=7)
    t.load(path)
    return dict(R_local=s.R.cones[0], loaded_same=np.array(
        torch.equal(t.R.cones[0], s.R.cones[0])
        and torch.equal(t.dual, s.dual)))


def task_tp_placed(in_dir, mesh):
    """A tp solver's data on this rank after construction: the shape of
    every n x n-sized tensor of its buckets and the memo's keys (the
    placed layout alone, no whole bucket)."""
    s = _solver(in_dir, "tp", shard="tp")
    bk = s.pd.buckets[0]
    return dict(c_full=np.array(bk.c_full.shape),
                n=np.array(bk.n), rowshard=np.array(bk.rowshard),
                memo=np.array(sorted(repr(k[0]) + str(len(k))
                                     for k in s.ps._pd_cache)))


def task_all_reduce(in_dir, mesh):
    from lorads_torch.parallel import comm
    t = torch.full((4,), float(mesh.index + 1), dtype=torch.float64)
    return dict(sum=comm.all_reduce(t, mesh, "test"),
                gather=comm.all_gather(t[None], mesh, "test"))


def run(rank: int, world: int, store: str, in_dir: str, tasks: list,
        out: str) -> None:
    """Join the gloo group over the FileStore ``store``, run ``tasks``
    (names of task_* functions) and write {task.key: array} to ``out``,
    with each task's collective counts ({task.comm.site: calls})."""
    import torch.distributed as dist

    from lorads_torch.parallel import comm, distributed
    torch.set_num_threads(1)
    distributed.init_multihost(store=dist.FileStore(store, world),
                               rank=rank, world_size=world, device="cpu")
    try:
        mesh = distributed.solver_mesh(None, "cpu")
        res = {}
        for name in tasks:
            comm.reset()
            t0 = time.time()
            got = globals()[f"task_{name}"](in_dir, mesh)
            for k, v in got.items():
                if isinstance(v, torch.Tensor):
                    v = v.detach().numpy()
                res[f"{name}.{k}"] = np.asarray(v)
            for k, (calls, _) in comm.counts().items():
                res[f"{name}.comm.{k}"] = np.array(calls)
            res[f"{name}.seconds"] = np.array(time.time() - t0)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()
