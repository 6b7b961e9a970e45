"""Solver orchestration (port of lorads_tpu/alg/solver.py).

Pipeline (reference main.c:263-520):

  presolve -> rank policy -> random init -> Phase I (ALM) ->
  handoff -> Phase II (ADMM) -> reopt level 1 -> dual infeasibility ->
  reopt level 2 (x2) -> status classification -> report.

The port covers any number of buckets of any number of blocks -- split
sparse (Max-Cut's diag-identity cone and the general sparse path of
matrix completion) or dense (Lovász theta, general multi-block SDPs) --
on local or global constraint slots, with or without an LP block, at
f64 or f32 on one device; several instances merged by
``merge_problems`` solve as one batch.  Buckets whose blocks touch
disjoint constraints sweep their blocks at once in ADMM
(``_bucket_jacobi``), the others in sequence.  A failing dinf without
an LP block takes the spectral dual repair (alg/spectral_repair.py),
then, if that is not accepted, the CGNR dual refinement
(alg/dualrefine.py).  The DUAL_U_V ADMM variant
(``dual_uv``), the FIX_INI_POINT start and step trace
(``fix_init_point``), checkpoints at the phase boundaries
(``checkpoint_path``, utils/checkpoint.py), solution export and warm
starts (``save_solution``, ``set_initial_factors``) are lorads_tpu's.
``dtype="f32"`` solves at float32 throughout; ``dtype="auto"`` starts
at float64 on the CPU and on the card alike (the H100 runs f64
natively; lorads_tpu starts f32 only where f64 is emulated), and an
auto solve that was started at f32 (``_auto_dtype`` set, as lorads_tpu's
tests do) escalates to f64 at lorads_tpu's hooks
(``maybe_escalate_f64``).  ``shard`` (``dp``, ``sp``, ``tp``, ``auto``)
places buckets on the mesh of the ranks of the default process group
(lorads_tpu's GSPMD placement as explicit collectives, parallel/comm.py;
``_maybe_shard``); with fewer than 2 ranks the solve runs unsharded.
Initial factors and certificate start vectors come from the same
``np.random.default_rng`` stream, in the same order, as in lorads_tpu,
so both packages start from the same point.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from lorads_torch import device as dev
from lorads_torch.alg import admm as admm_mod
from lorads_torch.alg import alm as alm_mod
from lorads_torch.alg import aop, devloop
from lorads_torch.alg.admm import ADMMStats
from lorads_torch.alg.alm import ALMStats
from lorads_torch.alg.dualrefine import dual_ls_refine
from lorads_torch.alg.lanczos import lanczos_loop, lanczos_result
from lorads_torch.alg.spectral_repair import try_spectral_repair
from lorads_torch.alg.state import FactorVec, make_history
from lorads_torch.config import LoradsParams, SolverStatus
from lorads_torch.core.presolve import Presolved, presolve
from lorads_torch.core.problem import SDPProblem
from lorads_torch.ops import lp as lp_ops
from lorads_torch.ops import pattern as pat
from lorads_torch.parallel import comm


@dataclasses.dataclass
class SolveResult:
    status: SolverStatus
    pobj: float
    dobj: float
    pinf_l1: float
    pinf_inf: float
    dinf_l1: float
    dinf_inf: float
    gap: float
    alm_stats: ALMStats
    admm_stats: ADMMStats
    solve_time: float
    dual_infeas_time: float
    ranks: List[int]
    R: FactorVec                       # X = R R^T (averaged factors)
    dual: np.ndarray


SHARD_MODES = ("off", "auto", "dp", "sp", "tp")


def _check_params(p: LoradsParams) -> None:
    if p.shard not in SHARD_MODES:
        raise ValueError(f"shard={p.shard!r} is not one of {SHARD_MODES}")


def shard_choice(mode: str, nd: int, buckets):
    """Which buckets (presolve BucketPlans) each layout takes on an
    ``nd``-rank mesh -> (dp, sp, tp) lists of bools: lorads_tpu's rules
    (solver.py:207-228).  dp: the blocks divide over the ranks; sp: one
    large sparse cone (K >= 16 nd); tp: one dense cone, any with
    n >= 2 nd when asked for, from n >= 4096 under auto."""
    dp_ok = [mode in ("auto", "dp") and bp.B % nd == 0 and bp.B >= nd
             for bp in buckets]
    sp_ok = [mode in ("auto", "sp") and not dp and not bp.dense
             and bp.B == 1 and bp.K >= 16 * nd
             for bp, dp in zip(buckets, dp_ok)]
    tp_ok = [bp.dense and bp.B == 1 and not dp and not sp
             and ((mode == "tp" and bp.n >= 2 * nd)
                  or (mode == "auto" and bp.n >= 4096))
             for bp, dp, sp in zip(buckets, dp_ok, sp_ok)]
    return dp_ok, sp_ok, tp_ok


class LoradsSolver:
    """Two-phase low-rank SDP solver, PyTorch port (single-block
    slices: split sparse and dense)."""

    def __init__(self, problem: SDPProblem,
                 params: Optional[LoradsParams] = None,
                 device="cuda"):
        self.params = params or LoradsParams()
        _check_params(self.params)
        # the FIX_INI_POINT step trace (alm.TRACE_FIX_INI; solver.py:70);
        # trace_dir is read by the CLI alone (__main__.py), as in
        # lorads_tpu
        alm_mod.TRACE_FIX_INI = bool(self.params.fix_init_point)
        self.problem = problem
        self.device = dev.resolve_device(device)
        self.dtype = dev.resolve_dtype(self.params.dtype)
        # only an "auto" solve escalates to f64 (solver.py:99)
        self._auto_dtype = self.params.dtype == "auto"
        # (reason, seconds) of each escalation taken (maybe_escalate_f64)
        self.escalations = []
        dev.assert_full_precision()
        self.ps: Presolved = presolve(problem, self.params)
        self.m = problem.m
        # the shard layouts, chosen from the presolve's plans before any
        # data reaches the device (_shard_layout, _maybe_shard)
        self._shard_layout()
        self.pd = self._problem_data(self.dtype)
        if self.params.alm_rho_factor is None:
            # structure-based auto (see LoradsParams.alm_rho_factor); a
            # diag-parent's shards stand for their diag-identity cone
            pure_diag = (self.pd.lp is None and bool(self.pd.buckets)
                         and all(bk.diag_ident or bk.diag_parent
                                 for bk in self.pd.buckets))
            self.params = dataclasses.replace(
                self.params, alm_rho_factor=3.0 if pure_diag else 2.0)
        self.scale_obj_his = 1.0
        self.max_alm_sub_iter = 5000          # reference global, alm.c:7
        # last objective / DIMACS values, written by both phases
        # (main.c:459-465 + lorads_solver.c:960-965)
        self.pobj = 1e30
        self.dobj = 1e30
        self.gap = 1e30
        self.pinf_l1 = 1e30
        self.rho_max = self.params.rho_max
        self.ranks = [bp.rank for bp in self.ps.buckets]
        self.rank_maxes = [bp.rank_max for bp in self.ps.buckets]
        # None -> structure-based auto (solver.py:122-133): large
        # dense-mode blocks (the theta shape) take the longer history,
        # pure sparse-pattern problems 3
        self.lbfgs_len = self.params.lbfgs_list_length
        self._lbfgs_auto = self.lbfgs_len is None
        if self.lbfgs_len is None:
            big_dense = any(
                bp.dense and bp.n > self.params.dense_dim_threshold
                for bp in self.ps.buckets)
            self.lbfgs_len = 4 if big_dense else 3
        self.log = print if self.params.verbose else (lambda *a, **k: None)
        total_rows = sum(bp.B * bp.n for bp in self.ps.buckets)
        small = total_rows <= 4096
        self.device_chunk_iters = self.params.device_chunk_iters
        if self.device_chunk_iters is None:
            self.device_chunk_iters = 200 if small else 50
        # ALM outer iterations a run of the device loop (solver.py:144);
        # the host checks the time limit between runs
        self.alm_max_outers = 16 if small else 8
        # ADMM iterations per chunk: 10 at first, doubling up to
        # device_chunk_iters and kept across phases -- lorads_tpu's
        # dispatch sizes whenever its per-iteration wall is small.  The
        # chunk sets the log cadence and the pinf ring buffer's index.
        self._admm_n_dev = min(self.device_chunk_iters, 10)
        # (ProblemData, sweep plan) of the last ADMM phase (_admm_start)
        self._admm_plan = (None, None)
        self._rng = np.random.default_rng(self.params.seed)
        self._ident_dirs = None
        self._gap_push_stalled = False
        # ADMM divergence recoveries taken (admm_phase)
        self.admm_retries = 0
        # CG iterations of every ADMM chunk of the solve (ADMMStats.cg_iter
        # holds the last chunk's, as in lorads_tpu)
        self.admm_cg_total = 0
        # host reads by label made inside the solve's ADMM phases
        self.admm_reads_by = {}
        self._init_vars()
        # the factors' placement (_maybe_shard)
        self._maybe_shard()
        # buckets whose blocks touch pairwise-disjoint constraint sets
        # (merged batches, block-diagonal problems) sweep their blocks
        # at once in ADMM: exactly the Gauss-Seidel update there
        # (solver.py:151-160)
        self._bucket_jacobi = tuple(
            len(bp.plans) > 1 and sum(p.m_loc for p in bp.plans)
            == np.unique(np.concatenate(
                [p.loc2glob for p in bp.plans])).size
            for bp in self.ps.buckets)

    def _problem_data(self, dtype):
        """The ProblemData at ``dtype``, memoized per (presolve, dtype)
        (solver.py:174-186) and, in a sharded solve, per layout: a
        sharded solve keeps only its placed data (_placed).  A solver's
        presolve is its own, so the memo serves checkpoint loads
        (utils/checkpoint.py); an escalation finds no f64 entry and
        builds it from the presolve, never by widening the f32 cast (the
        shard layouts too), and evicts the f32 entry."""
        cache = self.ps.__dict__.setdefault("_pd_cache", {})
        key = (dtype, self.device)
        if self._layout is not None:
            key += (self._layout,)
        if key not in cache:
            cache[key] = (aop.build_problem_data(self.ps, dtype, self.device)
                          if self._layout is None else self._placed(dtype))
        return cache[key]

    # ------------------------------------------------------------------
    # Sharding (solver.py:188-279): the layouts and their placement.
    # ------------------------------------------------------------------

    def _shard_layout(self):
        """Choose the shard layouts (shard_choice, on the presolve's
        plans) on the mesh of the first ``n_devices`` ranks of the default
        process group: ``self._layout`` (nd, dp, sp, tp) and ``self.mesh``,
        or None with fewer than 2 ranks (the solve runs unsharded, as
        lorads_tpu's does on one device, and says so) or no bucket that
        qualifies.  ``self.shard_note`` is the log line."""
        mode = self.params.shard
        self.mesh = self._layout = self.shard_note = None
        if mode == "off":
            return
        from lorads_torch.parallel import distributed
        _, size = distributed.world()
        nd = size if self.params.n_devices is None else min(
            int(self.params.n_devices), size)
        if nd < 2:
            self.shard_note = (f"sharding: shard={mode} on {nd} rank: "
                               "unsharded")
            return
        dp_ok, sp_ok, tp_ok = shard_choice(mode, nd, self.ps.buckets)
        if not any(dp_ok) and not any(sp_ok) and not any(tp_ok):
            self.shard_note = (f"sharding: shard={mode} on {nd} ranks: no "
                               "bucket qualifies, unsharded")
            return
        self.mesh = distributed.solver_mesh(nd, self.device)
        self._layout = (nd, tuple(dp_ok), tuple(sp_ok), tuple(tp_ok))
        self.shard_note = (
            f"sharding: {nd}-device mesh, "
            f"dp buckets {[i for i, ok in enumerate(dp_ok) if ok]}, "
            f"sp buckets {[i for i, ok in enumerate(sp_ok) if ok]}, "
            f"tp buckets {[i for i, ok in enumerate(tp_ok) if ok]}")

    def _maybe_shard(self):
        """Log the layout and place the factors on its mesh: a dp
        bucket's factor blocks split over the ranks (each rank keeps its
        rows of the whole random start), an sp or tp bucket's factors
        whole.  Only rank 0 logs."""
        if self.shard_note is not None and self.is_root:
            self.log(self.shard_note)
        if self._layout is None:
            return
        if not self.is_root:
            self.log = lambda *a, **k: None
        if self.scale_obj_his != 1.0:
            self.pd = aop.scale_objective(self.pd, self.scale_obj_his)
        self.R, self.U, self.V, self.S = (self._local_fv(fv) for fv in (
            self.R, self.U, self.V, self.S))
        self.hist = make_history(self.R, self.lbfgs_len)

    def _placed(self, dtype):
        """The unscaled ProblemData at ``dtype`` with every bucket of the
        layout placed on the mesh: a dp bucket built whole on the host
        and this rank's blocks moved to the device, an sp or tp bucket
        rebuilt from the raw plan on the host as a summed or rowshard
        layout and this rank's shards moved (pattern.local_bucket); the
        other buckets built on the device.  No bucket of the layout is
        ever whole on the device."""
        from lorads_torch.parallel.pattern_sharded import (
            build_pattern_shards)
        from lorads_torch.parallel.row_sharded import build_rowshard_bucket
        nd, dp_ok, sp_ok, tp_ok = self._layout
        buckets = []
        for bp, dp, sp, tp in zip(self.ps.buckets, dp_ok, sp_ok, tp_ok):
            if sp:
                bk = build_pattern_shards(bp.plans[0], self.m, nd, dtype,
                                          summed=True, device="cpu")
            elif tp:
                bk = build_rowshard_bucket(bp.plans[0], self.m, nd, dtype,
                                           device="cpu")
            elif dp:
                bk = pat.build_bucket_data(bp, self.m, dtype, "cpu")
            else:
                buckets.append(pat.build_bucket_data(bp, self.m, dtype,
                                                     self.device))
                continue
            buckets.append(pat.local_bucket(bk, self.mesh, self.device))
        return aop.build_problem_data(self.ps, dtype, self.device,
                                      buckets=tuple(buckets))

    def _dp_meshes(self):
        """Per bucket, the mesh its blocks are split over (dp), or None."""
        return [pat.dp_mesh(bk) for bk in self.pd.buckets]

    def _local_fv(self, fv: FactorVec) -> FactorVec:
        """This rank's blocks of a whole FactorVec's dp cones."""
        return FactorVec(tuple(
            x if m is None else x[bk.b0:bk.b0 + bk.B].contiguous()
            for x, m, bk in zip(fv.cones, self._dp_meshes(),
                                self.pd.buckets)), fv.lp)

    def _gather_fv(self, fv: FactorVec) -> FactorVec:
        """A FactorVec whole on every rank: its dp cones gathered."""
        return FactorVec(tuple(
            x if m is None else comm.all_gather(x, m, "gather_factors")
            for x, m in zip(fv.cones, self._dp_meshes())), fv.lp)

    @contextlib.contextmanager
    def _unplaced(self):
        """Run the body on the whole problem data and gathered factors
        when dp buckets are placed (every rank the same work): the dual
        refinement, checkpoints; the placed state comes back after."""
        if not any(m is not None for m in self._dp_meshes()):
            yield
            return
        saved = (self.pd, self.R, self.U, self.V, self.S, self._layout)
        self.R, self.U, self.V, self.S = (self._gather_fv(fv) for fv in (
            self.R, self.U, self.V, self.S))
        self._layout = None
        # built for the body alone: the memo keeps the placed data only
        self.pd = aop.build_problem_data(self.ps, self.dtype, self.device)
        if self.scale_obj_his != 1.0:
            self.pd = aop.scale_objective(self.pd, self.scale_obj_his)
        try:
            yield
        finally:
            (self.pd, self.R, self.U, self.V, self.S,
             self._layout) = saved

    @property
    def is_root(self) -> bool:
        """Rank 0 of the mesh (or no mesh): the one that logs the report
        and writes files."""
        return self.mesh is None or self.mesh.index == 0

    # ------------------------------------------------------------------
    # Variables.
    # ------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64),
                               device=self.device).to(self.dtype)

    def _rand_factor(self, B, n, r, dims) -> torch.Tensor:
        """U(-1,1) triangular-distribution init (difference of two
        uniforms, LORADS_RANDOM_rk_MAT, lorads_solver.c:361-371);
        padded rows zeroed.  With fix_init_point all ones (FIX_INI_POINT,
        lorads_solver.c:441-445)."""
        if self.params.fix_init_point:
            x = np.ones((B, n, r))
        else:
            x = self._rng.random((B, n, r)) - self._rng.random((B, n, r))
        for b, d in enumerate(dims):
            x[b, d:, :] = 0.0
        return self._tensor(x)

    def _rand_fv(self) -> FactorVec:
        cones = tuple(self._rand_factor(bp.B, bp.n, r, bp.dims)
                      for bp, r in zip(self.ps.buckets, self.ranks))
        n_lp = self.problem.n_lp_cols
        if self.params.fix_init_point:
            # lpFix: e_1 (lorads_solver.c:391-404)
            lp_np = np.zeros(n_lp)
            lp_np[:1] = 1.0
            return FactorVec(cones, self._tensor(lp_np))
        lp = self._tensor(self._rng.random(n_lp) - self._rng.random(n_lp))
        return FactorVec(cones, lp)

    def _init_vars(self):
        self.R = self._rand_fv()
        # U/V start as aliases of R (the handoff overwrites them before
        # ADMM reads them, LORADS_ALMtoADMM, lorads_solver.c:968-1004)
        self.U = self.R
        self.V = self.R
        # the DUAL_U_V consensus term S: SDP cones zero, LP columns drawn
        # after R (lorads_solver.c:588-606, 659-667), never updated; only
        # dual_uv's ADMM reads it
        n_lp = self.problem.n_lp_cols
        self.S = FactorVec(
            tuple(torch.zeros_like(x) for x in self.R.cones),
            self._tensor(self._rng.random(n_lp) - self._rng.random(n_lp)))
        self.dual = torch.zeros((self.m,), dtype=self.dtype,
                                device=self.device)
        self.hist = make_history(self.R, self.lbfgs_len)

    # ------------------------------------------------------------------
    # Dynamic rank augmentation (AUG_RANK, lorads_solver.c:806-906).
    # ------------------------------------------------------------------

    def is_rank_max(self) -> bool:
        """CheckAllRankMax (lorads_solver.c:758-774)."""
        return all(min(math.ceil(r), rm) >= rm
                   for r, rm in zip(self.ranks, self.rank_maxes))

    def _pad_cols(self, x: torch.Tensor, new_r: int) -> torch.Tensor:
        """Append scaled-identity columns (lpRandomDiag,
        lorads_solver.c:776-786)."""
        B, n, r = x.shape
        aug = new_r - r
        if aug <= 0:
            return x
        rr = min(n, aug)
        diag = torch.eye(n, aug, dtype=x.dtype, device=x.device) \
            / math.sqrt(max(rr, 1))
        return torch.cat([x, diag.expand(B, n, aug)], dim=2)

    def aug_rank(self, factor: float = 1.5) -> bool:
        """Grow every bucket's rank by ``factor`` (capped at rank_max);
        returns whether every bucket is now at its cap."""
        new_ranks = [min(math.ceil(r * factor), rm)
                     for r, rm in zip(self.ranks, self.rank_maxes)]
        for i, r_new in enumerate(new_ranks):
            if r_new >= self.rank_maxes[i]:
                self.log(f"**Rank truncated to sqrt(2m) cap on bucket {i}.")

        def pad(fv):
            return FactorVec(tuple(self._pad_cols(x, nr) for x, nr
                                   in zip(fv.cones, new_ranks)), fv.lp)

        self.R, self.U, self.V = pad(self.R), pad(self.U), pad(self.V)
        # S grows by zero columns
        self.S = FactorVec(tuple(
            torch.cat([x, x.new_zeros(x.shape[:2] + (nr - x.shape[2],))],
                      dim=2)
            for x, nr in zip(self.S.cones, new_ranks)), self.S.lp)
        self.ranks = new_ranks
        self.hist = make_history(self.R, self.lbfgs_len)
        return self.is_rank_max()

    # ------------------------------------------------------------------
    # Phase I.
    # ------------------------------------------------------------------

    def alm_phase(self, stats: ALMStats, time_solve_start: float,
                  reopt: bool = False, early_stop: bool = True,
                  rho_update_factor: Optional[float] = None,
                  max_alm_iter: Optional[int] = None) -> str:
        factor = (rho_update_factor if rho_update_factor is not None
                  else self.params.alm_rho_factor)
        while True:
            with devloop.phase():     # the ALM phase's graph
                res = alm_mod.alm_optimize(
                    self.pd, self.params, self.R, self.dual, self.hist,
                    stats, self.scale_obj_his, self.is_rank_max(), factor,
                    time_solve_start, self, reopt=reopt,
                    early_stop=early_stop, max_alm_iter=max_alm_iter,
                    log=self.log)
            self.R, self.dual, self.hist = res.R, res.dual, res.hist
            self.pobj, self.dobj = stats.pobj, stats.dobj
            self.gap, self.pinf_l1 = stats.gap, stats.pinf_l1
            if res.action == "aug_rank":
                if (self._lbfgs_auto and self.lbfgs_len < 4
                        and res.super_outer):
                    self.lbfgs_len = 4
                    self.log("ALM grind outer detected: escalating "
                             "L-BFGS history to 4 with the rank growth")
                self.log(f"increase the rank, factor:1.5 "
                         f"(ranks {self.ranks} -> caps {self.rank_maxes})")
                self.aug_rank(1.5)
                continue
            if res.action == "regrind":
                self.lbfgs_len = 4
                self.hist = make_history(self.R, self.lbfgs_len)
                self.log("ALM grind detected (>=6000 inner "
                         "iterations): escalating L-BFGS history to "
                         "4 and continuing from the current iterate")
                continue
            return res.action

    # ------------------------------------------------------------------
    # Handoff (LORADS_ALMtoADMM, lorads_solver.c:968-1004).
    # ------------------------------------------------------------------

    def alm_to_admm(self, alm_stats: ALMStats, admm_stats: ADMMStats):
        self.V = self.R
        self.U = self.R
        admm_stats.pinf_l1 = alm_stats.pinf_l1
        admm_stats.pinf_inf = alm_stats.pinf_inf
        admm_stats.gap = alm_stats.gap
        admm_stats.rho = alm_stats.rho * self.params.heuristic_factor
        if alm_stats.rho > self.rho_max:
            admm_stats.rho = min(
                math.sqrt(max(self.rho_max, alm_stats.rho) / self.rho_max)
                * self.rho_max, alm_stats.rho)
            self.rho_max = admm_stats.rho

    # ------------------------------------------------------------------
    # Phase II.
    # ------------------------------------------------------------------

    def _set_admm_stats(self, stats: ADMMStats, vals) -> None:
        stats.pobj, stats.dobj, stats.pinf_l1, stats.gap = vals
        stats.pinf_inf = stats.pinf_l1 * (1 + self.pd.b_nrm1) / (
            1 + self.pd.b_nrm_inf)

    def admm_phase(self, stats: ADMMStats, iter_celling: int,
                   time_solve_start: float, reopt: bool = False) -> str:
        """One ADMM phase with divergence recovery: on NUM_ERR restore
        the entry state and retry at 5x rho (up to twice)."""
        p = self.params
        if stats.gap <= p.phase2_tol and stats.pinf_l1 <= p.phase2_tol:
            return "ok"
        # the preemptive escalation (solver.py:461-474): the exit's
        # pinf_l1 target below the f32 floor
        if self._auto_dtype and self.dtype == torch.float32 and not reopt:
            need = p.phase2_tol * (1.0 + self.pd.b_nrm_inf) / (
                1.0 + self.pd.b_nrm1)
            if need < 5e-10:
                self.maybe_escalate_f64(
                    f"ADMM pinf target {need:.1e} below the f32 floor")
        stats.rho = min(stats.rho, self.rho_max)
        entry = (self.U, self.V, self.dual, stats.rho)
        with devloop.phase():     # the graphs of its chunks, retries too
            for attempt in range(3):
                st = self._admm_phase_once(stats, iter_celling,
                                           time_solve_start, reopt)
                if st == "stalled":
                    # a plateau at f32 with auto: escalate and run the
                    # same phase once more at f64 (solver.py:478-487);
                    # else hand off to reopt
                    if self.maybe_escalate_f64("ADMM gap plateau"):
                        st = self._admm_phase_once(
                            stats, iter_celling, time_solve_start, reopt)
                        return "ok" if st == "stalled" else st
                    return "ok"
                if st != "num_err":
                    return st
                self.U, self.V, self.dual, entry_rho = entry
                if attempt == 2:
                    break
                stats.rho = min(entry_rho * 5.0, p.rho_celling_admm)
                entry = (self.U, self.V, self.dual, stats.rho)
                self.admm_retries += 1
                self.log(f"ADMM diverged; restored entry state, retrying "
                         f"at rho {stats.rho:.3f}")
        _, _, vals = admm_mod.admm_init_eval(
            self.pd, self.U, self.V, self.dual, self.scale_obj_his)
        self._set_admm_stats(stats, vals)
        self.pobj, self.dobj = stats.pobj, stats.dobj
        self.gap, self.pinf_l1 = stats.gap, stats.pinf_l1
        return "num_err"

    def _admm_phase_once(self, stats: ADMMStats, iter_celling: int,
                         time_solve_start: float, reopt: bool) -> str:
        by0 = dict(dev.HOST_SYNCS_BY)
        try:
            return self._admm_chunks(stats, iter_celling, time_solve_start,
                                     reopt)
        finally:
            for k, n in dev.HOST_SYNCS_BY.items():
                self.admm_reads_by[k] = (self.admm_reads_by.get(k, 0) + n
                                         - by0[k])

    def _admm_start(self, stats: ADMMStats, locals_, total) -> dict:
        """The ADMM phase's first chunk input (admm_chunk's ``c``) from the
        solver's factors and dual and the entry evaluation in ``stats``
        (locals and constr_sum from admm_init_eval), with the sweep plan
        of the last phase on the same ProblemData (a divergence retry's:
        its chunk graph is replayed, not captured again; a reopt scales
        the objective into a new ProblemData, which the graph would read
        at the old one's addresses)."""
        carry = admm_mod.make_carry(
            self.pd, self.U, self.V, locals_, total, self.dual,
            rho=stats.rho, cur_rho_max=self.rho_max, pinf_buf=[0.0] * 10,
            old_pinf_mean=1e30, bad_pd=0, it=stats.iter,
            pinf_l1=stats.pinf_l1, gap=stats.gap, pobj=stats.pobj,
            dobj=stats.dobj, best_gap=stats.gap, since_best=0,
            best_pinf=stats.pinf_l1, since_pinf=0)
        pd, plan = self._admm_plan
        c = admm_mod.chunk_start(self.params, self.pd, carry,
                                 self._bucket_jacobi,
                                 plan if pd is self.pd else None)
        self._admm_plan = (self.pd, c["plan"])
        return c

    def _admm_chunks(self, stats: ADMMStats, iter_celling: int,
                     time_solve_start: float, reopt: bool) -> str:
        p = self.params
        t0 = time.time()
        locals_, total, vals = admm_mod.admm_init_eval(
            self.pd, self.U, self.V, self.dual, self.scale_obj_his)
        self._set_admm_stats(stats, vals)
        if reopt:
            self.log("enter admm reopt")
        celling = iter_celling
        gap_stop = False     # in the gap continuation
        c = self._admm_start(stats, locals_, total)
        status = "ok"
        while True:
            c = admm_mod.admm_chunk(p, self.pd, c, self.scale_obj_his,
                                    celling, self._admm_n_dev, reopt=reopt,
                                    gap_stop=gap_stop,
                                    jacobi=self._bucket_jacobi, S=self.S)
            self._admm_n_dev = min(self.device_chunk_iters,
                                   2 * self._admm_n_dev)
            stats.iter = c["it"]
            # the last chunk's CG count, as lorads_tpu reports it; the
            # solve's total is admm_cg_total
            stats.cg_iter = c["cg_iter"]
            self.admm_cg_total += c["cg_iter"]
            stats.rho = c["rho"]
            stats.pobj, stats.dobj = c["pobj"], c["dobj"]
            stats.pinf_l1, stats.pinf_inf = c["pinf_l1"], c["pinf_inf"]
            stats.gap = c["gap"]
            code = c["status"]
            nblk = sum(bp.B for bp in self.ps.buckets)
            self.log(
                f"ADMM Iter:{stats.iter} pObj:{stats.pobj:5.5e} "
                f"dObj:{stats.dobj:5.5e} pInf(1):{stats.pinf_l1:5.5e} "
                f"pInf(Inf):{stats.pinf_inf:5.5e} pdGap:{stats.gap:5.5e} "
                f"rho:{stats.rho:3.2f} "
                f"cgIter:{stats.cg_iter // max(nblk, 1)} "
                f"Time:{time.time() - t0:3.2f}")
            if code == admm_mod.NUM_ERR:
                status = "num_err"
                break
            if code == admm_mod.STALLED:
                self.log("ADMM gap plateau"
                         + (" in the gap continuation" if gap_stop
                            else " at the f32 dual-noise floor"
                            if self.dtype == torch.float32 else ""))
                if gap_stop and self.dtype == torch.float64:
                    # the gap's empirical floor under continued f64
                    # iteration: solve() may skip the level-1 reopt
                    self._gap_push_stalled = True
                status = "stalled"
                break
            if code in (admm_mod.CONVERGED, admm_mod.EARLY_STOP,
                        admm_mod.BAD_PD):
                # gap continuation: pinf converged but the gap is
                # within 10 tol of the strict tol -- keep splitting with
                # gap-inclusive convergence before conceding to reopt
                if (code == admm_mod.CONVERGED and not reopt
                        and not gap_stop
                        and p.admm_gap_continue
                        and p.phase2_tol < stats.gap <= 10 * p.phase2_tol
                        and stats.pinf_l1 <= p.phase2_tol
                        and stats.iter < iter_celling):
                    gap_stop = True
                    celling = min(iter_celling, stats.iter + 2000)
                    carry = c["carry"]
                    c["carry"] = dataclasses.replace(
                        carry, best_gap=torch.full_like(carry.gap,
                                                        stats.gap),
                        since_best=torch.zeros_like(carry.since_best))
                    self.log("ADMM gap continuation: pinf converged, "
                             f"pushing gap {stats.gap:.2e} -> "
                             f"{p.phase2_tol:.0e} before conceding to "
                             "reopt")
                    continue
                status = "ok"
                break
            if stats.iter >= celling:
                status = "ok"
                break
            if time.time() - time_solve_start >= p.time_sec_limit:
                status = "time_out"
                break
        carry = c["carry"]
        self.U, self.V, self.dual = carry.U, carry.V, carry.dual
        self.rho_max = c["cur_rho_max"]
        self.pobj, self.dobj = stats.pobj, stats.dobj
        self.gap, self.pinf_l1 = stats.gap, stats.pinf_l1
        return status

    # ------------------------------------------------------------------
    # Escalation to f64 (solver.py:705-733).
    # ------------------------------------------------------------------

    def maybe_escalate_f64(self, reason: str) -> bool:
        """Switch an auto solve that runs at float32 to float64 (else do
        nothing and return False): the f64 problem data from the memo,
        the objective scaled again where a reopt scaled it, R, U, V, S
        and the dual widened (aliases kept), a new L-BFGS history.  The
        graphs captured on the f32 data are dropped here, with their
        memory pools and the f32 data: a graph reads its tensors at their
        capture addresses, so none may be replayed after the switch; the
        loops capture anew under their f64 keys."""
        if not self._auto_dtype or self.dtype == torch.float64:
            return False
        t0 = time.time()
        self.log(f"escalating to float64 ({reason})")
        devloop.drop()
        # the f32 data go with their graphs: nothing reads them again
        cache = self.ps.__dict__["_pd_cache"]
        for k in [k for k in cache if k[:2] == (self.dtype, self.device)]:
            cache.pop(k)
        self._admm_plan = (None, None)
        self.dtype = torch.float64
        self.pd = self._problem_data(self.dtype)
        if self.scale_obj_his != 1.0:
            self.pd = aop.scale_objective(self.pd, self.scale_obj_his)
        wide = {}

        def up(fv):
            if id(fv) not in wide:
                wide[id(fv)] = FactorVec(
                    tuple(x.to(torch.float64) for x in fv.cones),
                    fv.lp.to(torch.float64))
            return wide[id(fv)]

        self.R, self.U, self.V, self.S = (up(self.R), up(self.U),
                                          up(self.V), up(self.S))
        self.dual = self.dual.to(torch.float64)
        self.hist = make_history(self.R, self.lbfgs_len)
        self.log(dev.backend_report(self.device, self.dtype))
        self.escalations.append((reason, time.time() - t0))
        return True

    def prob_info(self) -> str:
        """Problem dump mirroring the reference's printfProbInfo
        (lorads_solver.c:1173-1231; solver.py:739-782): cone counts,
        block dims and each block's layout, in original block order."""
        plans = sorted(((bp, bk, pl) for bp, bk in zip(self.ps.buckets,
                                                      self.pd.buckets)
                        for pl in bp.plans), key=lambda t: t[2].index)
        lines = ["-" * 71, "Problem Information:",
                 f"\t 1.Number of SDP Cones:         : {len(plans):10d}",
                 f"\t 2.Number of LP Cones:          : "
                 f"{self.problem.n_lp_cols:10d}",
                 f"\t 3.Number of Constraints:       : "
                 f"{self.problem.m:10d}",
                 "\t 4.sdp block dims:              : "
                 + ",".join(f"{pl.dim:3d}" for _, _, pl in plans) + ","]
        for bp, bk, pl in plans:
            mode = ("sparse(diag-identity fast path)"
                    if bk.diag_ident or bk.diag_parent
                    else "dense(full lower triangle)" if bk.dense
                    else "sparse(union pattern)")
            if bk.summed:
                mode += " sharded(sp)"
            if bk.rowshard:
                mode += " sharded(tp: row slabs)"
            tri = pl.dim * (pl.dim + 1) // 2
            lines.append(f"iCone:{pl.index}")
            lines.append(
                f"\t dim:{pl.dim} nConstr:{pl.m_loc} "
                f"unionNnz:{pl.K} density:{pl.K / max(tri, 1):.4f} "
                f"mode:{mode} rank:{bp.rank}")
        lines.append("Initial rank:")
        for bp, _, pl in plans:
            lines.append(f"iCone:{pl.index}, rank:{bp.rank}")
        lines.append("-" * 71)
        return "\n".join(lines)

    def factor_blocks(self, R: Optional[FactorVec] = None):
        """Per-block solution factors F_i with X_i = F_i F_i^T, in
        original block order, and the LP column values u .* u (or None)
        (solver.py:807-825): float64 numpy arrays, one host read per
        bucket."""
        R = self._gather_fv(R if R is not None else self.R)
        out = [None] * len(self.ps.plans)
        for bp, Rb in zip(self.ps.buckets, R.cones):
            Rh = np.asarray(dev.host_read(Rb.double(), "other"), np.float64)
            for b, plan in enumerate(bp.plans):
                out[plan.index] = Rh[b, :plan.dim]
        lp_vals = None
        if self.pd.lp is not None:
            u = np.asarray(dev.host_read(R.lp.double(), "other"), np.float64)
            lp_vals = u * u
        return out, lp_vals

    def x_blocks(self, R: Optional[FactorVec] = None):
        """Dense X_i = F_i F_i^T per block, in original block order, and
        the LP column values (solver.py:784-805)."""
        fs, lp_vals = self.factor_blocks(R)
        return [F @ F.T for F in fs], lp_vals

    def save_solution(self, path: str) -> None:
        """Write the solution to an .npz (solver.py:827-841): per-block
        factors ``f<i>`` (X_i = f_i f_i^T), the LP values ``lp`` (if
        any) and the unscaled dual ``y``."""
        dual = dev.host_array(self.dual, "other").astype(np.float64)
        arrs = {"y": dual / self.scale_obj_his}
        fs, lp_vals = self.factor_blocks()
        for i, f in enumerate(fs):
            arrs[f"f{i}"] = f
        if lp_vals is not None:
            arrs["lp"] = lp_vals
        if self.is_root:
            np.savez_compressed(path, **arrs)

    def set_initial_factors(self, factors, lp_vals=None,
                            dual=None) -> None:
        """Warm start (solver.py:843-891): seed R/U/V from per-ORIGINAL
        block factors (factor_blocks' format) before solve().  Columns
        past the bucket's rank are truncated; missing columns are filled
        with the scaled identity (AUG_RANK's fill,
        lorads_solver.c:776-786).  ``lp_vals``: nonnegative LP column
        values x (factored as u = sqrt(x)); ``dual``: the UNSCALED dual
        (SolveResult.dual)."""
        cones = []
        for bp, Rb in zip(self.ps.buckets, self._gather_fv(self.R).cones):
            new = np.zeros(tuple(Rb.shape))
            r = Rb.shape[2]
            for b, plan in enumerate(bp.plans):
                F = np.asarray(factors[plan.index], dtype=np.float64)
                if F.ndim != 2 or F.shape[0] != plan.dim:
                    raise ValueError(
                        f"block {plan.index}: factor shape {F.shape} "
                        f"!= ({plan.dim}, r)")
                k = min(F.shape[1], r)
                new[b, :plan.dim, :k] = F[:, :k]
                if F.shape[1] < r:
                    aug = r - F.shape[1]
                    rr = min(plan.dim, aug)
                    new[b, :plan.dim, F.shape[1]:] = (
                        np.eye(plan.dim, aug) / math.sqrt(max(rr, 1)))
            cones.append(self._tensor(new))
        lp = self.R.lp
        if lp_vals is not None and self.pd.lp is not None:
            x = np.asarray(lp_vals, dtype=np.float64)
            if np.any(x < -1e-12):
                raise ValueError("lp_vals must be nonnegative")
            lp = self._tensor(np.sqrt(np.maximum(x, 0.0)))
        fv = self._local_fv(FactorVec(tuple(cones), lp))
        self.R = fv
        self.U = fv
        self.V = fv
        if dual is not None:
            self.dual = self._tensor(np.asarray(dual, np.float64)
                                     * self.scale_obj_his)
        self.hist = make_history(self.R, self.lbfgs_len)

    def save(self, path: str, alm_stats=None, admm_stats=None,
             phase: str = "alm") -> None:
        """Checkpoint: utils/checkpoint.save_checkpoint."""
        from lorads_torch.utils.checkpoint import save_checkpoint
        with self._unplaced():         # the gathered state, rank 0 writes
            save_checkpoint(path, self, alm_stats, admm_stats, phase,
                            write=self.is_root)

    def load(self, path: str) -> dict:
        """Restore a checkpoint (either package's): returns its meta."""
        from lorads_torch.utils.checkpoint import load_checkpoint
        meta = load_checkpoint(path, self)
        # a dp rank keeps its blocks of the whole state
        self.R, self.U, self.V, self.S = (self._local_fv(fv) for fv in (
            self.R, self.U, self.V, self.S))
        self.hist = make_history(self.R, self.lbfgs_len)
        return meta

    # ------------------------------------------------------------------
    # Dual infeasibility certificate.
    # ------------------------------------------------------------------

    def _dual_infeas_pass(self):
        """One certificate pass: (lp_part, per-bucket min-eig arrays).

        Re-certifications seed each block's Krylov space from the
        previous certificate's lowest Ritz vector plus a small random
        admixture; first passes start from a random vector."""
        prev = getattr(self, "last_cert_vecs", None)
        v0s = []
        for j, (bk, bp) in enumerate(zip(self.pd.buckets,
                                         self.ps.buckets)):
            # one logical cone per shard layout (solver.py:920-935); a
            # dp bucket's vectors are drawn whole and sliced, so every
            # rank draws the same stream
            b_eff = _b_eff(bk)
            lo, hi = (bk.b0, bk.b0 + bk.B) if pat.dp_mesh(bk) else (0, b_eff)
            pv = prev[j] if prev is not None else None
            mask = (np.arange(bk.n)[None, :]
                    < np.asarray(bp.dims)[:b_eff, None])
            if (pv is not None and pv.shape[0] == b_eff
                    and pv.shape[-1] == bk.n):
                noise = 1e-3 * self._rng.standard_normal((b_eff, bk.n)) \
                    * mask
                v0s.append(pv[lo:hi, 0, :].to(self.dtype)
                           + self._tensor(noise[lo:hi]))
                continue
            v0 = self._rng.standard_normal((b_eff, bk.n))
            v0 *= mask
            v0s.append(self._tensor(v0[lo:hi]))
        lams, restarts, vecs, lams_k = _dual_infeas_device(
            self.pd, self.dual, v0s)
        lp_part = _lp_dual_part(self.pd, self.dual)
        self.last_cert_restarts = [int(r) for r in restarts]
        self.last_cert_vecs = vecs
        self.last_cert_lams_k = lams_k
        out = []
        for lam in lams:
            if np.any(np.isnan(lam)):
                # a NaN sweep must not let the status claim optimality
                self.log("warning: Lanczos returned NaN on a block; "
                         "treating its dual slack as infeasible")
                lam = np.where(np.isnan(lam), -1.0, lam)
            out.append(lam)
        return lp_part, out

    def _identity_directions(self):
        """Per ORIGINAL block: (constraint slots, coefficients) such
        that adding ``t * coefs`` to ``dual[slots]`` adds ``-t * I`` to
        that block's slack S = C - A*(dual) -- or None.  Slots must be
        exclusive to the block (see LoradsParams.dual_repair)."""
        if self._ident_dirs is not None:
            return self._ident_dirs
        owners = np.zeros(self.problem.m, dtype=np.int32)
        for b in self.problem.blocks:
            owners[np.unique(b.a_con)] += 1
        if self.problem.lp is not None:
            owners[np.unique(self.problem.lp.a_con)] += 1
        shared = owners > 1
        self._ident_dirs = [_find_identity_direction(blk, shared)
                            for blk in self.problem.blocks]
        return self._ident_dirs

    def dual_infeasibility(self, stats=None, repair=None) -> float:
        """calculate_dual_infeasibility_solver (lorads_solver.c:1007-1037)
        with the identity-direction dual repair (see _repair_plan).  Its
        certificates' Lanczos graphs are dropped at its end."""
        with devloop.phase():
            return self._dual_infeasibility(stats, repair)

    def _dual_infeasibility(self, stats, repair) -> float:
        lp_part, lams = self._dual_infeas_pass()
        if self.params.dual_repair if repair is None else repair:
            delta = self._repair_plan(lp_part, lams)
            if delta is not None:
                self.dual = self.dual + self._tensor(delta)
                lp_part, lams = self._dual_infeas_pass()
                dobj = dev.host_read(torch.dot(self.pd.rhs, self.dual),
                                     "other")
                dobj /= self.scale_obj_his
                self.dobj = dobj
                self.gap = abs(self.pobj - dobj) / (
                    1.0 + abs(self.pobj) + abs(dobj))
                if stats is not None:
                    stats.dobj = dobj
                    stats.gap = self.gap
                self.log(f"dual repair: shifted dual along identity "
                         f"directions; dObj {dobj:.6e} "
                         f"gap {self.gap:.2e}")
        dinf = lp_part
        for lam in lams:
            dinf += float(np.sum(np.abs(np.minimum(lam, 0.0))))
        dinf /= self.scale_obj_his
        dinf /= (self.pd.c_nrm1 + 1.0)
        return dinf

    def _repair_plan(self, lp_part, lams):
        """The dual-repair shift, or None when repairing cannot improve
        the acceptance outcome: dinf must fail its band, the repairable
        violation must be what fails it, and the predicted gap must stay
        acceptable.  Ritz values only under-estimate |lam_min|, so the
        shift carries a 5% margin; dinf is re-measured post-shift."""
        p = self.params
        band = p.phase2_tol if p.high_acc_mode else 5 * p.phase2_tol
        norm = self.scale_obj_his * (self.pd.c_nrm1 + 1.0)
        lams = [np.nan_to_num(np.asarray(lam), nan=-1.0) for lam in lams]
        pre = float(lp_part)
        for lam in lams:
            pre += float(np.sum(np.abs(np.minimum(lam, 0.0))))
        if pre / norm <= band:
            return None
        dirs = self._identity_directions()
        delta = np.zeros(self.pd.m, dtype=np.float64)
        repairable = 0.0
        floor = -1e-14 * max(1.0, float(self.pd.c_nrm_inf))
        for bk, bp, lam in zip(self.pd.buckets, self.ps.buckets, lams):
            for b in range(_b_eff(bk)):
                d = dirs[bp.plans[b].index]
                lam_b = float(lam[b])
                if d is None or lam_b >= floor:
                    continue
                slots, coefs = d
                delta[slots] += 1.05 * lam_b * coefs
                repairable += -lam_b
        if repairable == 0.0 or (pre - repairable) / norm > band:
            return None
        rhs = self.problem.rhs.astype(np.float64)
        dobj_cur = dev.host_read(torch.dot(self.pd.rhs, self.dual), "other")
        dobj_new = (dobj_cur + float(np.dot(rhs, delta))) \
            / self.scale_obj_his
        gap_new = abs(self.pobj - dobj_new) / (
            1.0 + abs(self.pobj) + abs(dobj_new))
        gap_now = abs(self.pobj - dobj_cur / self.scale_obj_his) / (
            1.0 + abs(self.pobj) + abs(dobj_cur / self.scale_obj_his))
        # never move the gap OUT of the classification band (5 tol)
        cls_band = 5 * p.phase2_tol
        if (gap_new <= band
                or (gap_new <= cls_band and gap_now > band)
                or gap_now > cls_band):
            return delta
        return None

    def _try_dual_refine(self, admm_stats) -> bool:
        """Dual refinement of a failing dinf (solver.py:1031-1101): the
        spectral repair first (alg/spectral_repair.py); when it is not
        accepted, the complementarity fit by CGNR (alg/dualrefine.py),
        whose step is tried at t = 1 and t = 0.25, each candidate
        re-certified without the identity repair (a composed shift would
        move dObj).  Returns True iff a refined dual was kept
        (admm_stats' dinf/dObj/gap updated); otherwise the dual, dObj
        and gap are restored and the caller runs the level-2 reopt.
        ``dual_refine_info`` records the CGNR run."""
        p = self.params
        band = p.phase2_tol if p.high_acc_mode else 5 * p.phase2_tol
        if try_spectral_repair(self, admm_stats):
            return True
        t0 = time.time()
        syncs0 = dev.HOST_SYNCS
        Rbar = self.U.average(self.V)
        old_dual = self.dual
        old_dobj, old_gap = self.dobj, self.gap
        n_iter = min(max(2 * self.pd.m, 64), 1200)
        step, ls0, ls1, its = dual_ls_refine(self.pd, Rbar, self.dual,
                                             n_iter)
        # b^T step = 0, so dObj and the gap are the same for every t:
        # acceptance compares dinf alone
        best_t, best_dinf = None, admm_stats.dinf_l1
        for t in (1.0, 0.25):
            self.dual = old_dual + t * step
            dinf_t = self.dual_infeasibility(repair=False)
            if dinf_t < best_dinf:
                best_t, best_dinf = t, dinf_t
            if dinf_t <= band:
                break
        accept = best_t is not None and best_dinf <= band
        seconds = time.time() - t0
        self.dual_refine_info = dict(
            iters=int(its), n_iter=n_iter, accepted=accept, seconds=seconds,
            host_syncs=dev.HOST_SYNCS - syncs0)
        self.log(f"dual refine: LS |S R| {ls0:.3e} -> {ls1:.3e} "
                 f"({n_iter}-iter CGNR cap, b-orthogonal), dinf "
                 f"{admm_stats.dinf_l1:.2e} -> {best_dinf:.2e}"
                 + (f" at t={best_t}" if best_t is not None else "")
                 + f" [{seconds:.2f}s] -> "
                 f"{'accepted' if accept else 'rejected'}")
        if accept:
            self.dual = old_dual + best_t * step
            dobj = dev.host_read(torch.dot(self.pd.rhs, self.dual), "other")
            dobj /= self.scale_obj_his
            self.dobj = dobj
            self.gap = abs(self.pobj - dobj) / (
                1.0 + abs(self.pobj) + abs(dobj))
            admm_stats.dobj, admm_stats.gap = dobj, self.gap
            admm_stats.dinf_l1 = best_dinf
            admm_stats.dinf_inf = best_dinf * (1 + self.pd.c_nrm1) / (
                1 + self.pd.c_nrm_inf)
            return True
        self.dual = old_dual
        self.dobj, self.gap = old_dobj, old_gap
        return False

    # ------------------------------------------------------------------
    # Reopt (lorads_solver.c:1075-1117).
    # ------------------------------------------------------------------

    def reopt(self, alm_stats: ALMStats, admm_stats: ADMMStats,
              reopt_param: float, reopt_alm_iter: int, reopt_admm_iter: int,
              time_solve_start: float, admm_bad_iter_flag: int,
              reopt_level: int) -> int:
        p = self.params
        max_alm = reopt_alm_iter - 1 + alm_stats.outer_iter
        old_rho_max = self.rho_max
        # scale objective & dual by reopt_param
        self.scale_obj_his *= reopt_param
        self.pd = aop.scale_objective(self.pd, reopt_param)
        self.dual = self.dual * reopt_param
        if admm_stats.rho <= self.rho_max:
            alm_stats.rho = max(admm_stats.rho, alm_stats.rho)
        self.alm_phase(alm_stats, time_solve_start, reopt=True,
                       early_stop=True,
                       rho_update_factor=math.sqrt(p.alm_rho_factor),
                       max_alm_iter=max_alm)
        self.rho_max = max(
            math.sqrt(max(admm_stats.rho, alm_stats.rho) / admm_stats.rho)
            * admm_stats.rho, self.rho_max)
        self.alm_to_admm(alm_stats, admm_stats)
        if admm_bad_iter_flag == 0 or reopt_level < 2:
            # reference: min(iter*4, iter + ORIGINAL maxADMMIter)
            # (lorads_solver.c:1098)
            celling = min(admm_stats.iter * 4,
                          admm_stats.iter + p.max_admm_iter)
            st = self.admm_phase(admm_stats, celling, time_solve_start,
                                 reopt=True)
            admm_bad_iter_flag = 1 if st == "bad_iter" else 0
        self.rho_max = old_rho_max
        return admm_bad_iter_flag

    # ------------------------------------------------------------------
    # Full solve (main.c:321-487).
    # ------------------------------------------------------------------

    def solve(self) -> SolveResult:
        p = self.params
        t_start = time.time()
        alm_stats = ALMStats(rho=self.ps.rho0)
        admm_stats = ADMMStats(rho=self.ps.rho0)
        dual_infeas_time = 0.0
        admm_bad_iter_flag = 0
        status = SolverStatus.UNKNOWN

        self.log("Start solving by ALM and ADMM")
        self.log(dev.backend_report(self.device, self.dtype)
                 + (f"; {self.shard_note}" if self.shard_note else ""))
        if self.device.type == "cuda" and devloop.tracing():
            self.log("device trace: the ALM, ADMM, CG and CGNR loops run "
                     "eagerly (a host read a step), so that the trace "
                     "holds their kernels")
        action = self.alm_phase(alm_stats, t_start)
        if p.checkpoint_path:
            self.save(p.checkpoint_path, alm_stats, admm_stats, "post_alm")
        if action == "time_out" or time.time() - t_start > p.time_sec_limit:
            status = SolverStatus.TIME_LIMIT
        else:
            self.alm_to_admm(alm_stats, admm_stats)
            st = self.admm_phase(admm_stats, p.max_admm_iter, t_start)
            if p.checkpoint_path:
                self.save(p.checkpoint_path, alm_stats, admm_stats,
                          "post_admm")
            if st == "time_out":
                status = SolverStatus.TIME_LIMIT

        # reopt level 1 (main.c:376-398), skipped when the gap
        # continuation already pushed the gap to its floor inside the
        # classification band
        skip_gap_reopt = (self._gap_push_stalled
                          and not p.high_acc_mode
                          and admm_stats.gap <= 5 * p.phase2_tol
                          and admm_stats.pinf_l1 <= p.phase2_tol)
        if skip_gap_reopt:
            self.log("skipping level-1 reopt: gap plateaued at "
                     f"{admm_stats.gap:.2e} (within the 5*tol band) "
                     "under continued f64 ADMM")
        if (status is SolverStatus.UNKNOWN and p.reopt_level >= 1
                and not skip_gap_reopt):
            if ((alm_stats.gap > p.phase2_tol
                 or alm_stats.pinf_l1 > p.phase2_tol)
                    and (admm_stats.gap > p.phase2_tol
                         or admm_stats.pinf_l1 > p.phase2_tol)):
                self.maybe_escalate_f64("reopt needed at f32")
                self.log("****** reopt parameter: 5.0")
                admm_budget = 1000 if p.high_acc_mode else 50
                admm_bad_iter_flag = self.reopt(
                    alm_stats, admm_stats, 5.0, 3, admm_budget, t_start,
                    admm_bad_iter_flag, 1)
                if time.time() - t_start > p.time_sec_limit:
                    status = SolverStatus.TIME_LIMIT

        t_di = time.time()
        dinf = self.dual_infeasibility(stats=admm_stats)
        dual_infeas_time += time.time() - t_di
        admm_stats.dinf_l1 = dinf
        admm_stats.dinf_inf = dinf * (1 + self.pd.c_nrm1) / (
            1 + self.pd.c_nrm_inf)
        self.log(f"Dual infeasibility: l_1 = {dinf:.6f}, "
                 f"l_inf = {admm_stats.dinf_inf:.6f}")

        # dual refinement of a failing dinf before the level-2 reopt
        # grind (solver.py:1305-1317)
        if (status is SolverStatus.UNKNOWN and p.dual_refine
                and self.pd.lp is None
                and admm_stats.dinf_l1 > (
                    p.phase2_tol if p.high_acc_mode
                    else 5 * p.phase2_tol)):
            t_di = time.time()
            with self._unplaced():     # dp: every rank, whole data
                self._try_dual_refine(admm_stats)
            dual_infeas_time += time.time() - t_di

        # reopt level 2 (main.c:414-476)
        if status is SolverStatus.UNKNOWN and p.reopt_level >= 2:
            dual_cnt = 0
            while (admm_stats.dinf_l1 > p.phase2_tol
                   or admm_stats.gap > p.phase2_tol
                   or admm_stats.pinf_l1 > p.phase2_tol):
                if dual_cnt >= 2:
                    break
                if (not p.high_acc_mode
                        and admm_stats.dinf_l1 <= 5 * p.phase2_tol
                        and admm_stats.gap <= 5 * p.phase2_tol
                        and admm_stats.pinf_l1 <= p.phase2_tol):
                    break
                self.maybe_escalate_f64("dual reopt needed at f32")
                self.log("****** reopt parameter: 5.0")
                admm_bad_iter_flag = self.reopt(
                    alm_stats, admm_stats, 5.0, 3, 50, t_start,
                    admm_bad_iter_flag, 2)
                # average U,V -> R; V <- R (main.c:438-448)
                self.R = self.U.average(self.V)
                self.V = self.R
                t_di = time.time()
                dinf = self.dual_infeasibility(stats=admm_stats)
                dual_infeas_time += time.time() - t_di
                admm_stats.dinf_l1 = dinf
                admm_stats.dinf_inf = dinf * (1 + self.pd.c_nrm1) / (
                    1 + self.pd.c_nrm_inf)
                self.log(f"reopt {dual_cnt}: dual infeasibility l_1 = "
                         f"{dinf:.6f}")
                dual_cnt += 1
                if time.time() - t_start > p.time_sec_limit:
                    status = SolverStatus.TIME_LIMIT
                    break

        # status classification (main.c:478-487)
        if status is SolverStatus.UNKNOWN:
            if (admm_stats.dinf_l1 <= 5 * p.phase2_tol
                    and admm_stats.gap <= 5 * p.phase2_tol
                    and admm_stats.pinf_l1 <= p.phase2_tol):
                status = SolverStatus.PRIMAL_DUAL_OPTIMAL
            elif (admm_stats.gap <= 5 * p.phase2_tol
                  and admm_stats.pinf_l1 <= p.phase2_tol):
                status = SolverStatus.PRIMAL_OPTIMAL
            else:
                status = SolverStatus.MAXITER

        # the certified DIMACS numbers are for X_bar = avg(U, V); every
        # rank returns it whole
        Rbar = self.U.average(self.V)
        self.R = Rbar
        Rbar = self._gather_fv(Rbar)
        pinf_inf = self.pinf_l1 * (1 + self.pd.b_nrm1) / (
            1 + self.pd.b_nrm_inf)
        dual = np.asarray(dev.host_read(self.dual, "other"), np.float64)
        return SolveResult(
            status=status, pobj=self.pobj, dobj=self.dobj,
            pinf_l1=self.pinf_l1, pinf_inf=pinf_inf,
            dinf_l1=admm_stats.dinf_l1, dinf_inf=admm_stats.dinf_inf,
            gap=self.gap, alm_stats=alm_stats, admm_stats=admm_stats,
            solve_time=time.time() - t_start,
            dual_infeas_time=dual_infeas_time, ranks=list(self.ranks),
            # export the user's (unscaled) dual
            R=Rbar, dual=dual / self.scale_obj_his)


def solve(problem: SDPProblem, params: Optional[LoradsParams] = None,
          device="cuda", **kw) -> SolveResult:
    """One-call API: solve a standard-form SDP instance."""
    if params is None:
        params = LoradsParams(**kw)
    return LoradsSolver(problem, params, device=device).solve()


def _lp_dual_part(pd, dual) -> float:
    """The LP block's dual infeasibility sum |min(c - A_lp^T lambda, 0)|
    (solver.py:1600-1605): one K4 launch with c as its base and alpha
    -1; 0 without an LP block."""
    if pd.lp is None:
        return 0.0
    vals = lp_ops.adjoint_cols(pd.lp, dual, base=pd.lp.obj, alpha=-1.0)
    return float(dev.host_read(torch.sum(torch.abs(
        torch.clamp(vals, max=0.0))), "other"))


def _find_identity_direction(blk, shared):
    """Identity direction of one block for the dual repair: (slots,
    coefs) with A*(coefs at slots) = I restricted to this block, or
    None.  Recognizes a trace-style constraint and a block-exclusive
    single-entry diagonal family covering every row (Max-Cut)."""
    if blk.a_con.size == 0:
        return None
    diag = blk.a_row == blk.a_col
    total_cnt = np.bincount(blk.a_con, minlength=blk.m)
    diag_cnt = np.bincount(blk.a_con[diag], minlength=blk.m)

    # (a) trace-style constraint
    cand = np.nonzero((total_cnt == blk.dim) & (diag_cnt == blk.dim))[0]
    if cand.size:
        cand = cand[~shared[cand]]
    for k in cand:
        sel = blk.a_con == k
        rows = blk.a_row[sel]
        vals = blk.a_val[sel]
        if (np.unique(rows).size == blk.dim and vals[0] != 0.0
                and np.allclose(vals, vals[0])):
            return (np.asarray([k], dtype=np.int64),
                    np.asarray([1.0 / vals[0]]))

    # (b) single-entry diagonal family covering every row
    ks = np.nonzero((total_cnt == 1) & (diag_cnt == 1))[0]
    if ks.size:
        ks = ks[~shared[ks]]
    if ks.size:
        sel = np.isin(blk.a_con, ks)
        rows = blk.a_row[sel]
        cons = blk.a_con[sel]
        vals = blk.a_val[sel]
        ok = vals != 0.0
        rows, cons, vals = rows[ok], cons[ok], vals[ok]
        order = np.argsort(rows, kind="stable")
        rows, cons, vals = rows[order], cons[order], vals[order]
        first = np.concatenate([[True], rows[1:] != rows[:-1]])
        rows, cons, vals = rows[first], cons[first], vals[first]
        if rows.size == blk.dim and np.array_equal(
                rows, np.arange(blk.dim)):
            return (cons.astype(np.int64), 1.0 / vals)
    return None


# Slack blocks up to this dim get an exact eigh certificate instead of
# the Lanczos sweep (see _dual_infeas_device)
_DENSE_EIG_DIM = 1024
# cap B * n^2 for the densified [B, n, n] slack (2^26 f64 = 512 MB)
_DENSE_EIG_BUDGET = 2 ** 26
# smallest eigenpairs kept per block from the exact eigh
_EIG_K = 12


def _exact_min_eig(Wn: torch.Tensor):
    """Exact smallest eigenpairs of normalized slack blocks [B, n, n]
    -> (lams [B, k], vecs [B, k, n]), k = min(_EIG_K, n), ascending.
    Native f64 eigh (lorads_tpu's CPU branch, solver.py:1485-1487)."""
    k = min(_EIG_K, Wn.shape[-1])
    evals, vecs = torch.linalg.eigh(Wn)
    return evals[:, :k], vecs[:, :, :k].transpose(1, 2)


def _eig_rescue_ok(bk) -> bool:
    """Small slack blocks get the exact eigh; a shard layout's never does
    (solver.py:1494-1499)."""
    return (not bk.summed and not bk.rowshard and bk.n <= _DENSE_EIG_DIM
            and bk.B * bk.n * bk.n <= _DENSE_EIG_BUDGET)


def _b_eff(bk) -> int:
    """The certificate's blocks of a bucket: one logical cone for a shard
    layout, every block of a dp bucket (solver.py:920, 1139)."""
    return 1 if bk.summed or bk.rowshard else pat.n_blocks(bk)


def _cone_max(bk, ws):
    """A shard layout's normalization: the largest over its shards (and
    ranks), the same on every shard (solver.py:1532-1572)."""
    return comm.all_reduce(torch.amax(ws).reshape(1), bk.mesh, "cert_ws",
                           op="max")


# f64 bucket id -> (a weak reference to it, its f32 cast): the Lanczos
# loop runs on one f32 cast per bucket, which its graph's key holds
_LO = {}


def _f32_bucket(bk):
    """The f32 cast of bucket ``bk`` (pattern.cast_floats), made once
    while ``bk`` lives."""
    hit = _LO.get(id(bk))
    if hit is not None and hit[0]() is bk:
        return hit[1]
    lo = pat.cast_floats(bk, torch.float32)
    _LO[id(bk)] = (weakref.ref(bk, lambda _, i=id(bk): _LO.pop(i, None)), lo)
    return lo


def _slack_operator(bk, w_loc):
    """Normalized slack operator S/ws = (C - A^*(lambda))/ws for one
    bucket (solver.py:1502-1584) -> (kind, op, ws):
      kind "eigh":    op is the normalized dense slack [B, n, n]
      kind "lanczos": op is (mv, ops): mv(x, *ops) the [B, n] -> [B, n]
                      matvec, ops the tensors of this lambda it reads
                      (the Lanczos loop's inputs); mv closes over the
                      bucket's static tensors alone
    ws rescales the normalized eigenvalues back."""
    if bk.diag_ident and not _eig_rescue_ok(bk):
        # A^*(lambda) is diagonal, so the slack's off part is the static
        # C pattern: mv = one cmul (kernel K2, r = 1) + a diagonal
        W_d = bk.c_diag + bk.a_val_d * w_loc
        ws = torch.clamp(torch.maximum(
            torch.amax(torch.abs(W_d), dim=1),
            torch.amax(torch.abs(bk.c_off), dim=1)), min=1e-30)

        def mv(x, Wdn, inv, bk=bk):
            off = pat.cmul(bk, x[:, :, None], include_diag=False)[:, :, 0]
            return off * inv[:, None] + Wdn * x

        return "lanczos", (mv, (W_d / ws[:, None], 1.0 / ws)), ws
    # W = C - A^*(lambda) (kernel K4), normalized per block: |lambda|
    # grows with rho, and an un-normalized f32 Lanczos sweep can
    # overflow (eigenvalues rescale back exactly)
    if bk.rowshard:
        # this rank's slack row slabs [B, n_loc, n], normalized by the
        # cone's largest entry; mv is the row-distributed dsymm
        W = pat.build_w(bk, w_loc)
        ws = torch.clamp(_cone_max(bk, torch.abs(W)), min=1e-30)
        Wn = (W / ws,)
    elif bk.dense:
        # full [B, n, n] slack (solver.py:1547-1556)
        W = pat.build_w(bk, w_loc)
        ws = torch.clamp(torch.amax(torch.abs(W), dim=(1, 2)), min=1e-30)
        Wn = (W / ws[:, None, None],)
        if _eig_rescue_ok(bk):
            return "eigh", Wn[0], ws
    else:
        W_d, W_o = pat.build_w(bk, w_loc)
        ws = torch.clamp(torch.maximum(torch.amax(torch.abs(W_d), dim=1),
                                       torch.amax(torch.abs(W_o), dim=1)),
                         min=1e-30)
        if bk.summed:
            # one logical cone: every shard rescales by the same
            ws = _cone_max(bk, ws).expand(bk.B)
        Wn = (W_d / ws[:, None], W_o / ws[:, None])
        if _eig_rescue_ok(bk):
            return "eigh", pat.densify_w(bk, Wn), ws
        if bk.summed:
            ws = ws[:1]

    def mv(x, *Wn, bk=bk):
        # W @ x at r = 1 (kernel K5, or torch.matmul on dense buckets;
        # on the shard layouts x is the cone's [1, n])
        W = Wn[0] if bk.dense else Wn
        return pat.w_mul(bk, W, x[:, :, None])[:, :, 0]

    return "lanczos", (mv, Wn), ws


def _certificate(bk, w_loc, v0, dtype):
    """One bucket's certificate at the slack of ``w_loc`` -> ("eigh", the
    normalized dense slack, ws) or ("lanczos", its Lanczos loop, ws): the
    loop (``lanczos.lanczos_loop``) at f64 runs on the bucket's f32 cast
    with the f64 operator's Rayleigh refinement, keyed on the bucket (and
    its cast), its pack's eigenvalues rescaled by ws."""
    kind, op, ws = _slack_operator(bk, w_loc)
    if kind == "eigh":
        return kind, op, ws
    mv, ops = op
    if dtype != torch.float64:
        return kind, lanczos_loop(mv, v0, ops=ops, scale=ws,
                                  key=("cert", devloop.ident(bk))), ws
    lo = _f32_bucket(bk)
    _, (mv32, ops32), _ = _slack_operator(lo, w_loc.to(torch.float32))
    return kind, lanczos_loop(
        mv32, v0.to(torch.float32), matvec_hi=mv, ops=ops32, ops_hi=ops,
        scale=ws, key=("cert", devloop.ident(bk), devloop.ident(lo))), ws


def _dual_infeas_device(pd, dual, v0s):
    """Slack assembly + normalized batched Lanczos (or exact eigh) for
    every bucket (calculate_dual_infeasibility_solver + dual_infeasible,
    lorads_solver.c:1007-1037, lorads_sdp_conic.c:1286-1349).

    At f64 the Lanczos restart loop runs at f32 on an f32 cast of the
    SAME normalized slack and the final eigenvalue is refined by one f64
    Rayleigh quotient (solver.py:1621-1640), inside the loop's graph.
    Returns (lams, restarts, vecs, lams_k) per bucket; lams on the host
    (float64 numpy [B]: a Lanczos bucket's from its loop's one read, an
    exact-eigh bucket's read here), restarts -1 for exact-eigh buckets."""
    neg_l = -dual
    lams, restarts, vecs, lams_k = [], [], [], []
    for bk, v0 in zip(pd.buckets, v0s):
        kind, got, ws = _certificate(bk, pat.gather_w(bk, neg_l), v0,
                                     dual.dtype)
        if kind == "eigh":
            lk, vk = _exact_min_eig(got)
            lk = lk.to(dual.dtype) * ws[:, None]
            mesh = pat.dp_mesh(bk)
            if mesh is not None:
                lk = comm.all_gather(lk, mesh, "cert_lams")
                vk = comm.all_gather(vk.contiguous(), mesh, "cert_vecs")
            lams.append(np.asarray(dev.host_read(torch.amin(lk, dim=1),
                                                 "other"), np.float64))
            restarts.append(-1)
            vecs.append(vk.to(dual.dtype))
            lams_k.append(lk)
            continue
        lam, its, vec = lanczos_result(*devloop.run(got))
        lk = torch.as_tensor(lam, dtype=dual.dtype,
                             device=dual.device)[:, None]
        vec = vec.to(dual.dtype)[:, None, :]
        mesh = pat.dp_mesh(bk)
        if mesh is not None:
            # a dp bucket's blocks: gathered before the repair reads them
            lk = comm.all_gather(lk, mesh, "cert_lams")
            vec = comm.all_gather(vec, mesh, "cert_vecs")
            lam = np.asarray(dev.host_read(lk[:, 0].double(), "other"),
                             np.float64)
        lams.append(lam)
        restarts.append(its)
        vecs.append(vec)
        lams_k.append(lk)
    return lams, restarts, vecs, lams_k
