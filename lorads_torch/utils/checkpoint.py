"""Checkpoint / resume of the solver state (port of
lorads_tpu/utils/checkpoint.py).

The state is saved as one .npz with the arrays ``{R,U,V,S}_cone{i}``,
``{R,U,V,S}_lp`` and ``dual``, written through ``<path>.tmp.npz`` and
moved into place with ``os.replace``, beside ``<path>.meta.json``: the
format version, the phase, the cone count, the ranks, the solver's
scalars and the phase statistics as plain JSON numbers.  The layout is
lorads_tpu's, so a file written by either package loads in the other.
The solver saves at the phase boundaries of ``solve()`` (``post_alm``,
``post_admm``) when ``LoradsParams.checkpoint_path`` is set; a save
reads the state to the host, one counted read a tensor (label
``other``), and never runs inside a device-loop phase.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from lorads_torch import device as dev
from lorads_torch.alg.state import FactorVec, make_history

_FORMAT_VERSION = 1


def _pack_fv(prefix: str, fv: FactorVec, out: dict):
    for i, x in enumerate(fv.cones):
        out[f"{prefix}_cone{i}"] = dev.host_array(x, "other")
    out[f"{prefix}_lp"] = dev.host_array(fv.lp, "other")


def _unpack_fv(prefix: str, data, n_cones: int, solver) -> FactorVec:
    return FactorVec(
        tuple(solver._tensor(data[f"{prefix}_cone{i}"])
              for i in range(n_cones)),
        solver._tensor(data[f"{prefix}_lp"]))


def _plain(stats) -> dict:
    """A stats dataclass as JSON numbers (ints stay ints)."""
    return {k: (v if isinstance(v, (bool, int)) else float(v))
            for k, v in dataclasses.asdict(stats).items()}


def save_checkpoint(path: str, solver, alm_stats=None, admm_stats=None,
                    phase: str = "alm") -> None:
    """Write the solver's state to ``path`` (.npz) and
    ``path``.meta.json."""
    arrays: dict = {}
    _pack_fv("R", solver.R, arrays)
    _pack_fv("U", solver.U, arrays)
    _pack_fv("V", solver.V, arrays)
    _pack_fv("S", solver.S, arrays)
    arrays["dual"] = dev.host_array(solver.dual, "other")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)

    meta = dict(
        version=_FORMAT_VERSION,
        phase=phase,
        n_cones=len(solver.R.cones),
        ranks=[int(r) for r in solver.ranks],
        scale_obj_his=float(solver.scale_obj_his),
        rho_max=float(solver.rho_max),
        max_alm_sub_iter=int(solver.max_alm_sub_iter),
        pobj=float(solver.pobj), dobj=float(solver.dobj),
        gap=float(solver.gap), pinf_l1=float(solver.pinf_l1),
    )
    if alm_stats is not None:
        meta["alm"] = _plain(alm_stats)
    if admm_stats is not None:
        meta["admm"] = _plain(admm_stats)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, solver) -> dict:
    """Restore the state saved by :func:`save_checkpoint` (or by
    lorads_tpu's) into ``solver``; returns the meta dict (phase, stats).
    The ranks become the checkpoint's.  When the objective was rescaled
    (scale_obj_his != 1) the problem data is rebuilt and rescaled
    (lorads_tpu/utils/checkpoint.py:105-110): new buckets, so new tile
    schedules and new device-loop keys; the graphs of the old data were
    dropped at the end of the phase that made them."""
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != "
                         f"{_FORMAT_VERSION}")
    n_cones = meta["n_cones"]
    with np.load(path) as data:
        if meta["ranks"] != list(solver.ranks):
            solver.ranks = list(meta["ranks"])
        solver.R = _unpack_fv("R", data, n_cones, solver)
        solver.U = _unpack_fv("U", data, n_cones, solver)
        solver.V = _unpack_fv("V", data, n_cones, solver)
        if "S_lp" in data:
            solver.S = _unpack_fv("S", data, n_cones, solver)
        solver.dual = solver._tensor(data["dual"])
    solver.scale_obj_his = meta["scale_obj_his"]
    solver.rho_max = meta["rho_max"]
    solver.max_alm_sub_iter = meta["max_alm_sub_iter"]
    solver.pobj = meta["pobj"]
    solver.dobj = meta["dobj"]
    solver.gap = meta["gap"]
    solver.pinf_l1 = meta["pinf_l1"]
    if solver.scale_obj_his != 1.0:
        from lorads_torch.alg import aop
        solver.pd = aop.build_problem_data(solver.ps, solver.dtype,
                                           solver.device)
        solver.pd = aop.scale_objective(solver.pd, solver.scale_obj_his)
    solver.hist = make_history(solver.R, solver.lbfgs_len)
    return meta
