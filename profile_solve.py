"""Where a solve's time goes, on one NVIDIA GPU.

    python3 profile_solve.py theta300 theta800 --walls 5
    python3 profile_solve.py theta800 --root _checkout/parent

For each named instance, in one warm process (one untimed solve first,
so the kernels are built and loaded):

* ``walls``: the wall seconds of that many solves, ``LoradsSolver(...)``
  construction included, each ending in a device synchronise; with the
  host syncs (``device.HOST_SYNCS``) of each, the last one's by label
  (``device.HOST_SYNCS_BY``), its loop graphs captured and replayed
  (``kernels.GRAPHS``) and its captures with their seconds (warm-ups
  and captures, ``devloop.captures``, each between device
  synchronises);
* ``phases``: one solve with synchronised timers around the solver's
  construction, the ALM phases, the ADMM phases, the certificate
  passes and the spectral dual repair;
* ``device``: for the ALM and the ADMM phases of one solve, the device
  time of their device-decided graphs' replays (CUDA events recorded by
  ``devloop.timed``) over the phases' wall, with the replays counted.

``--root DIR`` profiles the lorads_torch of the checkout at DIR (built
into DIR/build) with this script: two checkouts compare on one card by
running both in one call, in turns.  ``--resume``: each instance instead
gets ``--walls`` rounds, in turns, of a cold solve, a solve that
checkpoints at its phase boundaries (``checkpoint_path``), a solve
resumed from that checkpoint (``LoradsSolver.load``) and one
warm-started from the checkpointed solve's solution file
(``save_solution``, ``set_initial_factors``): walls (construction, load
or warm start included), ALM inner steps, ADMM iterations and host
syncs of each.

The instances are chip_smoke.py's main-path instances, solved with its
options for each (``PARAMS``).  Run from the root of the repository;
needs a GPU; prints one JSON line per instance and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

dev = devloop = solver_mod = LoradsSolver = LoradsParams = kernels = None
INSTANCES = PARAMS = card_line = None


def _import(root=None):
    """The port's modules, from the checkout at ``root`` if given."""
    global dev, devloop, solver_mod, LoradsSolver, LoradsParams, kernels
    global INSTANCES, PARAMS, card_line
    if root:
        sys.path.insert(0, os.path.abspath(root))
    from chip_smoke import INSTANCES, PARAMS
    from lorads_torch import device as dev
    from lorads_torch.alg import devloop
    from lorads_torch.alg import solver as solver_mod
    from lorads_torch.alg.solver import LoradsSolver
    from lorads_torch.config import LoradsParams
    from lorads_torch.ops import kernels
    from lorads_torch.timing import card_line


def _captures():
    """devloop.captures() of the checkout profiled; a checkout without it
    reports no captures."""
    return (devloop.captures() if hasattr(devloop, "captures")
            else contextlib.nullcontext([]))


def _solve(problem, name=None):
    t0 = time.time()
    dev.reset_host_syncs()
    kernels.reset_launches()
    with _captures() as caps:
        solver = LoradsSolver(problem, LoradsParams(
            verbose=False, **PARAMS.get(name, {})), device="cuda")
        res = solver.solve()
        torch.cuda.synchronize()
    solver.syncs_by = {k: v for k, v in dev.HOST_SYNCS_BY.items() if v}
    solver.graphs = dict(kernels.GRAPHS)
    solver.captures = {kind: [n, sum(t for k, _, t in caps if k == kind)]
                       for kind in ("warm_up", "capture")
                       for n in [sum(1 for k, _, _ in caps if k == kind)]}
    return res, solver, time.time() - t0, dev.HOST_SYNCS


@contextlib.contextmanager
def _timed(phases):
    """Wrap the solver's phase entry points with synchronised timers
    that add into ``phases`` (seconds by name)."""
    def wrap(owner, attr, key):
        fn = getattr(owner, attr)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            phases[key] = phases.get(key, 0.0) + time.time() - t0
            return out
        setattr(owner, attr, timed)
        return fn

    saved = [(LoradsSolver, "__init__", wrap(LoradsSolver, "__init__",
                                              "init")),
             (LoradsSolver, "alm_phase", wrap(LoradsSolver, "alm_phase",
                                               "alm")),
             (LoradsSolver, "admm_phase", wrap(LoradsSolver, "admm_phase",
                                                "admm")),
             (LoradsSolver, "_dual_infeas_pass",
              wrap(LoradsSolver, "_dual_infeas_pass", "certificate")),
             (solver_mod, "try_spectral_repair",
              wrap(solver_mod, "try_spectral_repair", "spectral_repair"))]
    try:
        yield phases
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _device_share(problem, name):
    """{phase: graph seconds, wall seconds, replays, share} of one solve:
    the device time of the device-decided graphs replayed inside the ALM
    and the ADMM phases (CUDA events, ``devloop.timed``) over the
    phases' wall."""
    spans = {"alm": [], "admm": []}

    def timed_phase(fn, phase):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0, first = time.time(), len(events)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spans[phase].append((time.time() - t0, first, len(events)))
        return run

    saved = [(attr, getattr(LoradsSolver, attr))
             for attr in ("alm_phase", "admm_phase")]
    for attr, fn in saved:
        setattr(LoradsSolver, attr, timed_phase(fn, attr.split("_")[0]))
    try:
        with devloop.timed() as events:
            _solve(problem, name)
    finally:
        for attr, fn in saved:
            setattr(LoradsSolver, attr, fn)
    out = {}
    for phase, runs in spans.items():
        wall = sum(w for w, _, _ in runs)
        graph_s = sum(a.elapsed_time(b) for _, i, j in runs
                      for a, b in events[i:j]) * 1e-3
        out[phase] = dict(graph_s=graph_s, wall_s=wall,
                          replays=sum(j - i for _, i, j in runs),
                          share=graph_s / wall if wall else 0.0)
    return out


def profile_instance(name, walls):
    problem = INSTANCES[name]()
    out = dict(instance=name)
    runs = [_solve(problem, name) for _ in range(walls)]
    res = runs[-1][0]
    out.update(
        status=res.status.value, pobj=res.pobj, dinf=res.dinf_l1,
        walls=[w for _, _, w, _ in runs],
        host_syncs=[h for _, _, _, h in runs],
        alm_outer=res.alm_stats.outer_iter,
        alm_inner=res.alm_stats.inner_iter, admm=res.admm_stats.iter,
        cg=runs[-1][1].admm_cg_total, rank=res.ranks,
        host_syncs_by=runs[-1][1].syncs_by,
        admm_reads_by={k: n for k, n in runs[-1][1].admm_reads_by.items()
                       if n},
        graphs=runs[-1][1].graphs, captures=runs[-1][1].captures,
        spectral_repair=getattr(runs[-1][1], "spectral_repair_info",
                                None))
    phases = {}
    with _timed(phases):
        _, _, wall, _ = _solve(problem, name)
    out["phases"] = dict(phases, wall=wall)
    out["device"] = _device_share(problem, name)
    return out


def resume_walls(name, walls):
    """{kind: [wall, ...]} of cold, checkpointed, resumed and warm-started
    solves of one instance, ``walls`` rounds in turns, with each kind's
    last ALM inner steps, ADMM iterations, host syncs and pObj."""
    problem = INSTANCES[name]()
    kinds = ("cold", "checkpointed", "resumed", "warm")
    out = dict(instance=name, walls={k: [] for k in kinds})
    with tempfile.TemporaryDirectory() as tmp:
        ck, sol = os.path.join(tmp, "state.ckpt"), os.path.join(tmp,
                                                                 "sol.npz")
        for _ in range(walls):
            for kind in kinds:
                extra = dict(checkpoint_path=ck) if kind == \
                    "checkpointed" else {}
                torch.cuda.synchronize()
                dev.reset_host_syncs()
                t0 = time.time()
                solver = LoradsSolver(problem, LoradsParams(
                    verbose=False, **PARAMS.get(name, {}), **extra),
                    device="cuda")
                if kind == "resumed":
                    solver.load(ck)
                elif kind == "warm":
                    with np.load(sol) as z:
                        fs = [z[f"f{i}"]
                              for i in range(problem.n_sdp_blocks)]
                        solver.set_initial_factors(
                            fs, z["lp"] if "lp" in z.files else None,
                            dual=z["y"])
                res = solver.solve()
                torch.cuda.synchronize()
                out["walls"][kind].append(time.time() - t0)
                out[kind] = dict(
                    status=res.status.value, pobj=res.pobj,
                    alm_inner=res.alm_stats.inner_iter,
                    admm=res.admm_stats.iter, host_syncs=dev.HOST_SYNCS,
                    host_syncs_by=dict(dev.HOST_SYNCS_BY))
                if kind == "checkpointed":
                    solver.save_solution(sol)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("instances", nargs="+")
    ap.add_argument("--walls", type=int, default=5)
    ap.add_argument("--root", metavar="DIR",
                    help="profile the lorads_torch of the checkout at DIR")
    ap.add_argument("--resume", action="store_true",
                    help="walls of cold, checkpointed, resumed and "
                    "warm-started solves in turns")
    args = ap.parse_args(argv)
    _import(args.root)
    unknown = sorted(set(args.instances) - set(INSTANCES))
    if unknown:
        ap.error(f"unknown instances {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}")
    print(json.dumps({"root": os.path.abspath(args.root or ".")}))
    _solve(INSTANCES["maxcut300"]())        # build, load, warm up
    for name in args.instances:
        out = (resume_walls(name, args.walls) if args.resume else
               profile_instance(name, args.walls))
        print(json.dumps(out), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
