"""Where a solve's time goes, on one NVIDIA GPU.

    python3 profile_solve.py theta300 theta800 --walls 5

For each named instance, in one warm process (one untimed solve first,
so the kernels are built and loaded):

* ``walls``: the wall seconds of that many untraced solves,
  ``LoradsSolver(...)`` construction included, each ending in a device
  synchronise; with the host syncs (``device.HOST_SYNCS``) of each, the
  last one's by label (``device.HOST_SYNCS_BY``) and its loop graphs
  captured and replayed (``kernels.GRAPHS``);
* ``phases``: one solve with synchronised timers around the solver's
  construction, the ALM phases, the ADMM phases (whose CG solves run
  inside the ADMM chunk's graph), the certificate passes and the
  spectral dual repair;
* ``device``: one solve with ``torch.profiler`` tracing the card over
  the first ``--window`` host syncs of the ALM phase: the device time of
  its kernels, copies and fills over its wall (the busy share) and the
  largest device items by name; and the ADMM phases' graph share: the
  device time of their chunk graphs' replays (CUDA events recorded by
  ``devloop.timed``) over their wall.  (A whole theta solve launches ~10^6 kernels,
  whose trace takes longer to process than the solve takes to run.)

With ``--resume`` each instance instead gets ``--walls`` rounds, in
turns, of a cold solve, a solve that checkpoints at its phase
boundaries (``checkpoint_path``), a solve resumed from that checkpoint
(``LoradsSolver.load``) and one warm-started from the checkpointed
solve's solution file (``save_solution``, ``set_initial_factors``):
walls (construction, load or warm start included), ALM inner steps,
ADMM iterations and host syncs of each.

The instances are chip_smoke.py's main-path instances, solved with
its options for each (``PARAMS``).  ``--alm-chunk`` sets the ALM inner
loop's chunk length (``alm.INNER_CHUNK``) for this process, to measure
it.  Run from the
root of the repository; needs a GPU; prints one JSON line per instance
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from chip_smoke import INSTANCES, PARAMS
from lorads_torch import device as dev
from lorads_torch.alg import alm as alm_mod
from lorads_torch.alg import devloop
from lorads_torch.alg import solver as solver_mod
from lorads_torch.alg.solver import LoradsSolver
from lorads_torch.config import LoradsParams
from lorads_torch.ops import kernels
from lorads_torch.timing import card_line


def _solve(problem, name=None):
    t0 = time.time()
    dev.reset_host_syncs()
    kernels.reset_launches()
    solver = LoradsSolver(problem, LoradsParams(verbose=False,
                                                **PARAMS.get(name, {})),
                          device="cuda")
    res = solver.solve()
    torch.cuda.synchronize()
    solver.syncs_by = {k: v for k, v in dev.HOST_SYNCS_BY.items() if v}
    solver.graphs = dict(kernels.GRAPHS)
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


def _summary(prof, wall, top):
    """Busy seconds, share of ``wall`` and largest items of a trace:
    device events only (a CPU op's device time repeats its kernels')."""
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type != torch.autograd.DeviceType.CPU
                   and ev.self_device_time_total > 0), reverse=True)
    busy = sum(t for t, _, _ in rows) * 1e-6
    return dict(busy_s=busy, wall_s=wall, share=busy / wall,
                top=[dict(name=k[:80], ms=t * 1e-3, calls=c)
                     for t, k, c in rows[:top]])


def _device_share(problem, name, window, top=8):
    """{phase: _summary} of one solve traced over the first ``window``
    host syncs of its first ALM phase, and its ADMM phases' graph share:
    the device time of their chunk graphs' replays (``devloop.timed``)
    over the phases' wall.  The ADMM phases are not traced: under a trace
    devloop pauses the CUDA collection around those graphs (ROADMAP §3
    F4)."""
    from torch.profiler import ProfilerActivity, profile
    from lorads_torch.alg import devloop
    out, state = {}, {}
    read = dev.host_read

    def stop():
        prof = state.pop("prof", None)
        if prof is not None:
            torch.cuda.synchronize()
            wall = time.time() - state["t0"]
            prof.stop()
            out[state["phase"]] = _summary(prof, wall, top)

    def counted(t, label):
        v = read(t, label)
        state["n"] = state.get("n", 0) + 1
        if state["n"] >= window:
            stop()
        return v

    def traced(fn):
        def run(*a, **k):
            if "alm" in out:
                return fn(*a, **k)
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            state.update(prof=prof, phase="alm", n=0, t0=time.time())
            try:
                return fn(*a, **k)
            finally:
                stop()
        return run

    walls = []

    def admm_timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
        return run

    saved = [(LoradsSolver, "alm_phase", LoradsSolver.alm_phase),
             (LoradsSolver, "admm_phase", LoradsSolver.admm_phase),
             (dev, "host_read", read)]
    LoradsSolver.alm_phase = traced(LoradsSolver.alm_phase)
    LoradsSolver.admm_phase = admm_timed(LoradsSolver.admm_phase)
    dev.host_read = counted
    try:
        with devloop.timed() as events:
            _solve(problem, name)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    graph_s = sum(a.elapsed_time(b) for a, b in events) * 1e-3
    wall = sum(walls)
    out["admm_graphs"] = dict(graph_s=graph_s, wall_s=wall, replays=len(events),
                              share=graph_s / wall if wall else 0.0)
    return out


def profile_instance(name, walls, window):
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
        graphs=runs[-1][1].graphs,
        spectral_repair=getattr(runs[-1][1], "spectral_repair_info",
                                None))
    phases = {}
    with _timed(phases):
        _, _, wall, _ = _solve(problem, name)
    out["phases"] = dict(phases, wall=wall)
    out["device"] = _device_share(problem, name, window)
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
    ap.add_argument("instances", nargs="+", choices=sorted(INSTANCES))
    ap.add_argument("--walls", type=int, default=5)
    ap.add_argument("--window", type=int, default=2000,
                    help="host syncs traced per phase")
    ap.add_argument("--alm-chunk", type=int, help="alm.INNER_CHUNK")
    ap.add_argument("--resume", action="store_true",
                    help="walls of cold, checkpointed, resumed and "
                    "warm-started solves in turns")
    args = ap.parse_args(argv)
    if args.alm_chunk:
        alm_mod.INNER_CHUNK = args.alm_chunk
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}")
    print(json.dumps({"alm_chunk": alm_mod.INNER_CHUNK}))
    _solve(INSTANCES["maxcut300"]())        # build, load, warm up
    for name in args.instances:
        out = (resume_walls(name, args.walls) if args.resume else
               profile_instance(name, args.walls, args.window))
        print(json.dumps(out), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
