"""Where a solve's time goes, on one NVIDIA GPU.

    python3 profile_solve.py theta300 theta800 --walls 5

For each named instance, in one warm process (one untimed solve first,
so the kernels are built and loaded):

* ``walls``: the wall seconds of that many untraced solves,
  ``LoradsSolver(...)`` construction included, each ending in a device
  synchronise; with the host syncs (``device.HOST_SYNCS``) of each;
* ``phases``: one solve with synchronised timers around the solver's
  construction, the ALM phases, the ADMM phases (and, inside them, the
  CG solves), the certificate passes and the spectral dual repair;
* ``device``: one solve with ``torch.profiler`` tracing the card over
  two windows, the first ``--window`` host syncs of the ALM phase and
  of the ADMM phase: per window, the device time of its kernels,
  copies and fills over its wall (the busy share) and the largest
  device items by name.  (A whole theta solve launches ~10^6 kernels,
  whose trace takes longer to process than the solve takes to run.)

The instances are chip_smoke.py's main-path instances, solved with
its options for each (``PARAMS``).  Run from the
root of the repository; needs a GPU; prints one JSON line per instance
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from chip_smoke import INSTANCES, PARAMS
from lorads_torch import device as dev
from lorads_torch.alg import admm as admm_mod
from lorads_torch.alg import solver as solver_mod
from lorads_torch.alg.solver import LoradsSolver
from lorads_torch.config import LoradsParams
from lorads_torch.timing import card_line


def _solve(problem, name=None):
    t0 = time.time()
    s0 = dev.HOST_SYNCS
    solver = LoradsSolver(problem, LoradsParams(verbose=False,
                                                **PARAMS.get(name, {})),
                          device="cuda")
    res = solver.solve()
    torch.cuda.synchronize()
    return res, solver, time.time() - t0, dev.HOST_SYNCS - s0


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
             (admm_mod, "cg_solve_ir", wrap(admm_mod, "cg_solve_ir",
                                            "admm_cg")),
             (admm_mod, "cg_solve", wrap(admm_mod, "cg_solve", "admm_cg")),
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
    host syncs of its first ALM phase and of its first ADMM phase."""
    from torch.profiler import ProfilerActivity, profile
    out, state = {}, {}
    read = dev.host_read

    def stop():
        prof = state.pop("prof", None)
        if prof is not None:
            torch.cuda.synchronize()
            wall = time.time() - state["t0"]
            prof.stop()
            out[state["phase"]] = _summary(prof, wall, top)

    def counted(t):
        v = read(t)
        state["n"] = state.get("n", 0) + 1
        if state["n"] >= window:
            stop()
        return v

    def traced(phase, fn):
        def run(*a, **k):
            if phase in out:
                return fn(*a, **k)
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            state.update(prof=prof, phase=phase, n=0, t0=time.time())
            try:
                return fn(*a, **k)
            finally:
                stop()
        return run

    saved = [(LoradsSolver, "alm_phase", LoradsSolver.alm_phase),
             (LoradsSolver, "admm_phase", LoradsSolver.admm_phase),
             (dev, "host_read", read)]
    LoradsSolver.alm_phase = traced("alm", LoradsSolver.alm_phase)
    LoradsSolver.admm_phase = traced("admm", LoradsSolver.admm_phase)
    dev.host_read = counted
    try:
        _solve(problem, name)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
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
        spectral_repair=getattr(runs[-1][1], "spectral_repair_info",
                                None))
    phases = {}
    with _timed(phases):
        _, _, wall, _ = _solve(problem, name)
    out["phases"] = dict(phases, wall=wall)
    out["device"] = _device_share(problem, name, window)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("instances", nargs="+", choices=sorted(INSTANCES))
    ap.add_argument("--walls", type=int, default=5)
    ap.add_argument("--window", type=int, default=2000,
                    help="host syncs traced per phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs an NVIDIA GPU")
    card = card_line()
    print(f"card: {card}")
    _solve(INSTANCES["maxcut300"]())        # build, load, warm up
    for name in args.instances:
        print(json.dumps(profile_instance(name, args.walls, args.window)),
              flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
