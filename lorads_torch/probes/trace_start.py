"""How many kernels a torch.profiler trace of a solve on the card misses
at its start, and whether ``device_trace`` misses any, on one NVIDIA GPU.

    python -m lorads_torch.probes.trace_start [--traces N] [--n N]

Solves maxcut(n, avg_degree=8, seed=7) (n = 20000 unless given) once
untraced, then N times in turns under each of two traces, on the same
problem object, so that each traced solve starts with the ALM's kernels
(the construction comes from the memo): ``bare`` (``torch.profiler``'s
``profile`` with the CPU and CUDA activities around the solve) and
``device_trace`` (``timing.profiled``: a warm-up step of launches that
the trace leaves out comes first).  A launch the trace records
(``cudaLaunchKernel``) without the kernel event of its correlation id is
lost (``profiling.lost_kernels``).  Prints, for each trace, its launches,
the lost ones and their ms after the trace's first launch; the card's
name and power limit; last a JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile

import torch

from lorads_torch import timing


def _solve(problem):
    from lorads_torch import LoradsParams, LoradsSolver
    LoradsSolver(problem, LoradsParams(verbose=False)).solve()
    torch.cuda.synchronize()


def _trace(problem, tdir, how):
    """(launches, lost launches, their ms after the first launch) of one
    traced solve."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from lorads_torch.utils.profiling import device_trace, lost_kernels

    if how == "device_trace":
        with device_trace(tdir, "cuda"):
            _solve(problem)
    else:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     on_trace_ready=tensorboard_trace_handler(tdir)):
            _solve(problem)
    (path,) = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = [float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaLaunchKernel")]
    first = min(launches, default=0.0)
    lost = sorted(round((float(e["ts"]) - first) * 1e-3, 3)
                  for e in lost_kernels(events))
    return len(launches), lost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=4)
    ap.add_argument("--n", type=int, default=20000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_start: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    from lorads_torch.io import generators

    card = timing.card_line()
    problem = generators.maxcut(n=args.n, avg_degree=8, seed=7)
    _solve(problem)
    out = {"bare": [], "device_trace": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.traces):
            for how in out:
                n, lost = _trace(problem, os.path.join(tmp, f"{how}{i}"),
                                 how)
                out[how].append(dict(launches=n, lost=len(lost),
                                     lost_ms=lost[:16]))
                print(f"trace {i} [{how}]: {len(lost)} of {n} launches "
                      f"without a kernel event, at ms {lost[:16]} after "
                      f"the first launch  [{card}]", flush=True)
    print(f"card: {card}")
    print(json.dumps({"trace_start": out, "n": args.n,
                      "warm_launches": timing.CUPTI_WARM_LAUNCHES}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
