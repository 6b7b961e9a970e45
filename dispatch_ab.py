"""Dispatched times of the port's pattern kernels' wrappers, this checkout
against another, in one process on one NVIDIA GPU.

    python3 dispatch_ab.py DIR [--rounds 15]

For K3 (uvt_split, U is V and U != V) and K6 (adj_a_offdiag) at maxcut
n=20000's pattern (f64, r = the solve's rank) and K3p, K3, K6 and K5
(wmul_csr) at matcomp2000's (f64 and the f32 copies the mixed-precision
CG runs): per round, one reading of each side, 20 calls between two CUDA
events (``ms``: the host's launch included) and the host's time to
enqueue them (``host_ms``), the two sides in turns, the first side
alternating from round to round, so that both meet the same host.  DIR's
kernels.py and build.py are loaded by path beside this checkout's, each
launching from its own library (built from its own csrc into its own
build directory); the buckets and their schedules are this checkout's
(the schedules' fields are the same in both).  Prints one line per case
(medians and quartiles over the rounds) and, last, one JSON object
{"dispatch_of": DIR, "card": ..., "cases": {label: {side: {...}}}}.
"""

import argparse
import functools
import importlib.util
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sides(other):
    """{"this": kernels, "other": kernels} with the same _launch, each on
    its own library."""
    import torch

    from lorads_torch.ops import build, kernels

    o_build = _load(os.path.join(other, "lorads_torch", "ops", "build.py"),
                    "dispatch_ab_other_build")
    o_kernels = _load(os.path.join(other, "lorads_torch", "ops",
                                   "kernels.py"), "dispatch_ab_other_kernels")
    for mod, bld in ((kernels, build), (o_kernels, o_build)):
        bld.build()
        lib = bld.load()

        def launch(name, fn, *args, mod=mod, lib=lib):
            rc = getattr(lib, fn)(*args,
                                  torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA launch failed ({rc})")
            mod.LAUNCHES[name] += 1

        mod._launch = launch
    return {"this": kernels, "other": o_kernels}


def _cases(K):
    """(label, {side: call}) at the main paths' shapes."""
    import inspect

    import numpy as np
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def bucket(problem):
        bp = presolve(problem, LoradsParams()).buckets[0]
        return pat.build_bucket_data(bp, problem.m, torch.float64,
                                     dev), bp.rank

    def rand(*shape, dt=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=dt)

    def kw(fn, t):
        return ({"tiles": t} if "tiles" in inspect.signature(fn).parameters
                else {})

    def case(label, name, *args, tiles=None, **kwargs):
        """label, {side: the wrapper ``name`` on args}, ``tiles`` passed
        where the side's wrapper takes a schedule."""
        fns = {}
        for side, k in K.items():
            fn = getattr(k, name)
            fns[side] = functools.partial(fn, *args, **kwargs,
                                          **kw(fn, tiles))
        return label, fns

    out = []
    bk, r = bucket(generators.maxcut(n=20000, avg_degree=8, seed=7))
    U, V = rand(1, bk.n, r), rand(1, bk.n, r)
    a = (bk.off_rows, bk.off_cols)
    t = bk.off_tiles
    out.append(case(f"K3 maxcut20000 f64 r={r} U is V", "uvt_split", U, U,
                    *a, tiles=t))
    out.append(case(f"K3 maxcut20000 f64 r={r} U != V", "uvt_split", U, V,
                    *a, tiles=t))
    out.append(case(f"K6 maxcut20000 f64 r={r}", "adj_a_offdiag", U, V, *a,
                    rand(1, bk.Ko).abs(), tiles=t))
    bk64, r = bucket(generators.matrix_completion(
        n1=2000, n2=2000, true_rank=3, frac_obs=0.12, seed=3))
    for dt, sfx in ((torch.float64, "f64"), (torch.float32, "f32")):
        bk = bk64 if dt == torch.float64 else pat.cast_floats(bk64, dt)
        R, D = rand(1, bk.n, r, dt=dt), rand(1, bk.n, r, dt=dt)
        a = (bk.off_rows, bk.off_cols)
        t = bk.off_tiles
        if dt == torch.float64:
            out.append(case(f"K3p matcomp2000 f64 r={r}", "uvt_pair_split",
                            R, D, *a, tiles=t))
            out.append(case(f"K3 matcomp2000 f64 r={r} U is V", "uvt_split",
                            R, R, *a, tiles=t))
        out.append(case(f"K6 matcomp2000 {sfx} r={r}", "adj_a_offdiag", R,
                        D, *a, bk.a2_off, tiles=t))
        out.append(case(f"K5 matcomp2000 {sfx} r={r}", "wmul_csr", R,
                        rand(1, bk.n, dt=dt), rand(1, bk.Ko, dt=dt),
                        bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows,
                        tiles=bk.sym_tiles))
    return out


def _reading(fn, reps=20):
    """(ms per call between two CUDA events, host ms per call to
    enqueue), the GPU idle at the start."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, host


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", metavar="DIR")
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dispatch_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    timing = _load(os.path.join(ROOT, "lorads_torch", "timing.py"),
                   "dispatch_ab_timing")
    card = timing.card_line()
    K = _sides(os.path.abspath(args.other))
    result = {}
    for label, fns in _cases(K):
        for fn in fns.values():  # warm up, and check that both launch
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        got = {s: {"ms": [], "host_ms": []} for s in fns}
        order = list(fns)
        for i in range(args.rounds):
            for s in (order if i % 2 == 0 else order[::-1]):
                ms, host = _reading(fns[s])
                got[s]["ms"].append(ms)
                got[s]["host_ms"].append(host)
        result[label] = {}
        line = [label + ":"]
        for s, v in got.items():
            q = {k: statistics.quantiles(x, n=4) for k, x in v.items()}
            result[label][s] = {k: {"median": q[k][1], "q1": q[k][0],
                                    "q3": q[k][2]} for k in v}
            line.append(f"{s} {q['ms'][1]:.4f} ({q['ms'][0]:.4f}-"
                        f"{q['ms'][2]:.4f}) host {q['host_ms'][1]:.4f}")
        print("  ".join(line) + f"  [{card}]")
    print(json.dumps({"dispatch_of": os.path.abspath(args.other),
                      "card": card, "cases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
