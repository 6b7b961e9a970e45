"""Smoke run of the PyTorch/CUDA port (lorads_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. the build of the CUDA kernels from lorads_torch/csrc (one nvcc per
   source, in parallel, sm_90a);
3. each kernel against its plain PyTorch version on the card, with the
   tolerance stated and the kernel and plain times from CUDA events:
   K1-K3 at the shapes of the Max-Cut path (maxcut n=20000, deg 8:
   Ks=160000, r = the solve's rank at f64; r=1 at f32 and f64 for the
   certificate) plus the segment-sum edge cases; K3p, K4, K5 and K6 at
   the shapes of the matrix-completion path (matcomp2000: n=4000,
   Ko=478843, Ks=957686, r = the solve's rank at f64, the f32 copies the
   mixed-precision CG runs, and K5 at r=1 in f32 and f64 for the
   certificate);
4. the main paths, each with the kernel launch counts reset just before
   it and read just after, through LoradsSolver(...).solve() on cuda at
   f64, each solve held to primal_dual_optimal and to lorads_tpu's CPU
   f64 objective within 1e-4 relative:
   - Max-Cut (split, diag-identity): maxcut(n=300, deg 4, seed 3) (ALM
     + closed-form ADMM, exact-eigh certificate), maxcut n=20000 (deg 8,
     seed 7) and tests/fixtures/gset_torus10000.rudy (Lanczos
     certificate on C @ X);
   - matrix completion (the general sparse path):
     tests/fixtures/matcomp500.dat-s (ALM, ADMM with mixed-precision CG,
     exact-eigh certificate) and bench.py's matcomp2000,
     matrix_completion(n1=2000, n2=2000, true_rank=3, frac_obs=0.12,
     seed=3) (ADMM with CG, Lanczos certificate on W @ X).

The line before the last is the JSON kernel summary; the last line is
{"ok": true, "device": {...}}.  Any failed phase raises and exits
nonzero without that line.  Needs no network and no JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# lorads_tpu on CPU at f64 (objective of each main-path instance)
REFERENCE_POBJ = {
    "maxcut300": -5.046605560e+02,
    "maxcut20000": -6.209725666e+04,
    "gset_torus10000": -7.762241872e+03,
    "matcomp500": 3.021053389e+03,
    "matcomp2000": 1.204995184e+04,
}
# the kernels each main path must launch
PATH_KERNELS = {
    "maxcut": ("cmul_csr", "uvt_split"),
    "matcomp": ("uvt_split", "uvt_pair_split", "gather_segsum", "wmul_csr",
                "adj_a_offdiag"),
}
POBJ_RTOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check(name, got, ref, bound):
    """max |got - ref| against an elementwise bound; returns the max
    absolute error."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    bound = bound if isinstance(bound, tuple) else (bound,)
    err = 0.0
    for g, r, b in zip(got, ref, bound):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: bad output {tuple(g.shape)}")
        diff = (g.double() - r.double()).abs()
        ok = bool((diff <= b).all())
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not ok:
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max err {err:.3e}, worst ratio "
                f"{float((diff / b.clamp(min=1e-300)).max()):.3e})")
    return err


def kernel_checks(card):
    """Phase 3: every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    eps64 = float(np.finfo(np.float64).eps)
    eps32 = float(np.finfo(np.float32).eps)
    rng = np.random.default_rng(0)
    results = {}

    problem = generators.maxcut(n=20000, avg_degree=8, seed=7)
    ps = presolve(problem, LoradsParams())
    bp = ps.buckets[0]
    r = bp.rank
    bk64 = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    bk32 = pat.cast_floats(bk64, torch.float32)
    n = bk64.n
    print(f"main-path shapes: n={n} Ks={bk64.Ks} Ko={bk64.Ko} rank={r}")

    def row_l1(bk, X, with_diag):
        """|C| @ |X| row sums: the sum of |terms| of each output."""
        out = kernels.cmul_csr_plain(
            X.abs(), bk.c_diag.abs() if with_diag else None,
            bk.sym_cols_rs, bk.c_sym_rs.abs(), bk.bnd_sym_rows)
        return out.double()

    # ---- K2 cmul_csr ----
    cases = [("f64 r=%d diag" % r, bk64, torch.float64, r, True),
             ("f64 r=1 no-diag", bk64, torch.float64, 1, False),
             ("f32 r=1 no-diag", bk32, torch.float32, 1, False)]
    k2 = []
    for label, bk, dt, rr, diag in cases:
        X = torch.as_tensor(rng.standard_normal((1, n, rr)), device=dev,
                            dtype=dt)
        cd = bk.c_diag if diag else None
        args = (X, cd, bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
        got = kernels.cmul_csr(*args)
        ref = kernels.cmul_csr_plain(*args)
        torch.cuda.synchronize()
        eps = eps64 if dt == torch.float64 else eps32
        # f64: both sum <= ~40 terms directly (different order);
        # f32: compensated kernel vs f64-accumulated plain
        tol = (64 if dt == torch.float64 else 4) * eps
        err = check(f"cmul_csr {label}", got, ref,
                    tol * row_l1(bk, X, diag) + 1e-300)
        ms = cuda_time_ms(lambda: kernels.cmul_csr(*args))
        pms = cuda_time_ms(lambda: kernels.cmul_csr_plain(*args))
        print(f"K2 cmul_csr [{label}] X{tuple(X.shape)} Ks={bk.Ks}: "
              f"max_abs_err {err:.3e} (tol {tol:.1e} x row |terms|) "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms  [{card}]")
        k2.append((label, err, ms, pms))
    results["cmul_csr"] = k2

    # ---- K3 uvt_split ----
    U = torch.as_tensor(rng.standard_normal((1, n, r)), device=dev)
    V = torch.as_tensor(rng.standard_normal((1, n, r)), device=dev)
    args = (U, V, bk64.off_rows, bk64.off_cols)
    got = kernels.uvt_split(*args)
    ref = kernels.uvt_split_plain(*args)
    absd, abso = kernels.uvt_split_plain(U.abs(), V.abs(), bk64.off_rows,
                                         bk64.off_cols)
    torch.cuda.synchronize()
    tol = 64 * eps64
    err = check("uvt_split f64", got, ref, (tol * absd, tol * abso))
    ms = cuda_time_ms(lambda: kernels.uvt_split(*args))
    pms = cuda_time_ms(lambda: kernels.uvt_split_plain(*args))
    print(f"K3 uvt_split [f64 r={r}] U{tuple(U.shape)} Ko={bk64.Ko}: "
          f"max_abs_err {err:.3e} (tol {tol:.1e} x |products|) "
          f"kernel {ms:.4f} ms plain {pms:.4f} ms  [{card}]")
    results["uvt_split"] = [(f"f64 r={r}", err, ms, pms)]

    # ---- K1 segment_sum ----
    def seg_case(label, data, bounds, timed=False):
        got = kernels.segment_sum(data, bounds)
        ref = kernels.segment_sum_plain(data, bounds)
        l1 = kernels.segment_sum_plain(data.abs(), bounds).double()
        torch.cuda.synchronize()
        eps = eps64 if data.dtype == torch.float64 else eps32
        tol = (64 if data.dtype == torch.float64 else 4) * eps
        err = check(f"segment_sum {label}", got, ref, tol * l1 + 1e-300)
        line = (f"K1 segment_sum [{label}] data{tuple(data.shape)} "
                f"S={bounds.shape[1] - 1}: max_abs_err {err:.3e} "
                f"(tol {tol:.1e} x segment |terms|)")
        ms = pms = None
        if timed:
            ms = cuda_time_ms(lambda: kernels.segment_sum(data, bounds))
            pms = cuda_time_ms(
                lambda: kernels.segment_sum_plain(data, bounds))
            line += f" kernel {ms:.4f} ms plain {pms:.4f} ms  [{card}]"
        print(line)
        return (label, err, ms, pms)

    def bounds_of(ids, S):
        return torch.as_tensor(pat._bounds_np(ids, S), device=dev)

    k1 = []
    # the segment sum cmul fuses, unfused: [1, Ks, r] products over the
    # row pointers of the maxcut n=20000 entry list
    contrib = (bk64.c_sym_rs[:, :, None]
               * U[0].index_select(0, bk64.sym_cols_rs[0].long())[None])
    for dt in (torch.float64, torch.float32):
        k1.append(seg_case(f"main-path {str(dt)[6:]} r={r}",
                           contrib.to(dt).contiguous(), bk64.bnd_sym_rows,
                           timed=True))
    # edge cases: empty segments, padded blocks (B=2, second block's
    # entries end early), 2-D and 3-D data, single-entry segments
    B, N, S = 2, 3 * 512 + 7, 97
    ids = np.sort(rng.integers(0, S, (B, N)), axis=1)
    ids[:, :5] = 0                      # a long first segment
    ids[1, N // 2:] = S                 # padded tail past the last bound
    ids = np.clip(ids, 0, S)
    bnd = bounds_of(ids, S)
    for shape in ((B, N), (B, N, 3), (B, N, 40)):
        for dt in (torch.float64, torch.float32):
            d = torch.as_tensor(rng.standard_normal(shape), device=dev,
                                dtype=dt)
            k1.append(seg_case(f"edges {str(dt)[6:]} {shape}", d, bnd))
    single = np.sort(rng.choice(S, size=40, replace=False))[None]
    d = torch.as_tensor(rng.standard_normal((1, 40)), device=dev)
    got = kernels.segment_sum(d, bounds_of(single, S))
    ref = kernels.segment_sum_plain(d, bounds_of(single, S))
    if not torch.equal(got, ref):
        raise AssertionError("segment_sum single-entry: not exact")
    print("K1 segment_sum [single-entry segments]: exact")
    results["segment_sum"] = k1
    results.update(matcomp_kernel_checks(card, rng))
    return results


def matcomp_kernel_checks(card, rng):
    """Phase 3, matrix-completion path: K3p, K4, K5 and K6 against their
    plain versions at matcomp2000's shapes."""
    import numpy as np
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    problem = generators.matrix_completion(n1=2000, n2=2000, true_rank=3,
                                           frac_obs=0.12, seed=3)
    bp = presolve(problem, LoradsParams()).buckets[0]
    r = bp.rank
    bk64 = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    bk32 = pat.cast_floats(bk64, torch.float32)
    n, Ko = bk64.n, bk64.Ko
    print(f"matcomp-path shapes: n={n} m={problem.m} Ko={Ko} Ks={bk64.Ks} "
          f"rank={r} a_off_unique={bk64.a_off_unique}")
    results = {}

    def rand(shape, dt):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=dt)

    def tol_of(dt):
        # f64: both sides sum the same terms directly in another order
        # (at most a few hundred per output); f32: compensated kernel vs
        # the plain version's f64 accumulation (K4, K5) or f32 row dots
        # of r terms (K3p, K6)
        return (64 * float(np.finfo(np.float64).eps) if dt == torch.float64
                else 4 * float(np.finfo(np.float32).eps))

    def run(kname, label, dt, fn, plain, l1, exact=False):
        got = fn()
        ref = plain()
        torch.cuda.synchronize()
        tol = tol_of(dt)
        bound = tuple(tol * a.double() + 1e-300 for a in l1) \
            if isinstance(l1, tuple) else tol * l1.double() + 1e-300
        err = check(f"{kname} {label}", got, ref, bound)
        if exact:
            for g, e in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                if not torch.equal(g, e):
                    raise AssertionError(f"{kname} {label}: not exact")
        ms = cuda_time_ms(fn)
        pms = cuda_time_ms(plain)
        print(f"{kname} [{label}]: max_abs_err {err:.3e} (tol {tol:.1e} x "
              f"|terms|{', exact' if exact else ''}) kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms  [{card}]")
        results.setdefault(kname, []).append((label, err, ms, pms))

    for dt, bk in ((torch.float64, bk64), (torch.float32, bk32)):
        sfx = "f64" if dt == torch.float64 else "f32"
        # ---- K3p uvt_pair_split (ALM line search; f64 only on the path)
        if dt == torch.float64:
            R, D = rand((1, n, r), dt), rand((1, n, r), dt)
            a = (bk.off_rows, bk.off_cols)
            label = f"{sfx} r={r}"
            run("uvt_pair_split", label, dt,
                lambda: kernels.uvt_pair_split(R, D, *a),
                lambda: kernels.uvt_pair_split_plain(R, D, *a),
                kernels.uvt_pair_split_plain(R.abs(), D.abs(), *a))
        # ---- K4 gather_segsum: A(.) (one entry per constraint: exact)
        o = rand((1, Ko), dt)
        a4 = (o, bk.a_pos_o_cs, bk.a_val_o_cs, bk.bnd_a_con_o_cs)
        label = f"{sfx} A(.) m={problem.m}"
        run("gather_segsum", label, dt,
            lambda: kernels.gather_segsum(*a4, alpha=2.0),
            lambda: kernels.gather_segsum_plain(*a4, None, 2.0),
            kernels.gather_segsum_plain(o.abs(), a4[1], a4[2].abs(), a4[3],
                                        None, 2.0), exact=True)
        # ---- K4: C + A^*(w) onto the Ko slots
        w = rand((1, problem.m), dt)
        a4w = (w, bk.a_con_o_s, bk.a_val_o_s, bk.bnd_a_pos_o_s)
        label = f"{sfx} A^*(w)+C Ko={Ko}"
        run("gather_segsum", label, dt,
            lambda: kernels.gather_segsum(*a4w, base=bk.c_off),
            lambda: kernels.gather_segsum_plain(*a4w, bk.c_off),
            kernels.gather_segsum_plain(w.abs(), a4w[1], a4w[2].abs(),
                                        a4w[3], bk.c_off.abs()))
        # ---- K5 wmul_csr at r = rank (gradient, CG) and r = 1 (Lanczos)
        W_d, W_o = rand((1, n), dt), rand((1, Ko), dt)
        a5 = (bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows)
        for rr in (r, 1):
            X = rand((1, n, rr), dt)
            label = f"{sfx} r={rr}"
            run("wmul_csr", label, dt,
                lambda: kernels.wmul_csr(X, W_d, W_o, *a5),
                lambda: kernels.wmul_csr_plain(X, W_d, W_o, *a5),
                kernels.wmul_csr_plain(X.abs(), W_d.abs(), W_o.abs(), *a5))
        # ---- K6 adj_a_offdiag (every CG matvec)
        X, F = rand((1, n, r), dt), rand((1, n, r), dt)
        a6 = (bk.off_rows, bk.off_cols, bk.a2_off)
        label = f"{sfx} r={r}"
        run("adj_a_offdiag", label, dt,
            lambda: kernels.adj_a_offdiag(X, F, *a6)[1],
            lambda: kernels.adj_a_offdiag_plain(X, F, *a6, False)[1],
            kernels.adj_a_offdiag_plain(X.abs(), F.abs(), *a6, False)[1])
    return results


def solve_path(card, path, instances):
    """One main path: its solves through the public entry points, with
    the launch counts reset just before and read just after."""
    import torch

    from lorads_torch import LoradsParams, LoradsSolver, SolverStatus
    from lorads_torch import device as tdev
    from lorads_torch.ops import kernels

    problems = [(name, make()) for name, make in instances]
    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()
    for name, problem in problems:
        before = dict(kernels.LAUNCHES)
        syncs0 = tdev.HOST_SYNCS
        t0 = time.time()
        solver = LoradsSolver(problem, LoradsParams(verbose=False),
                              device="cuda")
        res = solver.solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: kernels.LAUNCHES[k] - before[k]
                    for k in kernels.LAUNCHES}
        ref = REFERENCE_POBJ[name]
        rel = abs(res.pobj - ref) / abs(ref)
        print(f"solve {name}: status {res.status.value} pObj "
              f"{res.pobj!r} (lorads_tpu CPU f64 {ref:.9e}, rel "
              f"{rel:.2e}) pinf {res.pinf_l1:.3e} gap {res.gap:.3e} "
              f"dinf {res.dinf_l1:.3e} wall {wall:.3f} s (certificate "
              f"{res.dual_infeas_time:.3f} s) ALM outer "
              f"{res.alm_stats.outer_iter} inner {res.alm_stats.inner_iter}"
              f" ADMM {res.admm_stats.iter} CG {res.admm_stats.cg_iter} "
              f"cert restarts {solver.last_cert_restarts} host syncs "
              f"{tdev.HOST_SYNCS - syncs0} launches {launches}  [{card}]")
        if res.status is not SolverStatus.PRIMAL_DUAL_OPTIMAL:
            raise AssertionError(f"{name}: status {res.status.value}")
        if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
            raise AssertionError(f"{name}: pObj {res.pobj} vs {ref}")
        R = res.R.cones[0]
        if R.shape[:2] != (1, problem.blocks[0].dim) \
                or not bool(torch.isfinite(R).all()):
            raise AssertionError(f"{name}: bad factor {tuple(R.shape)}")
        if name in ("maxcut300", "matcomp500") and res.admm_stats.iter == 0:
            raise AssertionError(f"{name} did not reach ADMM")
        if path == "matcomp" and res.admm_stats.cg_iter <= 0:
            raise AssertionError(f"{name}: ADMM ran no CG iteration")
    counts = dict(kernels.LAUNCHES)
    print(f"main path {path}: kernel launches {counts}, host syncs "
          f"{tdev.HOST_SYNCS}")
    for k in PATH_KERNELS[path]:
        if counts[k] <= 0:
            raise AssertionError(f"the {path} path never launched {k}")
    return counts


def main_path(card):
    """Phase 4: the Max-Cut path and the matrix-completion path.
    Returns the launch counts summed over the paths."""
    from lorads_torch.io import generators
    from lorads_torch.io.sdpa import read_sdpa
    from lorads_torch.ops import kernels

    fix = os.path.join(HERE, "tests", "fixtures")
    paths = {
        "maxcut": [
            ("maxcut300", lambda: generators.maxcut(n=300, avg_degree=4,
                                                    seed=3)),
            ("maxcut20000", lambda: generators.maxcut(n=20000,
                                                      avg_degree=8,
                                                      seed=7)),
            ("gset_torus10000", lambda: generators.maxcut_from_graph(
                os.path.join(fix, "gset_torus10000.rudy"))),
        ],
        "matcomp": [
            ("matcomp500", lambda: read_sdpa(
                os.path.join(fix, "matcomp500.dat-s"))),
            ("matcomp2000", lambda: generators.matrix_completion(
                n1=2000, n2=2000, true_rank=3, frac_obs=0.12, seed=3)),
        ],
    }
    total = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for path, instances in paths.items():
        counts = solve_path(card, path, instances)
        for k in total:
            total[k] += counts[k]
    return total


def main() -> int:
    try:
        import torch

        import lorads_torch  # noqa: F401
        from lorads_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              "root of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 3

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    t0 = time.time()
    lib = build.build(verbose=True)
    build.load()
    print(f"build: {lib.name} in {time.time() - t0:.2f} s "
          f"(nvcc {build.BUILD_SECONDS:.2f} s)")

    results = kernel_checks(card)
    counts = main_path(card)

    src = {"segment_sum": ("lorads_torch/csrc/segment_sum.cu",
                           "lorads_tpu/ops/pattern.py:138"),
           "cmul_csr": ("lorads_torch/csrc/cmul.cu",
                        "lorads_tpu/ops/pattern.py:1509"),
           "uvt_split": ("lorads_torch/csrc/uvt.cu",
                         "lorads_tpu/ops/pattern.py:1056"),
           "uvt_pair_split": ("lorads_torch/csrc/uvt_pair.cu",
                              "lorads_tpu/ops/pattern.py:1100"),
           "gather_segsum": ("lorads_torch/csrc/gather_segsum.cu",
                             "lorads_tpu/ops/pattern.py:1140"),
           "wmul_csr": ("lorads_torch/csrc/wmul.cu",
                        "lorads_tpu/ops/pattern.py:1312"),
           "adj_a_offdiag": ("lorads_torch/csrc/adj_a.cu",
                             "lorads_tpu/ops/pattern.py:1476")}
    summary = []
    for name, (path, replaces) in src.items():
        label, err, ms, pms = results[name][0]
        summary.append({"name": name, "route": "cuda", "source": path,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
