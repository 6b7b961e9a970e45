"""Smoke run of the PyTorch/CUDA port (lorads_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-of DIR   # phases 1-3 on DIR's port

Phases, each reported on its own lines:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. the build of the CUDA kernels from lorads_torch/csrc (one nvcc per
   source, in parallel, sm_90a);
3. each kernel against its plain PyTorch version on the card, with the
   tolerance stated, the kernel and plain times from CUDA events
   (dispatched: the host's launch included), the kernel's device time
   (20 calls in one CUDA graph, lorads_torch/timing.py), its bound (the
   larger of its bytes over 3.35 TB/s and its operations over the
   card's peak for the type) and, where one PyTorch call computes the
   same function, that call's time, dispatched and on the device:
   K1-K3 at the shapes of the Max-Cut path (maxcut n=20000, deg 8:
   Ks=160000, r = the solve's rank at f64; r=1 at f32 and f64 for the
   certificate) plus the segment-sum edge cases; K3p, K4, K5 and K6 at
   the shapes of the matrix-completion path (matcomp2000: n=4000,
   Ko=478843, Ks=957686, r = the solve's rank at f64, the f32 copies the
   mixed-precision CG runs, and K5 at r=1 in f32 and f64 for the
   certificate); K7a and K4 on the dense layouts at the shapes of the
   theta path (theta800: n=800, n^2=640000 slots, m=3201, nnz_a=4000)
   at f64 and in f32 as the mixed-precision CG runs them; K4 on skewed
   segment lengths (one-entry segments with segments of 800, 5000 and
   70000 entries among them, empty segments, B = 2, base and alpha),
   bit for bit on one-entry segments;
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
     seed=3) (ADMM with CG, Lanczos certificate on W @ X);
   - Lovász theta (dense buckets): tests/fixtures/theta_gtoy60.dat-s,
     tests/fixtures/theta300.dat-s and bench.py's theta800,
     lovasz_theta(n=800, avg_degree=8, seed=5) (ALM, ADMM with CG on the
     K7a operator, exact-eigh certificate, spectral dual repair);
   - the CGNR dual refinement: theta_gtoy60 with the spectral repair
     replaced by a reject in this process, so that the solve takes the
     CGNR refinement (K4 in every iteration), rejects its step and
     ends by the level-2 reopt, held to lorads_tpu's CPU run of the
     same forced path (status and objective);
   - multi-block and LP: tests/fixtures/hand_multiblock.dat-s (two dense
     one-block buckets on local slots, an LP block of 2 columns), solved
     with Jacobi and with Gauss-Seidel (K8c) LP sweeps;
     random_multiblock(22 blocks of dim 12, m=40, seed 21) (one dense
     bucket of 22 blocks sharing constraints: the bucket Gauss-Seidel
     scan); random_multiblock(8 blocks of dim 40, m=120, 400 LP
     columns, seed 5) with Gauss-Seidel LP sweeps;
   - a batch: merge_problems of four maxcut(n=20000, deg 8, seeds 7-10)
     (one split diag-identity bucket of 4 blocks on disjoint slots:
     ADMM would sweep them at once; K2, K3 and the Lanczos certificate
     at B = 4), the batch and each instance's objective held to
     lorads_tpu's solve of that instance alone.
   Phase 3 adds, at the shapes of that path: K8a / K8b (K4 on the LP's
   constraint- and column-sorted entries) and K8c (the Gauss-Seidel LP
   sweep, bit for bit) at random_multiblock(8, 40, 120, 400 LP
   columns)'s LP block, K4's scatter of its 8 blocks' local constraint
   values, and K2 / K3 at the maxcut batch's B = 4;
   - the probes (lorads_torch.probes, the counterparts of the Pallas
     kernels of tools/probes/): phase 3 holds P1 onehot_scatter and P2
     onehot_gather (tensor-core one-hot window products), P3 row_gather
     and P4 scatter_add to their plain versions at the probes' shapes
     (n=20000, K=80000-160000, r=20-24), and K3 at the fused uvT probe's
     shape (R=24, n=20000, K=100000, f32); the path is the probe driver,
     `python -m lorads_torch.probes --small`, run in this process.

The line before the last is the JSON kernel summary; the last line is
{"ok": true, "device": {...}}.  Any failed phase raises and exits
nonzero without that line.  Needs no network and no JAX.

With --kernels-of DIR only phases 1-3 run, on the lorads_torch of the
checkout at DIR (built into DIR/build), timed by this checkout's
lorads_torch/timing.py; the last line is {"kernels_of": DIR, "cases":
{kernel: [case, ...]}}.  Two checkouts compare on one card by running
both in one call, in turns.
"""

import functools
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")


def _gen():
    from lorads_torch.io import generators
    return generators


def _sdpa(name):
    from lorads_torch.io.sdpa import read_sdpa
    return read_sdpa(os.path.join(FIX, name))


# the main paths' instances, by name (profile_solve.py reads them too)
INSTANCES = {
    "maxcut300": lambda: _gen().maxcut(n=300, avg_degree=4, seed=3),
    "maxcut20000": lambda: _gen().maxcut(n=20000, avg_degree=8, seed=7),
    "gset_torus10000": lambda: _gen().maxcut_from_graph(
        os.path.join(FIX, "gset_torus10000.rudy")),
    "matcomp500": lambda: _sdpa("matcomp500.dat-s"),
    "matcomp2000": lambda: _gen().matrix_completion(
        n1=2000, n2=2000, true_rank=3, frac_obs=0.12, seed=3),
    "theta_gtoy60": lambda: _sdpa("theta_gtoy60.dat-s"),
    "theta300": lambda: _sdpa("theta300.dat-s"),
    "theta800": lambda: _gen().lovasz_theta(n=800, avg_degree=8, seed=5),
    "hand_multiblock": lambda: _sdpa("hand_multiblock.dat-s"),
    "hand_multiblock_gs": lambda: _sdpa("hand_multiblock.dat-s"),
    "multiblock22": lambda: _gen().random_multiblock(
        n_blocks=22, dim=12, m=40, density=0.3, seed=21),
    "multiblock_lp": lambda: _gen().random_multiblock(
        n_blocks=8, dim=40, m=120, density=0.05, n_lp=400, seed=5),
    "maxcut20000x4": lambda: _merged([_gen().maxcut(
        n=20000, avg_degree=8, seed=s) for s in (7, 8, 9, 10)]),
}
# solver options of an instance (default LoradsParams otherwise)
PARAMS = {"hand_multiblock_gs": dict(lp_gauss_seidel=True),
          "multiblock_lp": dict(lp_gauss_seidel=True)}


def _merged(problems):
    from lorads_torch.core.problem import merge_problems
    merged = merge_problems(problems)
    merged.parts = problems          # for the per-instance objectives
    return merged


# lorads_tpu on CPU at f64 (objective of each main-path instance)
REFERENCE_POBJ = {
    "maxcut300": -5.046605560e+02,
    "maxcut20000": -6.209725666e+04,
    "gset_torus10000": -7.762241872e+03,
    "matcomp500": 3.021053389e+03,
    "matcomp2000": 1.204995184e+04,
    "theta_gtoy60": -24.209496946891917,
    "theta300": -154.24257520621822,
    "theta800": -426.5939149561383,
    "hand_multiblock": 0.21774877836010853,
    "hand_multiblock_gs": 0.21774893891060546,
    "multiblock22": 106.14210206550646,
    "multiblock_lp": 191.50494359343332,
    # the batch's optimum is the sum of its instances': lorads_tpu's
    # single-instance solves below, summed
    "maxcut20000x4": -248319.05656104838,
}
# lorads_tpu on CPU at f64, each instance of the merged maxcut batch
# solved alone (seeds 7-10).  lorads_tpu's own merged solve of the batch
# stops 2.4e-4 lower (-248378.72611070029, after growing the rank from 20
# to 30): the two certified answers lie further apart than the 1e-4 band,
# so the batch is held to the instances, as a batch must equal them.
REFERENCE_SPLIT = {"maxcut20000x4": (-62097.25666, -62076.14471913608,
                                     -62080.6703693886, -62064.98481252369)}
# lorads_tpu on CPU at f64 with its spectral dual repair forced to reject:
# the CGNR refinement rejects its step (dinf 3.28e-04 before and after),
# two level-2 reopts leave dinf at 2.58e-04, outside its band
REFERENCE_CGNR = {"theta_gtoy60": ("primal_optimal", -24.214264131151737)}
# the kernels each main path must launch
PATH_KERNELS = {
    "maxcut": ("cmul_csr", "uvt_split"),
    "matcomp": ("uvt_split", "uvt_pair_split", "gather_segsum", "wmul_csr",
                "adj_a_offdiag"),
    "theta": ("gather_segsum", "adj_a_dense"),
    "cgnr": ("gather_segsum", "adj_a_dense"),
    "lp": ("gather_segsum", "lp_gs_sweep"),
    "batch": ("cmul_csr", "uvt_split"),
    "probes": ("onehot_scatter", "onehot_gather", "row_gather",
               "scatter_add", "uvt_split"),
}
POBJ_RTOL = 1e-4
# the card's device-memory rate, its peak rates outside the tensor cores
# and its dense tensor-core peaks (NVIDIA H100 SXM data sheet: 67 TFLOP/s
# f32, 34 TFLOP/s f64; tensor cores 989 TFLOP/s bf16, 494 TFLOP/s TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"f32": 67e12, "f64": 34e12, "bf16": 989e12,
                   "tf32": 494e12}


@functools.lru_cache(maxsize=None)
def timing():
    """This checkout's lorads_torch/timing.py, loaded by its path, so that
    --kernels-of times another checkout's kernels with the same code."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "lorads_torch", "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def bound_of(nbytes, flops, sfx):
    """(least ms the card could take, what bounds it): the bytes the
    function must move over the memory rate, or its operations over the
    peak rate for its type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[sfx] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Measure:
    """Runs one kernel case: the kernel and its plain version on the same
    inputs, the check against the stated tolerance (and bit equality
    where asked), CUDA-event times of the kernel, the plain version and
    the one-call library counterpart (if any), dispatched (``ms``: the
    host's launch included) and on the device alone (``device_ms``: 20
    calls in one CUDA graph, or the profiler's kernel time for a call a
    graph cannot hold), and the bound."""

    def __init__(self, card):
        self.card = card
        self.results = {}

    def __call__(self, kname, label, sfx, fn, plain, l1, nbytes, flops,
                  library=None, exact=None, tol=None, steps=None):
        import numpy as np
        import torch

        cuda_time_ms, device_time_ms = (timing().cuda_time_ms,
                                        timing().device_time_ms)
        got = fn()
        ref = plain()
        torch.cuda.synchronize()
        if tol is None:
            # f64: both sides sum the same terms directly in another
            # order; f32: compensated kernel vs the plain version's f64
            # accumulation (K1, K2, K4, K5) or f32 row dots of r terms
            tol = (64 * float(np.finfo(np.float64).eps) if sfx == "f64"
                   else 4 * float(np.finfo(np.float32).eps))
        bound = tuple(tol * a.double() + 1e-300 for a in l1) \
            if isinstance(l1, tuple) else tol * l1.double() + 1e-300
        err = check(f"{kname} {label}", got, ref, bound)
        exact_note = ""
        if exact is not None:
            for g, e in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                sel = (slice(None),) if exact is True else (slice(None),
                                                            exact)
                if not torch.equal(g[sel], e[sel]):
                    raise AssertionError(f"{kname} {label}: not exact")
            exact_note = (", exact" if exact is True else
                          f", exact on {int(exact.sum())} single-entry "
                          "segments")
        ms = cuda_time_ms(fn)
        pms = cuda_time_ms(plain)
        dev_ms, dev_by = device_time_ms(fn)
        lib_ms = lib_dev_ms = lib_dev_by = None
        if library is not None:
            lib_ms = cuda_time_ms(library)
            lib_dev_ms, lib_dev_by = device_time_ms(library)
        bms, by = bound_of(nbytes, flops, sfx)
        # a sequential kernel: its time per dependent step
        step_note = ("" if steps is None or dev_ms is None else
                     f" ({dev_ms / steps * 1e3:.3f} us per dependent step "
                     "on the device)")

        def fmt(t, how):
            return "none" if t is None else f"{t:.4f} ms ({how})"

        print(f"{kname} [{label}]: max_abs_err {err:.3e} (tol {tol:.1e} x "
              f"|terms|{exact_note}) kernel {ms:.4f} ms device "
              f"{fmt(dev_ms, dev_by)} plain {pms:.4f} ms library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} device "
              f"{fmt(lib_dev_ms, lib_dev_by)} bound {bms:.6f} ms{step_note} "
              f"({by}: {nbytes} B, {flops} flop)  [{self.card}]")
        self.results.setdefault(kname, []).append(dict(
            label=label, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms))


def _csr(rows, cols, vals, shape):
    """A torch CSR tensor of the entries (duplicates summed), for the
    library timings; shape (rows, cols), or n for n x n."""
    import torch
    if isinstance(shape, int):
        shape = (shape, shape)
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                  vals, shape).coalesce()
    return coo.to_sparse_csr()


def _seg_csr(idx, val, bnd, ncols, alpha=1.0):
    """K4's entry list (block 0) as the [S, ncols] CSR matrix whose row s
    holds alpha * val at the columns idx of segment s, so that K4 is one
    sparse product: out = base + M @ x (library timings only)."""
    import torch
    b = bnd[0].long()
    lo, hi = int(b[0]), int(b[-1])
    rows = torch.repeat_interleave(
        torch.arange(b.numel() - 1, device=b.device), b.diff())
    return _csr(rows, idx[0, lo:hi], alpha * val[0, lo:hi],
                (b.numel() - 1, ncols))


def _seg_library(M, x, base=None):
    """The one-call counterpart of K4 on block 0: torch.sparse.mm, or
    torch.addmm when there is a base."""
    import torch
    xc = x[0].reshape(-1, 1)
    if base is None:
        return lambda: torch.sparse.mm(M, xc)
    bc = base[0].reshape(-1, 1)
    return lambda: torch.addmm(bc, M, xc)


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
    rng = np.random.default_rng(0)
    measure = Measure(card)

    problem = generators.maxcut(n=20000, avg_degree=8, seed=7)
    ps = presolve(problem, LoradsParams())
    bp = ps.buckets[0]
    r = bp.rank
    bk64 = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    bk32 = pat.cast_floats(bk64, torch.float32)
    n, Ks, Ko = bk64.n, bk64.Ks, bk64.Ko
    print(f"main-path shapes: n={n} Ks={Ks} Ko={Ko} rank={r}")
    diag = torch.arange(n, device=dev)

    def row_l1(bk, X, with_diag):
        """|C| @ |X| row sums: the sum of |terms| of each output."""
        return kernels.cmul_csr_plain(
            X.abs(), bk.c_diag.abs() if with_diag else None,
            bk.sym_cols_rs, bk.c_sym_rs.abs(), bk.bnd_sym_rows)

    # ---- K2 cmul_csr (library: torch.sparse.mm on C as a CSR tensor)
    for label, bk, dt, rr, wd in (
            ("f64 r=%d diag" % r, bk64, torch.float64, r, True),
            ("f64 r=1 no-diag", bk64, torch.float64, 1, False),
            ("f32 r=1 no-diag", bk32, torch.float32, 1, False)):
        sfx = label[:3]
        s = 8 if dt == torch.float64 else 4
        X = torch.as_tensor(rng.standard_normal((1, n, rr)), device=dev,
                            dtype=dt)
        cd = bk.c_diag if wd else None
        args = (X, cd, bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
        rows = torch.cat([bk.sym_rows_rs[0]] + ([diag] if wd else []))
        cols = torch.cat([bk.sym_cols_rs[0]] + ([diag] if wd else []))
        vals = torch.cat([bk.c_sym_rs[0]] + ([bk.c_diag[0]] if wd else []))
        C = _csr(rows, cols, vals, n)
        X0 = X[0]
        measure("cmul_csr", label, sfx, lambda: kernels.cmul_csr(*args),
                lambda: kernels.cmul_csr_plain(*args), row_l1(bk, X, wd),
                nbytes=2 * n * rr * s + Ks * (4 + s) + (n + 1) * 4
                + (n * s if wd else 0),
                flops=2 * Ks * rr + (2 * n * rr if wd else 0),
                library=lambda: torch.sparse.mm(C, X0))

    # ---- K3 uvt_split (library: torch.sparse.sampled_addmm on the off
    # pattern gives U V^T there; it leaves out the symmetrisation
    # (U V^T + V U^T) / 2 and the diagonal rowsum)
    U = torch.as_tensor(rng.standard_normal((1, n, r)), device=dev)
    V = torch.as_tensor(rng.standard_normal((1, n, r)), device=dev)
    args = (U, V, bk64.off_rows, bk64.off_cols)
    Poff = _csr(bk64.off_rows[0], bk64.off_cols[0],
                torch.ones(Ko, dtype=torch.float64, device=dev), n)
    U0, Vt = U[0], V[0].T.contiguous()
    measure("uvt_split", f"f64 r={r}", "f64",
            lambda: kernels.uvt_split(*args),
            lambda: kernels.uvt_split_plain(*args),
            kernels.uvt_split_plain(U.abs(), V.abs(), bk64.off_rows,
                                    bk64.off_cols),
            nbytes=2 * n * r * 8 + 2 * Ko * 4 + (n + Ko) * 8,
            flops=2 * n * r + 4 * Ko * r,
            library=lambda: torch.sparse.sampled_addmm(Poff, U0, Vt,
                                                       beta=0.0))

    # ---- K1 segment_sum: the segment sum cmul fuses, unfused: [1, Ks, r]
    # products over the row pointers of the maxcut n=20000 entry list
    # (library: torch.segment_reduce)
    contrib = (bk64.c_sym_rs[:, :, None]
               * U[0].index_select(0, bk64.sym_cols_rs[0].long())[None])
    offs = bk64.bnd_sym_rows.long()
    for dt in (torch.float64, torch.float32):
        sfx = "f64" if dt == torch.float64 else "f32"
        s = 8 if dt == torch.float64 else 4
        data = contrib.to(dt).contiguous()
        bnd = bk64.bnd_sym_rows
        measure("segment_sum", f"main-path {sfx} r={r}", sfx,
                lambda: kernels.segment_sum(data, bnd),
                lambda: kernels.segment_sum_plain(data, bnd),
                kernels.segment_sum_plain(data.abs(), bnd),
                nbytes=Ks * r * s + (n + 1) * 4 + n * r * s,
                flops=Ks * r,
                library=lambda: torch.segment_reduce(
                    data, "sum", offsets=offs, axis=1))
    segment_sum_edges(rng, dev)
    matcomp_kernel_checks(rng, measure)
    theta_kernel_checks(rng, measure)
    gather_segsum_skewed(rng, dev)
    multiblock_kernel_checks(rng, measure)
    probe_kernel_checks(rng, measure)
    return measure.results


def segment_sum_edges(rng, dev):
    """K1 edge cases: empty segments, padded blocks (B=2, second block's
    entries end early), 2-D and 3-D data, single-entry segments."""
    import numpy as np
    import torch

    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    B, N, S = 2, 3 * 512 + 7, 97
    ids = np.sort(rng.integers(0, S, (B, N)), axis=1)
    ids[:, :5] = 0                      # a long first segment
    ids[1, N // 2:] = S                 # padded tail past the last bound
    ids = np.clip(ids, 0, S)
    bnd = torch.as_tensor(pat._bounds_np(ids, S), device=dev)
    for shape in ((B, N), (B, N, 3), (B, N, 40)):
        for dt in (torch.float64, torch.float32):
            d = torch.as_tensor(rng.standard_normal(shape), device=dev,
                                dtype=dt)
            got = kernels.segment_sum(d, bnd)
            ref = kernels.segment_sum_plain(d, bnd)
            l1 = kernels.segment_sum_plain(d.abs(), bnd).double()
            torch.cuda.synchronize()
            tol = (64 if dt == torch.float64 else 4) * torch.finfo(dt).eps
            err = check(f"segment_sum edges {shape}", got, ref,
                        tol * l1 + 1e-300)
            print(f"segment_sum [edges {str(dt)[6:]} {shape}]: max_abs_err "
                  f"{err:.3e} (tol {tol:.1e} x segment |terms|)")
    single = np.sort(rng.choice(S, size=40, replace=False))[None]
    sb = torch.as_tensor(pat._bounds_np(single, S), device=dev)
    d = torch.as_tensor(rng.standard_normal((1, 40)), device=dev)
    if not torch.equal(kernels.segment_sum(d, sb),
                       kernels.segment_sum_plain(d, sb)):
        raise AssertionError("segment_sum single-entry: not exact")
    print("segment_sum [single-entry segments]: exact")


def skewed_layouts(rng):
    """K4 layouts with skewed segment lengths, as [B, S] length arrays
    (B = 2; the second row a permutation of the first with its longest
    segment cut by 1000 entries, so its bounds end before N): 80000
    segments of one entry or none (10 %) with one of 800, one of 5000 and
    one of 70000 entries among them (mean under 2: one lane per segment,
    the long ones taken by whole warps); 2000 segments of 0-6 entries
    with one of 800 and thirty of 33-40 (mean 3.5: four lanes per
    segment, the long ones taken by whole warps); 400 segments of 0-120
    entries (a warp per segment)."""
    import numpy as np
    out = []
    one = (rng.random(80000) >= 0.1).astype(np.int64)
    one[[100, 40000, 79999]] = (800, 5000, 70000)
    mid = rng.integers(0, 7, 2000)
    mid[rng.choice(2000, 30, replace=False)] = rng.integers(33, 41, 30)
    mid[1000] = 800
    for lengths in (one, mid, rng.integers(0, 121, 400)):
        second = rng.permutation(lengths)
        second[np.argmax(second)] -= min(1000, int(second.max()))
        out.append(np.stack([lengths, second]))
    return out


def gather_segsum_skewed(rng, dev):
    """K4 against its plain version on skewed_layouts, f64 and f32, with
    and without base and alpha: within 64 eps64 / 4 eps32 x the sum of
    |terms| of each output, bit for bit on one-entry segments."""
    import numpy as np
    import torch

    from lorads_torch.ops import kernels
    device_time_ms = timing().device_time_ms
    for lengths in skewed_layouts(rng):
        B, S = lengths.shape
        N, Nx = int(lengths.sum(axis=1).max()), 20000
        bnd = np.zeros((B, S + 1), np.int32)
        bnd[:, 1:] = np.cumsum(lengths, axis=1)
        bnd = torch.as_tensor(bnd, device=dev)
        idx = torch.as_tensor(rng.integers(0, Nx, (B, N)).astype(np.int32),
                              device=dev)
        single = torch.as_tensor(lengths == 1, device=dev)
        for dt in (torch.float64, torch.float32):
            tol = (64 if dt == torch.float64 else 4) * torch.finfo(dt).eps

            def rand(*shape):
                return torch.as_tensor(rng.standard_normal(shape),
                                       device=dev, dtype=dt)

            x, val = rand(B, Nx), rand(B, N)
            for base, alpha in ((None, 1.0), (rand(B, S), -0.75)):
                args = (x, idx, val, bnd, base, alpha)
                got = kernels.gather_segsum(*args)
                ref = kernels.gather_segsum_plain(*args)
                l1 = kernels.gather_segsum_plain(
                    x.abs(), idx, val.abs(), bnd,
                    None if base is None else base.abs(), abs(alpha))
                torch.cuda.synchronize()
                label = (f"skewed B={B} S={S} N={N} longest "
                         f"{int(lengths.max())} {str(dt)[6:]} "
                         f"{'base, alpha' if base is not None else 'no base'}")
                err = check(f"gather_segsum {label}", got, ref,
                            tol * l1.double() + 1e-300)
                if not torch.equal(got[single], ref[single]):
                    raise AssertionError(f"gather_segsum {label}: one-entry "
                                         "segments not exact")
                dev_ms, how = device_time_ms(
                    lambda: kernels.gather_segsum(*args))
                print(f"gather_segsum [{label}]: max_abs_err {err:.3e} (tol "
                      f"{tol:.1e} x |terms|, exact on {int(single.sum())} "
                      f"one-entry segments) device {dev_ms:.4f} ms ({how})")


def matcomp_kernel_checks(rng, measure):
    """Phase 3, matrix-completion path: K3p, K4, K5 and K6 against their
    plain versions at matcomp2000's shapes."""
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
    n, Ko, Ks, m = bk64.n, bk64.Ko, bk64.Ks, problem.m
    print(f"matcomp-path shapes: n={n} m={m} Ko={Ko} Ks={Ks} "
          f"rank={r} a_off_unique={bk64.a_off_unique}")

    def rand(shape, dt):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=dt)

    slot = bk64.sym_slot_rs[0].long()
    for dt, bk in ((torch.float64, bk64), (torch.float32, bk32)):
        sfx = "f64" if dt == torch.float64 else "f32"
        s = 8 if dt == torch.float64 else 4
        # ---- K3p uvt_pair_split (ALM line search; f64 only on the path)
        if dt == torch.float64:
            R, D = rand((1, n, r), dt), rand((1, n, r), dt)
            a = (bk.off_rows, bk.off_cols)
            measure("uvt_pair_split", f"{sfx} r={r}", sfx,
                    lambda: kernels.uvt_pair_split(R, D, *a),
                    lambda: kernels.uvt_pair_split_plain(R, D, *a),
                    kernels.uvt_pair_split_plain(R.abs(), D.abs(), *a),
                    nbytes=2 * n * r * s + 2 * Ko * 4 + 2 * (n + Ko) * s,
                    flops=4 * n * r + 6 * Ko * r)
        # ---- K4 gather_segsum: A(.) (one entry per constraint: exact)
        # (library, here and below: K4's entry list as a CSR matrix,
        # built once, times x by torch.sparse.mm, or torch.addmm with C)
        o = rand((1, Ko), dt)
        a4 = (o, bk.a_pos_o_cs, bk.a_val_o_cs, bk.bnd_a_con_o_cs)
        N = bk.a_pos_o_cs.shape[1]
        measure("gather_segsum", f"{sfx} A(.) m={m}", sfx,
                lambda: kernels.gather_segsum(*a4, alpha=2.0),
                lambda: kernels.gather_segsum_plain(*a4, None, 2.0),
                kernels.gather_segsum_plain(o.abs(), a4[1], a4[2].abs(),
                                            a4[3], None, 2.0),
                nbytes=N * (2 * s + 4) + (m + 1) * 4 + m * s,
                flops=3 * N, exact=True,
                library=_seg_library(_seg_csr(*a4[1:], Ko, alpha=2.0), o))
        # ---- K4: C + A^*(w) onto the Ko slots
        w = rand((1, m), dt)
        a4w = (w, bk.a_con_o_s, bk.a_val_o_s, bk.bnd_a_pos_o_s)
        measure("gather_segsum", f"{sfx} A^*(w)+C Ko={Ko}", sfx,
                lambda: kernels.gather_segsum(*a4w, base=bk.c_off),
                lambda: kernels.gather_segsum_plain(*a4w, bk.c_off),
                kernels.gather_segsum_plain(w.abs(), a4w[1], a4w[2].abs(),
                                            a4w[3], bk.c_off.abs()),
                nbytes=m * s + N * (4 + s) + (Ko + 1) * 4 + 2 * Ko * s,
                flops=2 * N + Ko,
                library=_seg_library(_seg_csr(*a4w[1:], m), w, bk.c_off))
        # ---- K5 wmul_csr at r = rank (gradient, CG) and r = 1 (Lanczos)
        # (library: torch.sparse.mm on W as a CSR tensor)
        W_d, W_o = rand((1, n), dt), rand((1, Ko), dt)
        a5 = (bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows)
        diag = torch.arange(n, device=dev)
        Wc = _csr(torch.cat([bk.sym_rows_rs[0], diag]),
                  torch.cat([bk.sym_cols_rs[0], diag]),
                  torch.cat([W_o[0][slot], W_d[0]]), n)
        for rr in (r, 1):
            X = rand((1, n, rr), dt)
            X0 = X[0]
            measure("wmul_csr", f"{sfx} r={rr}", sfx,
                    lambda: kernels.wmul_csr(X, W_d, W_o, *a5),
                    lambda: kernels.wmul_csr_plain(X, W_d, W_o, *a5),
                    kernels.wmul_csr_plain(X.abs(), W_d.abs(), W_o.abs(),
                                           *a5),
                    nbytes=2 * n * rr * s + (n + Ko) * s + Ks * 8
                    + (n + 1) * 4,
                    flops=2 * (Ks + n) * rr,
                    library=lambda: torch.sparse.mm(Wc, X0))
        # ---- K6 adj_a_offdiag (every CG matvec)
        X, F = rand((1, n, r), dt), rand((1, n, r), dt)
        a6 = (bk.off_rows, bk.off_cols, bk.a2_off)
        measure("adj_a_offdiag", f"{sfx} r={r}", sfx,
                lambda: kernels.adj_a_offdiag(X, F, *a6)[1],
                lambda: kernels.adj_a_offdiag_plain(X, F, *a6, False)[1],
                kernels.adj_a_offdiag_plain(X.abs(), F.abs(), *a6,
                                            False)[1],
                nbytes=2 * n * r * s + 2 * Ko * 4 + 2 * Ko * s,
                flops=4 * Ko * r + Ko)


def theta_kernel_checks(rng, measure):
    """Phase 3, theta path: K7a and K4 on the dense layouts at theta800's
    shapes (bench.py's lovasz_theta(n=800, avg_degree=8, seed=5)), at f64
    and in f32 as the mixed-precision CG runs them."""
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    problem = generators.lovasz_theta(n=800, avg_degree=8, seed=5)
    bp = presolve(problem, LoradsParams()).buckets[0]
    r = bp.rank
    bk64 = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    bk32 = pat.cast_floats(bk64, torch.float32)
    n, m = bk64.n, problem.m
    N1, N2 = bk64.a_lin_cs.shape[1], bk64.a_con2_s.shape[1]
    Ndd = bk64.dd_row_cs.shape[1]
    print(f"theta-path shapes: n={n} n^2={n * n} m={m} nnz_a={bk64.nnz_a} "
          f"rank={r} a_single_dense={bk64.a_single_dense} "
          f"nnz_dd={bk64.nnz_dd} A(.) entries {N1}, A^*(w) entries {N2}")
    if not (bk64.dense and bk64.a_single_dense):
        raise AssertionError("theta800 did not build a single-entry "
                             "dense bucket")
    seg = bk64.bnd_a_con_cs[0, 1:] - bk64.bnd_a_con_cs[0, :-1]
    single = seg == 1

    def rand(shape, dt):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=dt)

    for dt, bk in ((torch.float64, bk64), (torch.float32, bk32)):
        sfx = "f64" if dt == torch.float64 else "f32"
        s = 8 if dt == torch.float64 else 4
        # ---- K7a adj_a_dense: the CG operator's A^*(A(X)) plane on
        # X = sym(x F^T); product and diagonal sum rounded separately,
        # so kernel and plain version agree bit for bit
        X = pat._sym_product(rand((1, n, r), dt), rand((1, n, r), dt))
        W_d = rand((1, n), dt)
        measure("adj_a_dense", f"{sfx} n={n}", sfx,
                lambda: kernels.adj_a_dense(X, bk.a2_full, W_d),
                lambda: kernels.adj_a_dense_plain(X, bk.a2_full, W_d),
                kernels.adj_a_dense_plain(X.abs(), bk.a2_full.abs(),
                                          W_d.abs()),
                nbytes=3 * n * n * s + n * s, flops=n * n + n, exact=True)
        # ---- K4: dense A(.) over the flat [1, n^2] view (layout (i)):
        # bit for bit on the single-entry constraints, the trace one
        # segment of n entries walked by a whole warp
        flat = rand((1, n * n), dt)
        a4 = (flat, bk.a_lin_cs, bk.a_val_inner_cs, bk.bnd_a_con_cs)
        measure("gather_segsum", f"{sfx} dense A(.) m={m}", sfx,
                lambda: kernels.gather_segsum(*a4),
                lambda: kernels.gather_segsum_plain(*a4),
                kernels.gather_segsum_plain(flat.abs(), a4[1], a4[2].abs(),
                                            a4[3]),
                nbytes=N1 * (2 * s + 4) + (m + 1) * 4 + m * s,
                flops=2 * N1, exact=single,
                library=_seg_library(_seg_csr(*a4[1:], n * n), flat))
        # ---- K4: C + A^*(w) onto the n^2 slots (layout (ii))
        w = rand((1, m), dt)
        base = bk.c_full.reshape(1, n * n)
        a4w = (w, bk.a_con2_s, bk.a_val2_s, bk.bnd_a_lin2)
        measure("gather_segsum", f"{sfx} dense C+A^*(w) S={n * n}", sfx,
                lambda: kernels.gather_segsum(*a4w, base=base),
                lambda: kernels.gather_segsum_plain(*a4w, base),
                kernels.gather_segsum_plain(w.abs(), a4w[1], a4w[2].abs(),
                                            a4w[3], base.abs()),
                nbytes=m * s + N2 * (4 + s) + (n * n + 1) * 4
                + 2 * n * n * s,
                flops=2 * N2 + n * n,
                library=_seg_library(_seg_csr(*a4w[1:], m), w, base))
        # ---- K4: the two dd sums of the CG operator (layout (iii))
        d = rand((1, n), dt)
        add = (d, bk.dd_row_cs, bk.dd_val_cs, bk.bnd_dd_con)
        measure("gather_segsum", f"{sfx} dense dd A(.) m={m}", sfx,
                lambda: kernels.gather_segsum(*add),
                lambda: kernels.gather_segsum_plain(*add),
                kernels.gather_segsum_plain(d.abs(), add[1], add[2].abs(),
                                            add[3]),
                nbytes=n * s + Ndd * (4 + s) + (m + 1) * 4 + m * s,
                flops=2 * Ndd,
                library=_seg_library(_seg_csr(*add[1:], n), d))
        v = rand((1, m), dt)
        adr = (v, bk.dd_con_rs, bk.dd_val_rs, bk.bnd_dd_row)
        measure("gather_segsum", f"{sfx} dense dd A^*(v) n={n}", sfx,
                lambda: kernels.gather_segsum(*adr),
                lambda: kernels.gather_segsum_plain(*adr),
                kernels.gather_segsum_plain(v.abs(), adr[1], adr[2].abs(),
                                            adr[3]),
                nbytes=Ndd * (2 * s + 4) + (n + 1) * 4 + n * s,
                flops=2 * Ndd,
                library=_seg_library(_seg_csr(*adr[1:], m), v))


def multiblock_kernel_checks(rng, measure):
    """Phase 3, multi-block / LP and batch paths: K8a and K8b (K4 on the
    LP's sorted entries) and K8c at multiblock_lp's LP block (400
    columns, m=120), K4's scatter of its 8 blocks' local constraint
    values, and K2 / K3 at the maxcut batch's B = 4."""
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.ops import kernels
    from lorads_torch.ops import lp as lp_ops
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    s = 8

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=torch.float64)

    problem = INSTANCES["multiblock_lp"]()
    lpd = lp_ops.build_lp_data(problem.lp, torch.float64, dev)
    n, m, N, L = lpd.n_cols, lpd.m_glob, lpd.nnz, lpd.max_nnz_col
    bp = presolve(problem, LoradsParams()).buckets[0]
    bk = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    print(f"lp-path shapes: LP columns {n} m={m} entries {N} (at most {L} "
          f"per column); bucket B={bk.B} n={bk.n} m_loc={bk.m_loc} "
          f"scatter entries {bk.scat_idx.shape[1]}")
    # ---- K8a: A_lp(uv) over the constraint-sorted entries
    uv = rand(n)
    a8 = (lpd.a_col_cs[None], lpd.a_val_cs[None], lpd.bnd_con[None])
    measure("gather_segsum", f"f64 K8a LP A_lp(uv) m={m}", "f64",
            lambda: lp_ops.constr_vals(lpd, uv),
            lambda: kernels.gather_segsum_plain(uv[None], *a8)[0],
            kernels.gather_segsum_plain(uv.abs()[None], a8[0],
                                        a8[1].abs(), a8[2])[0],
            nbytes=N * (4 + s) + n * s + (m + 1) * 4 + m * s, flops=2 * N,
            library=_seg_library(_seg_csr(*a8, n), uv[None]))
    # ---- K8b: c - A_lp^T lambda (certificate) over the column-sorted
    # entries; the ALM gradient's c + A_lp^T w is the same launch
    w = rand(m)
    b8 = (lpd.a_con_ls[None], lpd.a_val_ls[None], lpd.bnd_col[None])
    measure("gather_segsum", f"f64 K8b LP c - A_lp^T w n={n}", "f64",
            lambda: lp_ops.adjoint_cols(lpd, w, base=lpd.obj, alpha=-1.0),
            lambda: kernels.gather_segsum_plain(w[None], *b8, lpd.obj[None],
                                                -1.0)[0],
            kernels.gather_segsum_plain(w.abs()[None], b8[0], b8[1].abs(),
                                        b8[2], lpd.obj.abs()[None])[0],
            nbytes=N * (4 + s) + m * s + (n + 1) * 4 + 2 * n * s,
            flops=2 * N + n,
            library=_seg_library(_seg_csr(*b8, m, alpha=-1.0), w[None],
                                 lpd.obj[None]))
    # ---- K8c: the Gauss-Seidel LP sweep, bit for bit
    u, v = rand(n), rand(n)
    csum, dual = rand(m), rand(m)
    a8c = (lpd.pc_con, lpd.pc_val, lpd.obj, lpd.col_nrm2sq, u, v, csum,
           rand(m), dual, 5.0)
    measure("lp_gs_sweep", f"f64 K8c n_lp={n} L={L} (dependent steps: {n})",
            "f64", lambda: kernels.lp_gs_sweep(*a8c),
            lambda: kernels.lp_gs_sweep_plain(*a8c),
            (torch.ones(n, dtype=torch.float64, device=dev),
             torch.ones(m, dtype=torch.float64, device=dev)),
            nbytes=n * L * (4 + s) + 5 * n * s + 4 * m * s,
            flops=9 * N + 12 * n, exact=True, tol=0.0, steps=n)
    # ---- K4: scatter_constr of the bucket's local values into [m]
    vals = rand(bk.B, bk.m_loc)
    sc = (bk.scat_idx, bk.scat_val, bk.bnd_scat)
    S = sc[0].shape[1]
    measure("gather_segsum", f"f64 scatter_constr B={bk.B} m={m}", "f64",
            lambda: pat.scatter_constr(bk, vals),
            lambda: kernels.gather_segsum_plain(vals.reshape(1, -1),
                                                *sc)[0],
            kernels.gather_segsum_plain(vals.abs().reshape(1, -1), *sc)[0],
            nbytes=S * (4 + s) + bk.B * bk.m_loc * s + (m + 1) * 4 + m * s,
            flops=2 * S,
            library=_seg_library(_seg_csr(*sc, bk.B * bk.m_loc),
                                 vals.reshape(1, -1)))

    # ---- K2 / K3 at the maxcut batch's B = 4 (library: the four blocks
    # as one block-diagonal CSR matrix, one call)
    problem = INSTANCES["maxcut20000x4"]()
    bp = presolve(problem, LoradsParams()).buckets[0]
    bk = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    B, nb, r, Ks, Ko = bk.B, bk.n, bp.rank, bk.Ks, bk.Ko
    print(f"batch-path shapes: B={B} n={nb} Ks={Ks} Ko={Ko} rank={r} "
          f"diag_ident={bk.diag_ident} glob_ident={bk.glob_ident}")
    off = (torch.arange(B, device=dev) * nb)[:, None]
    diag = torch.arange(B * nb, device=dev)
    X = rand(B, nb, r)
    args = (X, bk.c_diag, bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
    C = _csr(torch.cat([(bk.sym_rows_rs + off).reshape(-1), diag]),
             torch.cat([(bk.sym_cols_rs + off).reshape(-1), diag]),
             torch.cat([bk.c_sym_rs.reshape(-1), bk.c_diag.reshape(-1)]),
             B * nb)
    Xf = X.reshape(B * nb, r)
    measure("cmul_csr", f"f64 B={B} r={r} diag", "f64",
            lambda: kernels.cmul_csr(*args),
            lambda: kernels.cmul_csr_plain(*args),
            kernels.cmul_csr_plain(X.abs(), bk.c_diag.abs(), bk.sym_cols_rs,
                                   bk.c_sym_rs.abs(), bk.bnd_sym_rows),
            nbytes=2 * B * nb * r * s + B * Ks * (4 + s)
            + B * (nb + 1) * 4 + B * nb * s,
            flops=2 * B * (Ks + nb) * r,
            library=lambda: torch.sparse.mm(C, Xf))
    U, V = rand(B, nb, r), rand(B, nb, r)
    a3 = (U, V, bk.off_rows, bk.off_cols)
    Poff = _csr((bk.off_rows + off).reshape(-1),
                (bk.off_cols + off).reshape(-1),
                torch.ones(B * Ko, dtype=torch.float64, device=dev), B * nb)
    Uf, Vt = U.reshape(B * nb, r), V.reshape(B * nb, r).T.contiguous()
    measure("uvt_split", f"f64 B={B} r={r}", "f64",
            lambda: kernels.uvt_split(*a3),
            lambda: kernels.uvt_split_plain(*a3),
            kernels.uvt_split_plain(U.abs(), V.abs(), bk.off_rows,
                                    bk.off_cols),
            nbytes=2 * B * nb * r * s + 2 * B * Ko * 4 + B * (nb + Ko) * s,
            flops=B * (2 * nb * r + 4 * Ko * r),
            library=lambda: torch.sparse.sampled_addmm(Poff, Uf, Vt,
                                                       beta=0.0))


def probe_kernel_checks(rng, measure):
    """Phase 3, the probes: P1-P4 against their plain versions at the
    probes' shapes (f32 values, int32 ids) and K3 at the fused uvT
    probe's [R, n] shape, transposed once."""
    import numpy as np
    import torch

    from lorads_torch.ops import kernels
    from lorads_torch.probes import gather
    from lorads_torch.probes import onehot as oh
    from lorads_torch.probes.__main__ import gather_bytes

    dev = torch.device("cuda")
    eps32 = float(np.finfo(np.float32).eps)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    # ---- P1 onehot_scatter: gather7 / onehot_nn's sorted segment sum
    # (library: torch.segment_reduce on the same lengths)
    n, K, r = 20000, 80000, 24
    ids_np = np.sort(rng.integers(0, n, K)).astype(np.int32)
    plan = oh.plan_sorted_scatter(ids_np, n, CT=256, WT=2048, device=dev)
    lengths = torch.as_tensor(np.bincount(ids_np, minlength=n), device=dev)
    vals = f32(K, r)
    l1 = oh.sorted_scatter_plain(vals.abs(), plan, "f32")
    print(f"probe shapes: n={n} K={K} r={r} CT={plan.CT} WT={plan.WT} "
          f"n_pad={plan.n_pad} K_pad={plan.K_pad}")
    for mode, layout in (("bf16x3", "kr"), ("f32", "rk"), ("bf16x2", "kr")):
        v = vals if layout == "kr" else vals.T.contiguous()
        measure("onehot_scatter",
                f"{mode} {'[K,r]' if layout == 'kr' else '[r,K]'} CT=256",
                "bf16", lambda: oh.sorted_scatter(v, plan, mode, layout),
                lambda: oh.sorted_scatter_plain(v, plan, mode, layout),
                l1 if layout == "kr" else l1.T,
                nbytes=K * r * 4 + K * 4 + n * r * 4,
                flops=oh.scatter_mma_flops(plan, r, mode), tol=4 * eps32,
                library=lambda: torch.segment_reduce(vals, "sum",
                                                     lengths=lengths))
    # ---- P2 onehot_gather: bit for bit (each output is one row's planes)
    X = f32(n, r)
    ids = i32(ids_np)
    gplan = oh.plan_sorted_gather(ids_np, n, KT=256, device=dev)
    for mode in ("bf16x3", "bf16x2"):
        ref = oh.sorted_gather_plain(X, gplan, mode)
        measure("onehot_gather", f"{mode} KT=256 WT={gplan.WT}", "bf16",
                lambda: oh.sorted_gather(X, gplan, mode),
                lambda: oh.sorted_gather_plain(X, gplan, mode), ref.abs(),
                nbytes=gather_bytes(ids, r),
                flops=oh.gather_mma_flops(gplan, r, mode), exact=True,
                tol=0.0, library=lambda: X.index_select(0, ids))
    # ---- P3 row_gather: pallas_gather's rows, gT's transposed table, gE's
    # 1-D gather (exact)
    n3, K3, r3, R = 20000, 100000, 20, 24
    ids3 = i32(rng.integers(0, n3, K3))
    ids3l = ids3.long()
    for label, T, layout, width, lib in (
            (f"rows [{n3},{r3}]", f32(n3, r3), "kr", r3,
             lambda T: T.index_select(0, ids3)),
            (f"transposed [{R},{n3}]", f32(R, n3), "rk", R,
             lambda T: T.index_select(1, ids3)),
            (f"1-D [{n3}]", f32(n3), "kr", 1,
             lambda T: torch.take(T, ids3l))):
        ref = gather.row_gather_plain(T, ids3, layout)
        measure("row_gather", f"{label} K={K3}", "f32",
                lambda: gather.row_gather(T, ids3, layout, check=False),
                lambda: gather.row_gather_plain(T, ids3, layout), ref.abs(),
                nbytes=gather_bytes(ids3, width), flops=0, exact=True,
                tol=0.0, library=lambda: lib(T))
    # ---- P4 scatter_add: gather9 fC's unsorted segment sum (f32
    # atomics in no fixed order; library: index_add_)
    n4, K4, r4 = 20000, 160000, 24
    ids4 = i32(rng.integers(0, n4, K4))
    v4 = f32(K4, r4)
    measure("scatter_add", f"unsorted n={n4} K={K4} r={r4}", "f32",
            lambda: gather.scatter_add(v4, ids4, n4, check=False),
            lambda: gather.scatter_add_plain(v4, ids4, n4),
            gather.scatter_add_plain(v4.abs(), ids4, n4),
            nbytes=K4 * r4 * 4 + K4 * 4 + n4 * r4 * 4, flops=K4 * r4,
            tol=4 * eps32,
            library=lambda: torch.zeros((n4, r4), device=dev).index_add_(
                0, ids4, v4))
    # ---- K3 at the uvT probe's shape: X, D [R, n] transposed once to the
    # [1, n, R] factors K3 takes (library: the probe's unfused form, four
    # index_selects, a product and a sum over R)
    Xt = f32(R, n3)
    Dt = Xt * 0.5 + 1.0
    ic = ids3
    ir = i32(np.sort(rng.integers(0, n3, K3)))
    U, V = Xt.T.contiguous()[None], Dt.T.contiguous()[None]
    rows, cols = ir[None], ic[None]
    measure("uvt_split", f"f32 uvT probe R={R} n={n3} K={K3}", "f32",
            lambda: kernels.uvt_split(U, V, rows, cols)[1],
            lambda: kernels.uvt_split_plain(U, V, rows, cols)[1],
            kernels.uvt_split_plain(U.abs(), V.abs(), rows, cols)[1],
            nbytes=2 * n3 * R * 4 + 2 * K3 * 4 + (n3 + K3) * 4,
            flops=2 * n3 * R + 4 * K3 * R,
            library=lambda: 0.5 * (
                torch.sum(Xt.index_select(1, ir) * Dt.index_select(1, ic), 0)
                + torch.sum(Xt.index_select(1, ic) * Dt.index_select(1, ir),
                            0)))


def probes_path(card):
    """The probes' main path: the probe driver at --small, with the
    launch counts reset just before and read just after."""
    import torch

    from lorads_torch.ops import kernels
    from lorads_torch.probes.__main__ import main as probes_main

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    if probes_main(["--small"]) != 0:
        raise AssertionError("the probe driver failed")
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    print(f"main path probes: driver {time.time() - t0:.2f} s, kernel "
          f"launches {counts}  [{card}]")
    for k in PATH_KERNELS["probes"]:
        if counts[k] <= 0:
            raise AssertionError(f"the probes path never launched {k}")
    return counts


def solve_path(card, path, instances):
    """One main path: its solves through the public entry points, with
    the launch counts reset just before and read just after."""
    import numpy as np
    import torch

    from lorads_torch import LoradsParams, LoradsSolver, SolverStatus
    from lorads_torch import device as tdev
    from lorads_torch.core.problem import split_objectives_factors
    from lorads_torch.ops import kernels

    problems = [(name, make()) for name, make in instances]
    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()
    for name, problem in problems:
        before = dict(kernels.LAUNCHES)
        syncs0 = tdev.HOST_SYNCS
        t0 = time.time()
        solver = LoradsSolver(problem, LoradsParams(verbose=False,
                                                    **PARAMS.get(name, {})),
                              device="cuda")
        res = solver.solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: kernels.LAUNCHES[k] - before[k]
                    for k in kernels.LAUNCHES}
        ref = REFERENCE_POBJ[name]
        rel = abs(res.pobj - ref) / abs(ref)
        rep = getattr(solver, "spectral_repair_info", None)
        repair = ("not run" if rep is None else
                  f"{rep['rounds']} rounds, dinf {rep['dinf_before']:.3e} "
                  f"-> {rep['dinf_after']:.3e}, "
                  + ("accepted" if rep["accepted"] else "not accepted"))
        shapes = [f"{bk.B}x{bk.n}{'d' if bk.dense else 's'}"
                  for bk in solver.pd.buckets]
        print(f"solve {name}: status {res.status.value} pObj "
              f"{res.pobj!r} (lorads_tpu CPU f64 {ref!r}, rel "
              f"{rel:.2e}) pinf {res.pinf_l1:.3e} gap {res.gap:.3e} "
              f"dinf {res.dinf_l1:.3e} wall {wall:.3f} s (certificate "
              f"{res.dual_infeas_time:.3f} s) buckets {shapes} LP columns "
              f"{problem.n_lp_cols} ALM outer "
              f"{res.alm_stats.outer_iter} inner {res.alm_stats.inner_iter}"
              f" ADMM {res.admm_stats.iter} CG {solver.admm_cg_total} "
              f"divergence retries {solver.admm_retries} "
              f"rank {res.ranks} cert restarts {solver.last_cert_restarts} "
              f"spectral repair: {repair}; host syncs "
              f"{tdev.HOST_SYNCS - syncs0} launches {launches}  [{card}]")
        if res.status is not SolverStatus.PRIMAL_DUAL_OPTIMAL:
            raise AssertionError(f"{name}: status {res.status.value}")
        if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
            raise AssertionError(f"{name}: pObj {res.pobj} vs {ref}")
        fs, lp_vals = solver.factor_blocks()
        for blk, F in zip(problem.blocks, fs):
            if F.shape[0] != blk.dim or not np.all(np.isfinite(F)):
                raise AssertionError(f"{name}: bad factor {F.shape}")
        if lp_vals is not None and not (
                lp_vals.shape == (problem.n_lp_cols,)
                and np.all(np.isfinite(lp_vals)) and np.all(lp_vals >= 0)):
            raise AssertionError(f"{name}: bad LP values")
        if name in REFERENCE_SPLIT:
            objs = split_objectives_factors(problem.parts, fs, lp_vals)
            rels = [abs(a - b) / abs(b)
                    for a, b in zip(objs, REFERENCE_SPLIT[name])]
            print(f"solve {name}: per-instance objectives {objs} (rel to "
                  f"lorads_tpu's single-instance solves "
                  f"{['%.2e' % r for r in rels]})")
            if max(rels) > POBJ_RTOL:
                raise AssertionError(f"{name}: per-instance objectives")
        if name in ("maxcut300", "matcomp500") and res.admm_stats.iter == 0:
            raise AssertionError(f"{name} did not reach ADMM")
        if path in ("matcomp", "theta", "lp") and solver.admm_cg_total <= 0:
            raise AssertionError(f"{name}: ADMM ran no CG iteration")
    counts = dict(kernels.LAUNCHES)
    print(f"main path {path}: kernel launches {counts}, host syncs "
          f"{tdev.HOST_SYNCS}")
    for k in PATH_KERNELS[path]:
        if counts[k] <= 0:
            raise AssertionError(f"the {path} path never launched {k}")
    return counts


def cgnr_path(card):
    """The CGNR dual refinement's path: theta_gtoy60 with the spectral
    dual repair replaced, in this process only, by a reject, so that the
    solve goes on to the CGNR refinement (K4's dense A(.) and build_w in
    every CGNR iteration) and, as in lorads_tpu's CPU run of the same
    forced path, rejects its step and takes the level-2 reopt.  Held to
    that run's status and objective (REFERENCE_CGNR); the launch counts
    reset just before and read just after."""
    import torch

    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch import device as tdev
    from lorads_torch.alg import solver as solver_mod
    from lorads_torch.ops import kernels

    name = "theta_gtoy60"
    problem = INSTANCES[name]()
    status_ref, pobj_ref = REFERENCE_CGNR[name]
    repair, refine = solver_mod.try_spectral_repair, solver_mod.dual_ls_refine
    k4 = []

    def counted_refine(*a, **k):
        before = kernels.LAUNCHES["gather_segsum"]
        out = refine(*a, **k)
        k4.append(kernels.LAUNCHES["gather_segsum"] - before)
        return out

    lines = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()
    t0 = time.time()
    solver_mod.try_spectral_repair = lambda solver, stats: False
    solver_mod.dual_ls_refine = counted_refine
    try:
        solver = LoradsSolver(problem, LoradsParams(verbose=False),
                              device="cuda")
        solver.log = lambda *a, **k: lines.append(" ".join(map(str, a)))
        res = solver.solve()
        torch.cuda.synchronize()
    finally:
        solver_mod.try_spectral_repair = repair
        solver_mod.dual_ls_refine = refine
    wall = time.time() - t0
    counts = dict(kernels.LAUNCHES)
    rel = abs(res.pobj - pobj_ref) / abs(pobj_ref)
    info = solver.dual_refine_info
    refine_lines = [ln for ln in lines if ln.startswith("dual refine:")]
    print(f"solve {name} (spectral repair forced to reject): status "
          f"{res.status.value} pObj {res.pobj!r} (lorads_tpu CPU f64 on "
          f"the same forced path: {status_ref}, {pobj_ref!r}; rel "
          f"{rel:.2e}) pinf {res.pinf_l1:.3e} gap {res.gap:.3e} dinf "
          f"{res.dinf_l1:.3e} wall {wall:.3f} s host syncs "
          f"{tdev.HOST_SYNCS}  [{card}]")
    print(f"  {refine_lines}")
    print(f"  CGNR: {info['iters']} iterations (cap {info['n_iter']}), "
          f"{info['seconds']:.3f} s, {info['host_syncs']} host reads "
          f"(certificates included), {k4} K4 launches; main path cgnr: "
          f"kernel launches {counts}")
    if len(refine_lines) != 1:
        raise AssertionError(f"{name}: no 'dual refine:' line in the log")
    if res.status.value != status_ref:
        raise AssertionError(f"{name}: status {res.status.value}, "
                             f"lorads_tpu {status_ref}")
    if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
        raise AssertionError(f"{name}: pObj {res.pobj} vs {pobj_ref}")
    if not (k4 and k4[0] > 0 and info["iters"] > 0):
        raise AssertionError("the CGNR refinement launched no K4")
    for k in PATH_KERNELS["cgnr"]:
        if counts[k] <= 0:
            raise AssertionError(f"the cgnr path never launched {k}")
    return counts


def main_path(card):
    """Phase 4: the Max-Cut, matrix-completion, theta, multi-block / LP
    and batch paths, the CGNR refinement's path, then the probes' path
    (the probe driver).  Returns the launch counts summed over the
    paths."""
    from lorads_torch.ops import kernels

    paths = {"maxcut": ("maxcut300", "maxcut20000", "gset_torus10000"),
             "matcomp": ("matcomp500", "matcomp2000"),
             "theta": ("theta_gtoy60", "theta300", "theta800"),
             "lp": ("hand_multiblock", "hand_multiblock_gs", "multiblock22",
                    "multiblock_lp"),
             "batch": ("maxcut20000x4",)}
    total = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for path, names in paths.items():
        counts = solve_path(card, path,
                            [(name, INSTANCES[name]) for name in names])
        for k in total:
            total[k] += counts[k]
    for path in (cgnr_path, probes_path):
        counts = path(card)
        for k in total:
            total[k] += counts[k]
    return total


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-of", metavar="DIR",
                    help="only phases 1-3 (build, kernel checks and "
                    "times), on the lorads_torch of the checkout at DIR: "
                    "two checkouts' kernels timed alike on one card")
    args = ap.parse_args(argv)
    if args.kernels_of:
        sys.path.insert(0, os.path.abspath(args.kernels_of))
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

    card = timing().card_line()
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
    if args.kernels_of:
        print(f"card: {card}")
        print(json.dumps({"kernels_of": os.path.abspath(args.kernels_of),
                          "cases": results}))
        return 0
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
                             "lorads_tpu/ops/pattern.py:1476"),
           "adj_a_dense": ("lorads_torch/csrc/adj_a_dense.cu",
                           "lorads_tpu/ops/pattern.py:1458"),
           "lp_gs_sweep": ("lorads_torch/csrc/lp_gs.cu",
                           "lorads_tpu/alg/admm.py:238"),
           "onehot_scatter": ("lorads_torch/csrc/onehot_mma.cu",
                              "tools/probes/onehot.py:190"),
           "onehot_gather": ("lorads_torch/csrc/onehot_mma.cu",
                             "tools/probes/onehot.py:238"),
           "row_gather": ("lorads_torch/csrc/row_gather.cu",
                          "tools/probes/microbench_pallas_gather.py:61"),
           "scatter_add": ("lorads_torch/csrc/scatter_add.cu",
                           "tools/probes/microbench_gather9.py:146")}
    summary = []
    for name, (path, replaces) in src.items():
        first = results[name][0]
        summary.append({"name": name, "route": "cuda", "source": path,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": first["max_abs_err"],
                        "ms": first["ms"], "plain_ms": first["plain_ms"],
                        "bound_ms": first["bound_ms"],
                        "bound_by": first["bound_by"],
                        "library_ms": first["library_ms"]})
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
