"""The probe driver: asks the questions of ``tools/probes/`` of the card.

    python -m lorads_torch.probes [--device cuda|cpu] [--small]
                                  [--only SECTION]

Each section asks one probe's cost-model question with the probes' own
shapes (``--small``: the same cases at a tenth of the size or less) and
data drawn from ``numpy.random.default_rng(0)`` as the probes draw it:

- ``width`` (microbench_gather5 §1, microbench_gather): P3 ``row_gather``
  against ``index_select`` for r in {8, 20, 40, 64, 128} -- is a gather's
  cost per row or per byte?
- ``height`` (microbench_pallas_gather2): P3 over table heights n in
  {8, ..., 20000} at K=16384, then past the 50 MB L2 at K=2^20 -- is
  there a cliff when the table leaves L2?
- ``forms`` (microbench_pallas_gather gA-gE, microbench_gather9 fA/fB,
  microbench_pallas_gather3 gT): P3 in the row, transposed and 1-D
  layouts, against ``index_select`` and ``torch.take``;
- ``onehot`` (onehot, microbench_gather5/6/7, onehot_nn, onehot_r,
  onehot_bisect): P1 over the (CT, WT) grid, the three modes, both
  layouts and the r sweep, beside K1 (``kernels.segment_sum`` on the CSR
  bounds of the same ids), ``torch.segment_reduce`` and ``index_add_``;
  P2 over KT and the modes against P3 and ``index_select``;
- ``scatter`` (microbench_gather9 fC): P4 on unsorted ids against
  ``index_add_``, and on the same values with sorted ids P4, P1 and K1;
- ``uvt`` (microbench_pallas_gather3/4 uvT): K3 ``uvt_split`` on the
  probe's [R, n] inputs, transposed once, against four ``index_select``s,
  a product and a sum.

Every case is checked against its plain version (gathers exactly, sums
within 4 eps32 x sum |values|) and, on the card, timed with CUDA events
(3 warm-up calls, then 20 back-to-back calls; no host clock): ``ms`` per
call with the host's dispatch, and ``device_ms`` per call of the same 20
calls captured in one CUDA graph, or, for a call that reads the device
from the host and cannot be captured (``torch.segment_reduce``), their
kernels' own device time from ``torch.profiler`` (``device_by``: "graph"
or "profiler").  Beside them stand its bound --
the larger of its bytes over 3.35 TB/s (a gather's table counted by the
rows the ids touch) and its operations over the peak of the unit it
uses (NVIDIA H100 SXM data sheet: bf16 tensor cores 989 TFLOP/s, f32
67 TFLOP/s) -- and its library call, timed the same two ways.  Each
line carries the card's name and power limit.  On the CPU (``--device
cpu``) the wrappers take their plain versions and no time is measured.
The last line is ``{"probes": [...]}``: one object per case with its
section, case, shapes, ms, device_ms, device_by, bound_ms, bound_by,
library, library_ms, library_device_ms, library_device_by and
max_abs_err.  The verdict line of each section (``=>``) reads the device
times.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from lorads_torch.timing import card_line, cuda_time_ms, device_time_ms

SECTIONS = ("width", "height", "forms", "onehot", "scatter", "uvt")
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bf16": 989e12, "f32": 67e12}
EPS32 = float(np.finfo(np.float32).eps)


def gather_bytes(ids, r) -> int:
    """The bytes a gather of r-wide rows must move: the distinct table rows
    these ids touch (each read once), the ids, and the output."""
    K = ids.numel()
    return (torch.unique(ids).numel() * r + K * r) * 4 + K * 4


class Probe:
    """Runs and records the cases of one driver run."""

    def __init__(self, device: torch.device, small: bool):
        self.dev = device
        self.small = small
        self.timed = device.type == "cuda"
        self.card = card_line() if self.timed else "cpu: times not measured"
        self.rows = []

    def t(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.dev)

    def case(self, section, case, shapes, fn, plain, nbytes, flops=0,
             unit="f32", library=None, lib_name=None, l1=None):
        """``l1`` None: fn must equal plain exactly; else |fn - plain| <=
        4 eps32 * l1 elementwise."""
        got, ref = fn(), plain()
        if self.timed:
            torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{section} [{case}]: bad output "
                                 f"{tuple(got.shape)}")
        diff = (got.double() - ref.double()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if l1 is None:
            if not torch.equal(got, ref):
                raise AssertionError(f"{section} [{case}]: not exact "
                                     f"(max err {err:.3e})")
        elif not bool((diff <= 4 * EPS32 * l1.double() + 1e-30).all()):
            raise AssertionError(f"{section} [{case}]: max err {err:.3e} "
                                 "beyond 4 eps32 x sum |values|")
        ms = cuda_time_ms(fn) if self.timed else None
        lib_ms = cuda_time_ms(library) if self.timed and library else None
        dev_ms, dev_by = device_time_ms(fn) if self.timed else (None, None)
        lib_dev_ms, lib_dev_by = (device_time_ms(library)
                                  if self.timed and library else (None, None))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOP_PER_S[unit] * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        row = dict(section=section, case=case, shapes=shapes, ms=ms,
                   device_ms=dev_ms, device_by=dev_by, bound_ms=bound,
                   bound_by=by, library=lib_name, library_ms=lib_ms,
                   library_device_ms=lib_dev_ms,
                   library_device_by=lib_dev_by, max_abs_err=err)
        self.rows.append(row)

        def fmt(v, d, how):
            if v is None:
                return "not measured"
            return (f"{v:.4f} ms ({'-' if d is None else f'{d:.4f}'} on "
                    f"device{', profiler' if how == 'profiler' else ''})")
        print(f"{section} [{case}] {shapes}: kernel "
              f"{fmt(ms, dev_ms, dev_by)} library {lib_name or 'none'} "
              f"{fmt(lib_ms, lib_dev_ms, lib_dev_by) if lib_name else ''} "
              f"bound {bound:.6f} ms ({by}: {nbytes} B, {flops} flop "
              f"{unit}) max_abs_err {err:.3e}  [{self.card}]", flush=True)
        return row

    def verdict(self, text):
        """A section's answer, in device ms per call (CUDA graph)."""
        print(f"  => {text}  [{self.card}]" if self.timed else
              "  => (not measured on the CPU)", flush=True)


def _d(v):
    return "n/a" if v is None else f"{v:.4f}"


def _ratio(a, b):
    if a["device_ms"] is None or not b["device_ms"]:
        return "n/a"
    return f"{a['device_ms'] / b['device_ms']:.2f}"


# ---------------------------------------------------------------------------
# Sections.
# ---------------------------------------------------------------------------

def width(p: Probe):
    from lorads_torch.probes import gather
    n, K = (2000, 10000) if p.small else (20000, 100000)
    rng = np.random.default_rng(0)
    ids = p.t(rng.integers(0, n, K).astype(np.int32))
    rows = {}
    for r in (8, 20, 40, 64, 128):
        X = p.t(rng.standard_normal((n, r)).astype(np.float32))
        rows[r] = p.case(
            "width", f"P3 row_gather r={r}", f"n={n} K={K}",
            lambda: gather.row_gather(X, ids, check=False),
            lambda: gather.row_gather_plain(X, ids),
            nbytes=gather_bytes(ids, r),
            library=lambda: X.index_select(0, ids), lib_name="index_select")
    if p.timed:
        p.verdict(f"r=128 costs {_ratio(rows[128], rows[8])}x r=8 for 16x "
                  "the row bytes; ns per row: " + ", ".join(
                      f"r={r} "
                      f"{_d(v['device_ms'] and v['device_ms'] * 1e6 / K)}"
                      for r, v in rows.items()))


def height(p: Probe):
    from lorads_torch.probes import gather
    rng = np.random.default_rng(0)
    probe_ns = (8, 128, 1024, 2048) if p.small else \
        (8, 128, 1024, 2048, 8192, 20000)
    K, r = (2048, 20) if p.small else (16384, 20)
    rows = []
    for n, rr in [(n, r) for n in probe_ns] + [(2048, 128)]:
        X = p.t(rng.standard_normal((n, rr)).astype(np.float32))
        ids = p.t(rng.integers(0, n, K).astype(np.int32))
        rows.append(p.case(
            "height", f"P3 n={n} r={rr}", f"K={K}",
            lambda: gather.row_gather(X, ids, check=False),
            lambda: gather.row_gather_plain(X, ids),
            nbytes=gather_bytes(ids, rr),
            library=lambda: X.index_select(0, ids), lib_name="index_select"))
    # past L2 (50 MB): a table of up to 640 MB, 2^20 gathered rows
    big_ns = (2000, 20000) if p.small else (20000, 200000, 2000000, 8000000)
    K = 8192 if p.small else 1 << 20
    gen = torch.Generator(device=p.dev).manual_seed(0)
    cliff = []
    for n in big_ns:
        X = torch.randn((n, r), generator=gen, device=p.dev)
        ids = torch.randint(0, n, (K,), generator=gen, device=p.dev,
                            dtype=torch.int32)
        cliff.append(p.case(
            "height", f"P3 n={n} r={r} table {n * r * 4 / 1e6:.1f} MB",
            f"K={K}", lambda: gather.row_gather(X, ids, check=False),
            lambda: gather.row_gather_plain(X, ids),
            nbytes=gather_bytes(ids, r),
            library=lambda: X.index_select(0, ids), lib_name="index_select"))
        del X
    if p.timed:
        p.verdict("ms at K=16384 by height: " + ", ".join(
            f"{v['case'].split()[1]} {_d(v['device_ms'])}" for v in rows)
            + f"; at K=2^20: " + ", ".join(
            f"{v['case'].split()[1]} {_d(v['device_ms'])}" for v in cliff))


def forms(p: Probe):
    from lorads_torch.probes import gather
    rng = np.random.default_rng(0)
    n, K, r, R = (2000, 10000, 20, 24) if p.small else (20000, 100000, 20,
                                                        24)
    X = p.t(rng.standard_normal((n, r)).astype(np.float32))
    ids = p.t(rng.integers(0, n, K).astype(np.int32))
    row = p.case("forms", "P3 row layout (gA-gD)", f"[{n},{r}] K={K}",
                 lambda: gather.row_gather(X, ids, check=False),
                 lambda: gather.row_gather_plain(X, ids),
                 nbytes=gather_bytes(ids, r),
                 library=lambda: X.index_select(0, ids),
                 lib_name="index_select")
    Xt = p.t(rng.standard_normal((R, n)).astype(np.float32))
    tr = p.case("forms", "P3 transposed layout (gT)", f"[{R},{n}] K={K}",
                lambda: gather.row_gather(Xt, ids, "rk", check=False),
                lambda: gather.row_gather_plain(Xt, ids, "rk"),
                nbytes=gather_bytes(ids, R),
                library=lambda: Xt.index_select(1, ids),
                lib_name="index_select dim 1")
    XtT = Xt.T.contiguous()
    p.case("forms", "P3 row layout of the transposed table", f"[{n},{R}] "
           f"K={K}", lambda: gather.row_gather(XtT, ids, check=False),
           lambda: gather.row_gather_plain(XtT, ids),
           nbytes=gather_bytes(ids, R))
    one = []
    # scalar gathers: a [K] vector by n ids (gE), an [n'] vector by K' ids
    # (pallas_gather2 gE), and the [n, 1] row form (gather5 §2)
    for tn, tk, what in ((K, n, "gE [K] by n ids"),
                         (5 * n, n, "gE2 [5n] by n ids")):
        vec = p.t(rng.standard_normal(tn).astype(np.float32))
        pos = p.t(rng.integers(0, tn, tk).astype(np.int32))
        posl = pos.long()
        one.append(p.case(
            "forms", f"P3 1-D {what}", f"n={tn} K={tk}",
            lambda: gather.row_gather(vec, pos, check=False),
            lambda: gather.row_gather_plain(vec, pos),
            nbytes=gather_bytes(pos, 1),
            library=lambda: torch.take(vec, posl), lib_name="torch.take"))
        col = vec[:, None].contiguous()
        p.case("forms", f"P3 [n,1] rows, {what}", f"n={tn} K={tk}",
               lambda: gather.row_gather(col, pos, check=False),
               lambda: gather.row_gather_plain(col, pos),
               nbytes=gather_bytes(pos, 1),
               library=lambda: col.index_select(0, pos),
               lib_name="index_select")
    # gather9 fA/fB: n=20000, K=160000, r=24
    n9, K9, r9 = (2000, 16000, 24) if p.small else (20000, 160000, 24)
    X9 = p.t(rng.standard_normal((n9, r9)).astype(np.float32))
    i9 = p.t(rng.integers(0, n9, K9).astype(np.int32))
    p.case("forms", "P3 row layout (gather9 fA/fB)", f"[{n9},{r9}] K={K9}",
           lambda: gather.row_gather(X9, i9, check=False),
           lambda: gather.row_gather_plain(X9, i9),
           nbytes=gather_bytes(i9, r9),
           library=lambda: X9.index_select(0, i9), lib_name="index_select")
    if p.timed:
        p.verdict(f"row {_d(row['device_ms'])} ms (index_select "
                  f"{_d(row['library_device_ms'])}), transposed "
                  f"{_d(tr['device_ms'])} ms (index_select "
                  f"{_d(tr['library_device_ms'])}); 1-D " + ", ".join(
                      f"{_d(v['device_ms'])} (take "
                      f"{_d(v['library_device_ms'])})" for v in one))


def _seg_yardsticks(p, section, label, vals, ids_np, n):
    """K1, segment_reduce and index_add_ on the same sorted values."""
    from lorads_torch.ops import kernels
    from lorads_torch.probes import gather
    K, r = vals.shape
    counts = np.bincount(ids_np, minlength=n)
    bnd = p.t(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    lengths = p.t(counts.astype(np.int64))
    ids = p.t(ids_np.astype(np.int32))
    l1 = gather.add_rows_f64(vals.abs(), ids, n)
    plain = lambda: gather.scatter_add_plain(vals, ids, n)
    v3, b2 = vals[None], bnd[None]
    nbytes = K * r * 4 + (n + 1) * 4 + n * r * 4
    k1 = p.case(section, f"K1 segment_sum {label}", f"n={n} K={K} r={r}",
                lambda: kernels.segment_sum(v3, b2)[0], plain, nbytes,
                flops=K * r, library=lambda: torch.segment_reduce(
                    vals, "sum", lengths=lengths, unsafe=True),
                lib_name="segment_reduce", l1=l1)
    ia = p.case(section, f"index_add_ {label}", f"n={n} K={K} r={r}",
                lambda: torch.zeros((n, r), device=p.dev).index_add_(
                    0, ids, vals), plain, nbytes - (n + 1) * 4 + K * 4,
                flops=K * r, l1=l1)
    return k1, ia, l1


def onehot(p: Probe):
    from lorads_torch.probes import gather
    from lorads_torch.probes import onehot as oh
    rng = np.random.default_rng(0)
    n, K, r = (2000, 8000, 24) if p.small else (20000, 80000, 24)
    ids_np = np.sort(rng.integers(0, n, K)).astype(np.int32)
    vals = p.t(rng.standard_normal((K, r)).astype(np.float32))
    X = p.t(rng.standard_normal((n, r)).astype(np.float32))
    k1, ia, l1 = _seg_yardsticks(p, "onehot", "(yardstick)", vals, ids_np, n)
    shapes = f"n={n} K={K} r={r}"

    def scatter(plan, mode, layout, v, ll1, rr, label):
        vin = v if layout == "kr" else v.T.contiguous()
        return p.case(
            "onehot", label, f"n={n} K={K} r={rr}",
            lambda: oh.sorted_scatter(vin, plan, mode, layout),
            lambda: oh.sorted_scatter_plain(vin, plan, mode, layout),
            nbytes=K * rr * 4 + K * 4 + n * rr * 4,
            flops=oh.scatter_mma_flops(plan, rr, mode), unit="bf16",
            library=lambda: torch.segment_reduce(v, "sum", lengths=lengths,
                                                 unsafe=True),
            lib_name="segment_reduce [K,r]",
            l1=ll1 if layout == "kr" else ll1.T)

    lengths = p.t(np.bincount(ids_np, minlength=n).astype(np.int64))

    # --small: the modes and layouts at CT=256 only, fewer r and KT
    grid = ((128, 1024), (256, 2048)) if p.small else \
        ((128, 1024), (256, 2048), (512, 4096), (1024, 8192))
    modes = ("f32", "bf16x3", "bf16x2")
    best = None
    for CT, WT in grid:
        plan = oh.plan_sorted_scatter(ids_np, n, CT=CT, WT=WT, device=p.dev)
        if not plan.ok:
            print(f"onehot [P1 CT={CT} WT={WT}]: plan refused", flush=True)
            continue
        for mode in (modes if CT == 256 or not p.small else ("bf16x3",)):
            row = scatter(plan, mode, "kr", vals, l1, r,
                          f"P1 CT={CT} WT={WT} {mode} [K,r]")
            if mode == "bf16x3" and (best is None or (row["device_ms"] or 0)
                                     < (best["device_ms"] or 0)):
                best = row
            if CT == 256:
                scatter(plan, mode, "rk", vals, l1, r,
                        f"P1 CT={CT} WT={WT} {mode} [r,K]")
    for rr in (16, 128) if p.small else (16, 20, 32, 128):  # onehot_r
        v = p.t(rng.standard_normal((K, rr)).astype(np.float32))
        plan = oh.plan_sorted_scatter(ids_np, n, CT=256, WT=2048,
                                      device=p.dev)
        ll1 = gather.add_rows_f64(v.abs(), p.t(ids_np), n)
        scatter(plan, "bf16x3", "kr", v, ll1, rr,
                f"P1 CT=256 WT=2048 bf16x3 r={rr}")
    # P2: the sorted gather against P3 and index_select
    ids = p.t(ids_np)
    p3 = p.case("onehot", "P3 row_gather (sorted ids)", shapes,
                lambda: gather.row_gather(X, ids, check=False),
                lambda: gather.row_gather_plain(X, ids),
                nbytes=gather_bytes(ids, r),
                library=lambda: X.index_select(0, ids),
                lib_name="index_select")
    for KT in ((256,) if p.small else (128, 256, 512, 1024)):
        plan = oh.plan_sorted_gather(ids_np, n, KT=KT, device=p.dev)
        if not plan.ok:
            print(f"onehot [P2 KT={KT}]: plan refused", flush=True)
            continue
        for mode in modes:
            p.case("onehot", f"P2 KT={KT} WT={plan.WT} {mode}", shapes,
                   lambda: oh.sorted_gather(X, plan, mode),
                   lambda: oh.sorted_gather_plain(X, plan, mode),
                   nbytes=gather_bytes(ids, r),
                   flops=oh.gather_mma_flops(plan, r, mode), unit="bf16",
                   library=lambda: X.index_select(0, ids),
                   lib_name="index_select")
    if not p.small:                                  # gather7's second shape
        n7, K7 = 50000, 250000
        i7 = np.sort(rng.integers(0, n7, K7)).astype(np.int32)
        v7 = p.t(rng.standard_normal((K7, r)).astype(np.float32))
        plan = oh.plan_sorted_scatter(i7, n7, CT=256, device=p.dev)
        lengths = p.t(np.bincount(i7, minlength=n7).astype(np.int64))
        ll1 = gather.add_rows_f64(v7.abs(), p.t(i7), n7)
        p.case("onehot", f"P1 CT=256 WT={plan.WT} bf16x3 (gather7)",
               f"n={n7} K={K7} r={r}",
               lambda: oh.sorted_scatter(v7, plan, "bf16x3"),
               lambda: oh.sorted_scatter_plain(v7, plan, "bf16x3"),
               nbytes=K7 * r * 4 + K7 * 4 + n7 * r * 4,
               flops=oh.scatter_mma_flops(plan, r, "bf16x3"), unit="bf16",
               library=lambda: torch.segment_reduce(v7, "sum", unsafe=True,
                                                    lengths=lengths),
               lib_name="segment_reduce", l1=ll1)
    if p.timed and best is not None:
        p.verdict(f"best P1 bf16x3 {_d(best['device_ms'])} ms "
                  f"({best['case']}) against K1 {_d(k1['device_ms'])}, "
                  f"segment_reduce {_d(k1['library_device_ms'])}, "
                  f"index_add_ {_d(ia['device_ms'])}; P3 on the sorted ids "
                  f"{_d(p3['device_ms'])}")


def scatter(p: Probe):
    from lorads_torch.probes import gather
    from lorads_torch.probes import onehot as oh
    rng = np.random.default_rng(0)
    n, K, r = (2000, 16000, 24) if p.small else (20000, 160000, 24)
    ids_np = rng.integers(0, n, K).astype(np.int32)
    vals = p.t(rng.standard_normal((K, r)).astype(np.float32))
    shapes = f"n={n} K={K} r={r}"
    nbytes = K * r * 4 + K * 4 + n * r * 4
    ids = p.t(ids_np)
    l1 = gather.add_rows_f64(vals.abs(), ids, n)
    un = p.case("scatter", "P4 unsorted ids", shapes,
                lambda: gather.scatter_add(vals, ids, n, check=False),
                lambda: gather.scatter_add_plain(vals, ids, n), nbytes,
                flops=K * r, library=lambda: torch.zeros(
                    (n, r), device=p.dev).index_add_(0, ids, vals),
                lib_name="index_add_", l1=l1)
    order = np.argsort(ids_np, kind="stable")
    s_np = ids_np[order]
    sv = vals[p.t(order)].contiguous()
    si = p.t(s_np)
    so = p.case("scatter", "P4 sorted ids", shapes,
                lambda: gather.scatter_add(sv, si, n, check=False),
                lambda: gather.scatter_add_plain(sv, si, n), nbytes,
                flops=K * r, library=lambda: torch.zeros(
                    (n, r), device=p.dev).index_add_(0, si, sv),
                lib_name="index_add_", l1=l1)
    plan = oh.plan_sorted_scatter(s_np, n, CT=256, device=p.dev)
    p1 = p.case("scatter", f"P1 CT=256 WT={plan.WT} bf16x3 sorted ids",
                shapes, lambda: oh.sorted_scatter(sv, plan, "bf16x3"),
                lambda: oh.sorted_scatter_plain(sv, plan, "bf16x3"), nbytes,
                flops=oh.scatter_mma_flops(plan, r, "bf16x3"), unit="bf16",
                l1=l1)
    k1, _, _ = _seg_yardsticks(p, "scatter", "sorted ids", sv, s_np, n)
    if p.timed:
        p.verdict(f"unsorted P4 {_d(un['device_ms'])} ms (index_add_ "
                  f"{_d(un['library_device_ms'])}); sorted P4 "
                  f"{_d(so['device_ms'])}, P1 {_d(p1['device_ms'])}, K1 "
                  f"{_d(k1['device_ms'])}, segment_reduce "
                  f"{_d(k1['library_device_ms'])}")


def uvt(p: Probe):
    from lorads_torch.ops import kernels
    rng = np.random.default_rng(0)
    n, K, R = (2000, 10000, 24) if p.small else (20000, 100000, 24)
    Xt = p.t(rng.standard_normal((R, n)).astype(np.float32))
    idx = rng.integers(0, n, K).astype(np.int32)
    idx_r = np.sort(rng.integers(0, n, K)).astype(np.int32)
    Dt = Xt * 0.5 + 1.0
    U, V = Xt.T.contiguous()[None], Dt.T.contiguous()[None]  # once
    rows, cols = p.t(idx_r)[None], p.t(idx)[None]
    ir, ic = rows[0], cols[0]

    def unfused():
        return 0.5 * (torch.sum(Xt.index_select(1, ir) * Dt.index_select(
            1, ic), 0) + torch.sum(Xt.index_select(1, ic)
                                   * Dt.index_select(1, ir), 0))

    l1 = kernels.uvt_split_plain(U.abs(), V.abs(), rows, cols)[1][0]
    row = p.case("uvt", "K3 uvt_split on X^T, D^T", f"R={R} n={n} K={K}",
                 lambda: kernels.uvt_split(U, V, rows, cols)[1][0],
                 lambda: kernels.uvt_split_plain(U, V, rows, cols)[1][0],
                 nbytes=2 * n * R * 4 + 2 * K * 4 + (n + K) * 4,
                 flops=2 * n * R + 4 * K * R, library=unfused,
                 lib_name="4 index_select + product + sum", l1=l1)
    if p.timed:
        p.verdict(f"fused K3 {_d(row['device_ms'])} ms against the unfused "
                  f"gathers {_d(row['library_device_ms'])} ms")


RUN = {"width": width, "height": height, "forms": forms, "onehot": onehot,
       "scatter": scatter, "uvt": uvt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lorads_torch.probes",
        description="gather/scatter cost-model probes on the card")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the same cases at small shapes")
    ap.add_argument("--only", choices=SECTIONS, action="append",
                    help="run only this section (repeatable)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("lorads_torch.probes: no CUDA device (pass --device cpu to "
              "check the probes' paths on the CPU)", file=sys.stderr)
        return 2
    p = Probe(torch.device(args.device), args.small)
    print(f"card: {p.card}", flush=True)
    for name in args.only or SECTIONS:
        print(f"--- {name}", flush=True)
        RUN[name](p)
    print(f"card: {p.card}")
    print(json.dumps({"probes": p.rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
