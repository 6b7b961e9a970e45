"""Unsorted row gather (P3 ``row_gather``) and unsorted scatter-add (P4
``scatter_add``) on the card's CUDA cores.

Ports of the gather probes of ``tools/probes/``:

- ``row_gather`` replaces the in-kernel dynamic gathers
  (``microbench_pallas_gather.py`` gA-gD, ``microbench_pallas_gather2.py``
  g, ``microbench_gather.py`` pallas_gather, ``microbench_gather9.py``
  fA/fB: X[n, r][ids] -> [K, r]), their transposed layout
  (``microbench_pallas_gather3/4.py`` gT: [r, n] -> [r, K]) and the
  scalar gathers (gE, gE2: a 1-D table);
- ``scatter_add`` replaces ``microbench_gather9.py`` fC, the serial
  read-modify-write loop that sums [K, r] values into [n, r] rows at
  unsorted ids.

The transposed layout runs one of two schedules (``cols_schedule``): a
block stages one or two whole table rows in shared memory and gathers
from there, or, where a row does not fit or the ids are too few to pay
for it, a thread an id reads the table from L2.  A table of width 1 (1-D,
[n, 1] or [1, n]) goes through the transposed layout's kernels as a
[1, n] row: the direct kernel, 4 ids a thread, unless ``rb`` forces the
table staged as one row a block.

``scatter_add`` zeroes its output in a kernel that lets the add kernel
start beside it (programmatic dependent launch): the adds load their
first ids and values while the zeroing runs and wait for it before
their first reduction.  A thread sums a column group of 4, 2 or 1
floats over 4 consecutive rows while the id repeats and issues one
vector reduction per run; the kernel picks the width from r and the
values' alignment, and its grid from its occupancy.

Ids are int32 and values float32, as in the probes.  Ids out of
[0, n) raise in the wrapper (one host read of their range; pass
``check=False`` for ids already checked), never in the kernel.  The
plain versions are ``index_select`` and ``index_add_`` (f64
accumulation, rounded once); CPU tensors take them, CUDA tensors launch
the kernels or raise.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from lorads_torch.ops.kernels import _check, _launch, _sm_count


def _check_ids(name, ids, n):
    if ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0 or hi >= n:
            raise IndexError(f"{name}: ids in [{lo}, {hi}], table of {n}")


# ---------------------------------------------------------------------------
# P3: unsorted row gather.
# ---------------------------------------------------------------------------

class ColsSchedule(NamedTuple):
    """The transposed gather's schedule: ``rb`` table rows a block stages
    in shared memory (0: the L2 schedule, a thread an id), ``slice`` ids
    a block takes (a multiple of 4; 0 for the L2 schedule)."""
    rb: int
    slice: int


# the staged kernel: 512 threads a staged row, each holding up to 24 ids
# (csrc/row_gather.cu ROW_THREADS, IDS); rows a block stages unless the
# caller asks for another count
STAGED_THREADS, STAGED_IDS, STAGED_RB = 512, 24, 2


def cols_schedule(n: int, R: int, K: int, smem_bytes: int, sms: int = 132,
                  rb=None) -> ColsSchedule:
    """The schedule of out[c, k] = X[c, ids[k]] for X [R, n] and K ids on
    a card of ``sms`` SMs whose blocks may use ``smem_bytes`` of shared
    memory.  ``rb`` None: STAGED_RB rows a block where they fit, one where
    only one does, and the L2 schedule where none fits or where the ids
    number fewer than an eighth of a row (a staged row then costs more
    bytes than the 32-byte sectors the L2 gather reads); 0, 1 or 2: that
    schedule (ValueError where its rows do not fit).  The slices cut K so
    that the grid fills the SMs in one wave (two blocks an SM at one row:
    a second wave of a few blocks would double the time), each
    slice at least an eighth of a row and at most what a block's threads
    hold."""
    row = -(-n // 4) * 4 * 4                   # a staged row's bytes
    fit = smem_bytes // row
    if rb is None:
        rb = 0 if fit == 0 or 8 * K < n else min(STAGED_RB, fit, R)
    if rb not in (0, 1, 2):
        raise ValueError(f"cols_schedule: rb={rb} (need 0, 1 or 2)")
    if rb > fit:
        raise ValueError(f"cols_schedule: {rb} rows of {n} floats exceed "
                         f"{smem_bytes} bytes of shared memory")
    if rb == 0 or K <= 0:
        return ColsSchedule(rb, 0)
    per_sm = max(1, min(2 // rb, fit // rb))   # blocks an SM
    groups = -(-R // rb)
    slices = max(1, sms * per_sm // groups)
    slices = min(slices, max(1, 8 * K // n))
    slices = max(slices, -(-K // (rb * STAGED_THREADS * STAGED_IDS)))
    per = -(-K // slices)
    return ColsSchedule(rb, -(-per // 4) * 4)


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    from lorads_torch.ops import build
    with torch.cuda.device(index):
        got = build.load().lt_smem_optin()
    if got <= 0:
        raise RuntimeError("row_gather: cannot read the device's shared "
                           "memory per block")
    return got


def row_gather_plain(X, ids, layout="kr"):
    if X.dim() == 1 or layout == "kr":
        return X.index_select(0, ids.long())
    return X.index_select(1, ids.long())


def row_gather(X: torch.Tensor, ids: torch.Tensor, layout="kr",
               check=True, rb=None) -> torch.Tensor:
    """P3.  X f32 [n, r] ("kr") -> X[ids] [K, r]; X [r, n] ("rk") ->
    X[:, ids] [r, K]; a 1-D X [n] -> X[ids] [K] (layout ignored).  ``rb``
    (the transposed layout and every form of width 1): the rows a block
    stages, 0 for the L2 schedule (at width 1 the direct kernel), None to
    let ``cols_schedule`` choose (at width 1 the direct kernel)."""
    if layout not in ("kr", "rk"):
        raise ValueError(f"row_gather: layout {layout!r}")
    if rb not in (None, 0, 1, 2):
        raise ValueError(f"row_gather: rb={rb!r} (need None, 0, 1 or 2)")
    if X.dtype != torch.float32 or X.dim() not in (1, 2) or ids.dim() != 1:
        raise TypeError("row_gather: X float32 [n], [n, r] or [r, n]; "
                        "ids 1-D")
    rk = X.dim() == 2 and layout == "rk"
    n = X.shape[1] if rk else X.shape[0]
    r = 1 if X.dim() == 1 else (X.shape[0] if rk else X.shape[1])
    cuda = _check("row_gather", [X], [ids])
    if check:
        _check_ids("row_gather", ids, n)
    if not cuda:
        return row_gather_plain(X, ids, layout)
    K = ids.shape[0]
    shape = (K,) if X.dim() == 1 else ((r, K) if rk else (K, r))
    out = torch.empty(shape, dtype=torch.float32, device=X.device)
    # width 1 (a [n] table, [n, 1] or [1, n]): the same storage as a
    # [1, n] table, gathered by the transposed layout's kernels
    flat = r == 1
    sched = ColsSchedule(0, 0)
    if rk or flat:
        index = X.device.index if X.device.index is not None \
            else torch.cuda.current_device()
        if flat and rb is None:
            rb = 0
        sched = cols_schedule(n, r, K, _smem_optin(index),
                              _sm_count(X.device), rb)
    _launch("row_gather", "lt_row_gather", int(rk or flat), X.data_ptr(),
            ids.data_ptr(), out.data_ptr(), n, K, r, sched.rb, sched.slice)
    return out


# ---------------------------------------------------------------------------
# P4: unsorted scatter-add.
# ---------------------------------------------------------------------------

def add_rows_f64(vals, ids, n):
    """out[ids[k]] += vals[k] in f64 -> [n, ...]: one index_add_ over the
    flattened rows (on the CPU far faster than a row-wise index_add_,
    and the same sum in the same order)."""
    trail = tuple(vals.shape[1:])
    w = math.prod(trail)
    flat = (ids.long()[:, None] * w
            + torch.arange(w, device=vals.device)).reshape(-1)
    out = torch.zeros(n * w, dtype=torch.float64, device=vals.device)
    return out.index_add_(0, flat, vals.reshape(-1).double()).view(
        (n,) + trail)


def scatter_add_plain(vals, ids, n):
    return add_rows_f64(vals, ids, n).float()


def scatter_add(vals: torch.Tensor, ids: torch.Tensor, n: int,
                check=True) -> torch.Tensor:
    """P4.  out[ids[k]] += vals[k] over unsorted ids: vals f32 [K, r] or
    [K] -> [n, r] or [n].  The kernel zeroes its output, sums runs of
    equal ids in registers and adds them with f32 vector reductions in no
    fixed order, so two runs may differ in the last bits."""
    if vals.dtype != torch.float32 or vals.dim() not in (1, 2) \
            or ids.shape != vals.shape[:1]:
        raise TypeError("scatter_add: vals float32 [K] or [K, r], ids [K]")
    cuda = _check("scatter_add", [vals], [ids])
    if check:
        _check_ids("scatter_add", ids, n)
    if not cuda:
        return scatter_add_plain(vals, ids, n)
    r = 1 if vals.dim() == 1 else vals.shape[1]
    # zeroed by the kernel's launch
    out = torch.empty((n,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=vals.device)
    _launch("scatter_add", "lt_scatter_add", vals.data_ptr(), ids.data_ptr(),
            out.data_ptr(), vals.shape[0], n, r)
    return out
