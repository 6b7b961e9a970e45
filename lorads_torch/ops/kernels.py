"""The port's hand-written CUDA kernels, their wrappers and plain versions.

| wrapper        | CUDA source            | replaces (lorads_tpu/ops/pattern.py)      |
|----------------|------------------------|-------------------------------------------|
| segment_sum    | csrc/segment_sum.cu    | comp_segment_sum, single_segment_sum (K1) |
| cmul_csr       | csrc/cmul.cu           | cmul (K2)                                 |
| uvt_split      | csrc/uvt.cu            | uvt, split branch (K3)                    |
| uvt_pair_split | csrc/uvt_pair.cu       | uvt_pair, uvt_pair_cached (K3p)           |
| gather_segsum  | csrc/gather_segsum.cu  | constr_vals and build_w, split (K4)       |
| wmul_csr       | csrc/wmul.cu           | w_mul, w_mul_cached, split (K5)           |
| adj_a_offdiag  | csrc/adj_a.cu          | a_adj_a (K6)                              |
| adj_a_dense    | csrc/adj_a_dense.cu    | a_adj_a_dense (K7a)                       |
| lp_gs_sweep    | csrc/lp_gs.cu          | alg/admm.py: _update_lp_var_gs (K8c)      |
| sym_eig_small  | csrc/sym_eig.cu        | alg/lanczos.py:117, spectral_repair.py:124: jnp.linalg.eigh (K9) |

and the probes' kernels, whose wrappers live in ``lorads_torch/probes``
(no solver module calls them; ``python -m lorads_torch.probes`` does):

| wrapper                 | CUDA source          | replaces (tools/probes/)              |
|-------------------------|----------------------|---------------------------------------|
| onehot.sorted_scatter   | csrc/onehot_mma.cu   | onehot.py: sorted_scatter and the one-hot window scatters (P1) |
| onehot.sorted_gather    | csrc/onehot_mma.cu   | onehot.py: sorted_gather (P2)         |
| gather.row_gather       | csrc/row_gather.cu   | the Pallas row / transposed / scalar gathers (P3); the transposed layout (gT) stages table rows in shared memory (``gather.cols_schedule``); the 1-D gather (gE) takes 4 ids a thread (``rb`` forces its table staged) |
| gather.scatter_add      | csrc/scatter_add.cu  | microbench_gather9.py: fC (P4); a zeroing kernel the adds start beside, float4 reductions of runs of equal ids over 4 rows a thread |

K4 and K2 at r = 1 share one segment-sum schedule (csrc/segsum.cuh);
K5 at r = 1 takes it too, its values read through the slots.  K3, K3p,
K6 and K5 at r > 1 run over tile schedules of the static pattern
(``Tiles``, built once per bucket by ``tile_schedule``), staging factor
rows in shared memory a tile at a time (csrc/tiles.cuh); K3, K3p and K6
share one schedule of the off slots and one set of kernels
(csrc/sddmm.cuh).
csrc/graph_cond.cu opens the conditional nodes of devloop's device-decided
loops (``alg/devloop.py``): its one-thread kernel, counted as
``loop_cond``, sets a WHILE or IF node's condition from a device boolean
(lorads_tpu's ``lax.while_loop`` cond and ``lax.cond`` predicate).
csrc/floor.cu holds three measuring instruments that chip_smoke.py calls
(an empty kernel, a chain of dependent shared-memory loads, one launch
of the set-condition kernel); they have no wrapper here and no count in
``LAUNCHES``.

Each wrapper checks its arguments, then takes the plain PyTorch version
(written with ``index_select`` / ``index_add_``) for CPU tensors, and
for CUDA tensors launches the kernel on the current stream or raises;
there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches per wrapper (plain-version calls are not counted), and
``F32_LAUNCHES`` those of them on float32 data; a launch
recorded into a CUDA graph (``alg/devloop.py``, inside ``recording``)
counts once at each replay of the graph (``replayed``), not at its
capture.  ``GRAPHS`` counts devloop's captures and replays and the
launches those replays made.

Plain-version precision: f64 sums directly.  At f32 the segment sums
(K1, K2, K4, K5) accumulate in f64 and round once, which bounds their
error by the compensated kernels' eps32 contract; the row dots of K3,
K3p and K6 (r terms each) sum in f32, as lorads_tpu's do.  K7a rounds
its product and its diagonal sum separately, as its plain version
does, so the two agree bit for bit.  K9's plain version is
torch.linalg.eigh (a host-checked LAPACK or cuSOLVER call): the two
agree to rounding in the eigenvalues and span the same eigenspaces, a
vector's sign or a cluster's basis aside.  K8c's plain version sums each
column's terms in the kernel's lane order (32 partial sums, then the
shuffle tree), so the two agree bit for bit too; where a column's ids
repeat, the kernel applies their deltas in order of k, as index_add_
does on CPU tensors.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional

import torch

KERNEL_NAMES = ("segment_sum", "cmul_csr", "uvt_split", "uvt_pair_split",
                "gather_segsum", "wmul_csr", "adj_a_offdiag",
                "adj_a_dense", "lp_gs_sweep", "sym_eig_small",
                "onehot_scatter", "onehot_gather", "row_gather",
                "scatter_add", "loop_cond")
LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)
# of LAUNCHES["uvt_split"], those with V is U (one dot an entry)
ONE_DOT_LAUNCHES = {"uvt_split": 0}
# of LAUNCHES["lp_gs_sweep"], those with the DUAL_U_V term s
WITH_S_LAUNCHES = {"lp_gs_sweep": 0}
# of LAUNCHES, those on float32 data
F32_LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)
# devloop's graphs captured and replayed, and the launches of the replays
GRAPHS = {"captured": 0, "replayed": 0, "launches": 0}
_TABLES = {"launches": LAUNCHES, "one_dot": ONE_DOT_LAUNCHES,
           "with_s": WITH_S_LAUNCHES, "f32": F32_LAUNCHES}
# the launches of the graph being captured, (table, name) -> count
_TALLY = None


def reset_launches() -> None:
    for table in (*_TABLES.values(), GRAPHS):
        for k in table:
            table[k] = 0


def _bump(table: str, name: str, n: int = 1) -> None:
    if _TALLY is not None:
        _TALLY[(table, name)] = _TALLY.get((table, name), 0) + n
    else:
        _TABLES[table][name] += n


@contextlib.contextmanager
def recording():
    """Launches inside are recorded into the graph being captured: they
    are tallied in the dict yielded, which ``replayed`` adds to the
    counts at each replay."""
    global _TALLY
    prev, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def replayed(tally: dict, times: int = 1, replay: bool = True) -> None:
    """Count one replay of a graph whose launches are ``tally``; with
    ``times`` and ``replay=False``, a conditional node's body (its
    launches ``tally``) that ran ``times`` times in a replay."""
    for (table, name), n in tally.items():
        _TABLES[table][name] += n * times
        if table == "launches":
            GRAPHS["launches"] += n * times
    if replay:
        GRAPHS["replayed"] += 1


def cond_begin(is_while: bool, pred: torch.Tensor, child) -> int:
    """Open a WHILE (or IF) node on the stream being captured, its
    condition set from the 0-d bool ``pred``, and start capturing its body
    on the stream ``child`` (csrc/graph_cond.cu) -> the node's handle."""
    import ctypes

    from lorads_torch.ops import build
    handle = ctypes.c_ulonglong(0)
    rc = build.load().lt_cond_begin(
        int(is_while), pred.data_ptr(), child.cuda_stream,
        ctypes.byref(handle), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"loop_cond: opening a conditional node failed "
                           f"(cudaError {rc})")
    _bump("launches", "loop_cond")
    return handle.value


def cond_end(is_while: bool, handle: int, pred, counter, child) -> None:
    """End the body captured on ``child``: a WHILE node's body sets its
    condition from ``pred`` (runs again while it holds; None: stops);
    either adds one to ``counter`` (an int64 element, or None) each time
    the body runs."""
    from lorads_torch.ops import build
    rc = build.load().lt_cond_end(
        int(is_while), handle, None if pred is None else pred.data_ptr(),
        None if counter is None else counter.data_ptr(), child.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"loop_cond: closing a conditional node failed "
                           f"(cudaError {rc})")
    _bump("launches", "loop_cond")


def _check(name, floats, ints):
    floats = [t for t in floats if t is not None]
    dev = floats[0].device
    dt = floats[0].dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dt} (need float32 or float64)")
    for t in floats:
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed float dtypes {dt}, {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index dtype {t.dtype} (need int32)")
    for t in floats + ints:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: device {dev}")
    return dev.type == "cuda"


def _launch(name, fn, *args):
    from lorads_torch.ops import build
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    _bump("launches", name)


def _is_f64(t):
    return int(t.dtype == torch.float64)


def _typed_launch(name, fn, t, *args):
    """_launch of a kernel whose first argument is its type flag, from
    ``t``'s dtype; a launch on float32 data also counts in F32_LAUNCHES."""
    _launch(name, fn, _is_f64(t), *args)
    if t.dtype == torch.float32:
        _bump("f32", name)


def _take_rows(X, idx):
    """X [B, n, ...] at rows idx [B, K] -> [B, K, ...]."""
    return torch.stack([X[b].index_select(0, idx[b].long())
                        for b in range(X.shape[0])])


def _ptr(t):
    return t.data_ptr() if t is not None else None


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# Tile schedules of a static pattern (K5, K6).
# ---------------------------------------------------------------------------

# K6: square tiles of ADJ_TILE rows and columns; a tile whose entries
# number at least ADJ_MIN_FILL is staged, a unit of at most ADJ_EMAX
# entries a CTA; the other entries of a row strip are read from L2 in
# units of ADJ_EMAX_L2 (a warp an entry).  K5: row strips of WMUL_STRIP
# rows (one CTA each, or up to WMUL_MAX_PARTS until there are
# WMUL_WAVES CTAs for every SM; their partial sums in f64, added in
# order by a second kernel) over column tiles of WMUL_COLS rows of X,
# staged from WMUL_MIN_FILL entries on.  The sizes read fastest in a
# sweep at matcomp2000's shapes on an H100 (PERF.md).  The rank is not
# known when a bucket is built, so the kernels choose between staging
# and L2 from r at launch; a pattern with no staged tile runs the
# parent kernels (a warp a row or an entry, rows from L2).
ADJ_TILE, ADJ_MIN_FILL, ADJ_EMAX, ADJ_EMAX_L2 = 64, 16, 2048, 32
WMUL_STRIP, WMUL_COLS, WMUL_MIN_FILL = 32, 256, 64
WMUL_WAVES, WMUL_MAX_PARTS = 8, 8
# ij packs (row - unit row0) << IJ_SHIFT | col
IJ_SHIFT = 25


class Tiles(NamedTuple):
    """A tile schedule of a static pattern, per block b.  Its entries
    are ordered by unit; unit u holds the entries ``bnd[b, u]`` ..
    ``bnd[b, u+1] - 1``, all in the rows ``row0[b, u]`` .. ``row0[b, u]
    + rows - 1`` and, when ``col0[b, u] >= 0``, in the columns
    ``col0[b, u]`` .. ``+ cols - 1`` (staged in shared memory; -1: a
    unit of sparse tiles, its columns read from L2).  Units follow
    their row strip, entries keep their input order within a unit (row
    by row where the input comes row by row, as K5's does), and padding
    units (past a block's last) are empty with row0 = n.  K5's schedule
    also says where each strip's units and each unit's rows start
    (strip s of rows s * rows .. owns the units ``strip[b, s]`` ..
    ``strip[b, s+1] - 1``; ``rowptr[b, u, i]``: the unit's entries of a
    local row below i); K6's reads neither (None)."""
    slot: torch.Tensor     # int32 [B, N] the entry's slot
    ij: torch.Tensor       # int32 [B, N] (row - row0) << IJ_SHIFT | col
    bnd: torch.Tensor      # int32 [B, U+1]
    row0: torch.Tensor     # int32 [B, U]
    col0: torch.Tensor     # int32 [B, U]
    strip: Optional[torch.Tensor]   # int32 [B, ceil(n / rows) + 1]
    rowptr: Optional[torch.Tensor]  # int32 [B, U * (rows + 1)]
    rows: int
    cols: int
    staged: int            # staged units, all blocks (0: none; K5 and K6
                           # then walk the pattern from L2 unscheduled)
    sparse: int            # units of sparse tiles, all blocks


def tile_schedule(rows, cols, slot, n: int, tile_rows: int,
                  tile_cols: int, min_fill: int, emax=None,
                  emax_l2=None, strips: bool = True) -> Tiles:
    """The Tiles of the entries (rows, cols, slot) [B, N] of a static
    pattern on n rows; entries with a negative row are left out (they
    lie past each block's last unit).  Per block: the entries of every
    (row strip, column tile) of at least ``min_fill`` entries form a
    staged unit, the rest of each strip one unit read from L2; staged
    units are split at ``emax`` entries, L2 units at ``emax_l2`` (None:
    not split); ``strips``: with ``strip`` and ``rowptr``.  One stable
    sort of a composite key over all blocks; any device."""
    if tile_rows > 1 << (31 - IJ_SHIFT) or n > 1 << IJ_SHIFT:
        raise ValueError(f"tile_schedule: tile_rows={tile_rows}, n={n}")
    dev = rows.device
    B, N = rows.shape
    rows, cols = rows.long(), cols.long()
    live = rows >= 0
    nrt, nct = -(-n // tile_rows), -(-n // tile_cols)
    bi = torch.arange(B, device=dev)[:, None]
    rt = torch.where(live, rows // tile_rows, nrt)
    ct = cols // tile_cols
    _, inv, cnt = torch.unique((bi * (nrt + 1) + rt) * nct + ct,
                               return_inverse=True, return_counts=True)
    ctx = torch.where(cnt[inv] >= min_fill, ct, nct)
    key = ((bi * (nrt + 1) + rt) * (nct + 1) + ctx).reshape(-1)
    key, perm = torch.sort(key, stable=True)
    pos = torch.arange(B * N, device=dev)
    run = torch.ones_like(key, dtype=torch.bool)
    run[1:] = key[1:] != key[:-1]
    start = run.clone()
    cap = torch.where(key % (nct + 1) < nct, emax or B * N + 1,
                      emax_l2 or B * N + 1)
    first = torch.cummax(torch.where(run, pos, 0), 0).values
    start |= (pos - first) % cap == 0
    r_s = rows.reshape(-1)[perm]
    ok = r_s >= 0
    start &= ok
    per = start.reshape(B, N).sum(1)
    U = max(int(per.max()) if B else 0, 1)
    su = start.nonzero().squeeze(1)
    b_u = su // N
    u_loc = torch.arange(su.numel(), device=dev) - (
        torch.cumsum(per, 0) - per)[b_u]
    bnd = torch.empty((B, U + 1), dtype=torch.long, device=dev)
    bnd[:] = live.sum(1, keepdim=True)
    bnd[b_u, u_loc] = su - b_u * N
    row0 = torch.full((B, U), n, dtype=torch.long, device=dev)
    col0 = torch.full((B, U), -1, dtype=torch.long, device=dev)
    strip0 = (r_s // tile_rows) * tile_rows
    row0[b_u, u_loc] = strip0[su]
    c_u = (key[su] % (nct + 1))
    col0[b_u, u_loc] = torch.where(c_u < nct, c_u * tile_cols, -1)
    lr = (r_s - strip0).clamp(min=0)
    ij = (lr << IJ_SHIFT) | cols.reshape(-1)[perm]
    i32 = lambda t: t.reshape(B, -1).to(torch.int32).contiguous()  # noqa
    strip = rowptr = None
    if strips:
        g = torch.cumsum(start.long(), 0) - 1
        G = su.numel()
        cnt = torch.bincount((g * tile_rows + lr)[ok],
                             minlength=G * tile_rows)
        rowptr = torch.zeros((B, U, tile_rows + 1), dtype=torch.long,
                             device=dev)
        rowptr[b_u, u_loc, 1:] = torch.cumsum(cnt.reshape(G, tile_rows), 1)
        rowptr = i32(rowptr)
        strip = i32(torch.searchsorted(
            row0, (torch.arange(nrt + 1, device=dev) * tile_rows).clamp(
                max=n).expand(B, nrt + 1).contiguous()))
    return checked_tiles(Tiles(
        i32(slot.reshape(-1)[perm]), i32(ij), i32(bnd), i32(row0),
        i32(col0), strip, rowptr, tile_rows, tile_cols,
        *unit_counts(row0, col0, n).sum(0).tolist()))


def unit_counts(row0, col0, n: int):
    """Per block, (staged units, units of sparse tiles) of a schedule's
    unit rows and columns [B, U] -> [B, 2]."""
    live = row0 < n
    return torch.stack([(live & (col0 >= 0)).sum(1),
                        (live & (col0 < 0)).sum(1)], 1)


def adj_tiles(rows, cols, n: int) -> Tiles:
    """K6's schedule of the off slots (rows, cols) [B, Ko]: square tiles,
    the slot of each entry its own position."""
    slot = torch.arange(rows.shape[1], device=rows.device)
    return tile_schedule(rows, cols, slot.expand(rows.shape), n, ADJ_TILE,
                         ADJ_TILE, ADJ_MIN_FILL, ADJ_EMAX, ADJ_EMAX_L2,
                         strips=False)


def checked_tiles(t: Tiles) -> Tiles:
    """t, once its arrays are found int32, contiguous and on one device;
    made so by tile_schedule and bucket_tiles, the wrappers then check
    only that it is a schedule of their entries (_pairs)."""
    arrays = [a for a in t[:7] if a is not None]
    for a in arrays:
        if (a.dtype != torch.int32 or not a.is_contiguous()
                or a.device != arrays[0].device):
            raise ValueError("Tiles: arrays must be contiguous int32 on "
                             "one device")
    return t


def _pairs(name, t: Tiles, entries):
    """t schedules these entries [B, N] (same shape, same device)."""
    if t.slot.shape != entries.shape or t.slot.device != entries.device:
        raise ValueError(f"{name}: tiles of another pattern")


def _off_tiles(name, tiles, rows, cols, n: int) -> Tiles:
    """The off slots' schedule a K3, K3p or K6 call runs on: ``tiles``,
    or adj_tiles built here (a host sync)."""
    t = tiles if tiles is not None else adj_tiles(rows, cols, n)
    _pairs(name, t, rows)
    return t


def _tile_args(t: Tiles, outs, B: int, n: int, Ko: int, r: int):
    """The C arguments of K3, K3p and K6 from the schedule's arrays on:
    those five, the outputs, the sizes, the units a block (0: no staged
    tile, the warp path on rows, cols), the tile's rows and columns, and
    whether units of sparse tiles exist."""
    return (*(a.data_ptr() for a in t[:5]), *map(_ptr, outs), B, n, Ko, r,
            t.row0.shape[1] if t.staged else 0, t.rows, t.cols,
            int(t.sparse > 0))


def csr_rows(bnd, N: int):
    """The row of each of N entries under CSR bounds bnd [B, n+1]; -1
    outside [bnd[b, 0], bnd[b, n])."""
    B, n1 = bnd.shape
    k = torch.arange(N, device=bnd.device).expand(B, N).contiguous()
    row = torch.searchsorted(bnd.long().contiguous(), k, right=True) - 1
    return torch.where((row >= 0) & (row < n1 - 1), row, -1)


def wmul_tiles(slots, cols, bnd) -> Tiles:
    """K5's schedule of the full-symmetric entry list (slots, cols
    [B, Ks], CSR bounds bnd [B, n+1]): row strips over column tiles,
    each entry carrying its off slot."""
    n = bnd.shape[1] - 1
    return tile_schedule(csr_rows(bnd, cols.shape[1]), cols, slots, n,
                         WMUL_STRIP, WMUL_COLS, WMUL_MIN_FILL)


# ---------------------------------------------------------------------------
# K1: sorted segment sum over CSR bounds.
# ---------------------------------------------------------------------------

def segment_sum_plain(data: torch.Tensor,
                      bounds: torch.Tensor) -> torch.Tensor:
    """out[b, j] = sum(data[b, bounds[b, j]:bounds[b, j+1]]) along axis 1
    of [B, N] or [B, N, r] data."""
    B, N = data.shape[:2]
    S = bounds.shape[1] - 1
    trail = data.shape[2:]
    pos = torch.arange(N, device=data.device).expand(B, N).contiguous()
    seg = torch.searchsorted(bounds.long().contiguous(), pos,
                             right=True) - 1
    keep = ((seg >= 0) & (seg < S)).reshape(-1)
    src = keep.nonzero().squeeze(1)
    ids = (seg + S * torch.arange(B, device=data.device)[:, None])
    ids = ids.reshape(-1).index_select(0, src)
    vals = data.reshape((B * N,) + trail).index_select(0, src)
    out = torch.zeros((B * S,) + trail, dtype=torch.float64,
                      device=data.device)
    out.index_add_(0, ids, vals.to(torch.float64))
    return out.reshape((B, S) + trail).to(data.dtype)


def segment_sum(data: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """K1.  ``data`` [B, N] or [B, N, r]; ``bounds`` int32 [B, S+1],
    nondecreasing within [0, N] -> [B, S] or [B, S, r]."""
    if data.dim() not in (2, 3) or bounds.dim() != 2 \
            or bounds.shape[0] != data.shape[0]:
        raise ValueError(f"segment_sum: shapes {tuple(data.shape)}, "
                         f"{tuple(bounds.shape)}")
    if not _check("segment_sum", [data], [bounds]):
        return segment_sum_plain(data, bounds)
    B, N = data.shape[:2]
    r = data.shape[2] if data.dim() == 3 else 1
    S = bounds.shape[1] - 1
    out = torch.empty((B, S) + data.shape[2:], dtype=data.dtype,
                      device=data.device)
    _typed_launch("segment_sum", "lt_segment_sum", data,
                  data.data_ptr(), bounds.data_ptr(), out.data_ptr(), B, N,
                  S, r)
    return out


# ---------------------------------------------------------------------------
# K2: C @ X over the full-symmetric row-sorted entry list.
# ---------------------------------------------------------------------------

def cmul_csr_plain(X, c_diag, cols, vals, bnd):
    Xg = _take_rows(X, cols)                                   # [B, Ks, r]
    off = segment_sum_plain(vals[:, :, None] * Xg, bnd)
    return off if c_diag is None else c_diag[:, :, None] * X + off


def cmul_csr(X: torch.Tensor, c_diag, cols: torch.Tensor,
             vals: torch.Tensor, bnd: torch.Tensor) -> torch.Tensor:
    """K2.  X [B, n, r]; c_diag [B, n] or None (no diagonal term);
    cols int32 [B, Ks] and vals [B, Ks] sorted by row; bnd int32
    [B, n+1] row pointers -> C @ X [B, n, r]."""
    B, n, r = X.shape
    Ks = cols.shape[1]
    if (vals.shape != cols.shape or cols.shape[0] != B
            or bnd.shape != (B, n + 1)
            or (c_diag is not None and c_diag.shape != (B, n))):
        raise ValueError("cmul_csr: inconsistent shapes")
    floats = [X, vals] + ([c_diag] if c_diag is not None else [])
    if not _check("cmul_csr", floats, [cols, bnd]):
        return cmul_csr_plain(X, c_diag, cols, vals, bnd)
    out = torch.empty_like(X)
    _typed_launch("cmul_csr", "lt_cmul", X, X.data_ptr(),
                  c_diag.data_ptr() if c_diag is not None else None,
                  cols.data_ptr(), vals.data_ptr(), bnd.data_ptr(),
                  out.data_ptr(), B, n, Ks, r)
    return out


# ---------------------------------------------------------------------------
# K3: sym(U V^T) on the split pattern (diagonal + strictly-lower entries).
# ---------------------------------------------------------------------------

def uvt_split_plain(U, V, rows, cols):
    d = torch.sum(U * V, -1)
    ur, vc = _take_rows(U, rows), _take_rows(V, cols)
    uc, vr = _take_rows(U, cols), _take_rows(V, rows)
    o = 0.5 * (torch.sum(ur * vc, -1) + torch.sum(uc * vr, -1))
    return d, o


def uvt_split(U: torch.Tensor, V: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor, tiles: Tiles = None):
    """K3.  U, V [B, n, r]; rows, cols int32 [B, Ko] ->
    (d [B, n] = rowsum(U*V), o [B, Ko] = sym(UV^T) at (rows, cols)).
    ``tiles``: the off slots' schedule (adj_tiles); built here when
    None.  When V is U (the same storage and shape) the off values take
    one dot an entry, <U_i, U_j>: bit for bit the two-dot value."""
    B, n, r = U.shape
    Ko = rows.shape[1]
    if V.shape != U.shape or cols.shape != rows.shape \
            or rows.shape[0] != B:
        raise ValueError("uvt_split: inconsistent shapes")
    if not _check("uvt_split", [U, V], [rows, cols]):
        return uvt_split_plain(U, V, rows, cols)
    t = _off_tiles("uvt_split", tiles, rows, cols, n)
    one_dot = U.data_ptr() == V.data_ptr()
    d = torch.empty((B, n), dtype=U.dtype, device=U.device)
    o = torch.empty((B, Ko), dtype=U.dtype, device=U.device)
    _typed_launch("uvt_split", "lt_uvt_split", U, int(one_dot),
                  U.data_ptr(), V.data_ptr(), rows.data_ptr(),
                  cols.data_ptr(), *_tile_args(t, (d, o), B, n, Ko, r))
    _bump("one_dot", "uvt_split", int(one_dot))
    return d, o


# ---------------------------------------------------------------------------
# K3p: (sym(R D^T), sym(D D^T)) on the split pattern in one pass.
# ---------------------------------------------------------------------------

def uvt_pair_split_plain(R, D, rows, cols):
    rd_d = torch.sum(R * D, -1)
    dd_d = torch.sum(D * D, -1)
    Rr, Rc = _take_rows(R, rows), _take_rows(R, cols)
    Dr, Dc = _take_rows(D, rows), _take_rows(D, cols)
    rd_o = 0.5 * (torch.sum(Rr * Dc, -1) + torch.sum(Rc * Dr, -1))
    dd_o = torch.sum(Dr * Dc, -1)
    return rd_d, rd_o, dd_d, dd_o


def uvt_pair_split(R: torch.Tensor, D: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, tiles: Tiles = None):
    """K3p.  R, D [B, n, r]; rows, cols int32 [B, Ko] ->
    (rd_d, rd_o, dd_d, dd_o): rowsum(R*D) and rowsum(D*D) [B, n],
    sym(RD^T) and DD^T at (rows, cols) [B, Ko].  ``tiles``: the off
    slots' schedule (adj_tiles); built here when None."""
    B, n, r = R.shape
    Ko = rows.shape[1]
    if D.shape != R.shape or cols.shape != rows.shape \
            or rows.shape[0] != B:
        raise ValueError("uvt_pair_split: inconsistent shapes")
    if not _check("uvt_pair_split", [R, D], [rows, cols]):
        return uvt_pair_split_plain(R, D, rows, cols)
    t = _off_tiles("uvt_pair_split", tiles, rows, cols, n)
    rd_d, dd_d = (torch.empty((B, n), dtype=R.dtype, device=R.device)
                  for _ in range(2))
    rd_o, dd_o = (torch.empty((B, Ko), dtype=R.dtype, device=R.device)
                  for _ in range(2))
    _typed_launch("uvt_pair_split", "lt_uvt_pair", R, R.data_ptr(),
                  D.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                  *_tile_args(t, (rd_d, rd_o, dd_d, dd_o), B, n, Ko, r))
    return rd_d, rd_o, dd_d, dd_o


# ---------------------------------------------------------------------------
# K4: gather x at the entries, scale, segment-sum over CSR bounds.
# ---------------------------------------------------------------------------

def gather_segsum_plain(x, idx, val, bnd, base=None, alpha=1.0):
    g = _take_rows(x, idx)                                     # [B, N]
    out = alpha * segment_sum_plain(val * g, bnd)
    return out if base is None else base + out


def gather_segsum(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                  bnd: torch.Tensor, base=None,
                  alpha: float = 1.0) -> torch.Tensor:
    """K4.  x [B, Nx]; idx int32 [B, N] into x; val [B, N]; bnd int32
    [B, S+1] segment pointers into the entries; base [B, S] or None ->
    out[b, s] = base[b, s] + alpha * sum_seg val * x[idx].  A one-entry
    segment is exact."""
    if x.dim() != 2 or idx.dim() != 2 or bnd.dim() != 2:
        raise ValueError("gather_segsum: x, idx and bnd must be 2-D")
    B, Nx = x.shape
    N = idx.shape[1]
    S = bnd.shape[1] - 1
    if (val.shape != idx.shape or idx.shape[0] != B or bnd.shape[0] != B
            or (base is not None and base.shape != (B, S))):
        raise ValueError("gather_segsum: inconsistent shapes")
    if not _check("gather_segsum", [x, val, base], [idx, bnd]):
        return gather_segsum_plain(x, idx, val, bnd, base, alpha)
    out = torch.empty((B, S), dtype=x.dtype, device=x.device)
    _typed_launch("gather_segsum", "lt_gather_segsum", x, x.data_ptr(),
                  idx.data_ptr(), val.data_ptr(), bnd.data_ptr(), _ptr(base),
                  out.data_ptr(), B, Nx, N, S, float(alpha))
    return out


# ---------------------------------------------------------------------------
# K5: W @ X over the full-symmetric row-sorted entry list, W's off values
# read through each entry's slot.
# ---------------------------------------------------------------------------

def wmul_csr_plain(X, W_d, W_o, slots, cols, bnd):
    vals = torch.stack([
        torch.where(slots[b] >= 0,
                    W_o[b].index_select(0, slots[b].clamp(min=0).long()),
                    torch.zeros((), dtype=W_o.dtype, device=W_o.device))
        for b in range(X.shape[0])])
    return cmul_csr_plain(X, W_d, cols, vals, bnd)


def wmul_csr(X: torch.Tensor, W_d: torch.Tensor, W_o: torch.Tensor,
             slots: torch.Tensor, cols: torch.Tensor,
             bnd: torch.Tensor, tiles: Tiles = None) -> torch.Tensor:
    """K5.  X [B, n, r]; W_d [B, n]; W_o [B, Ko]; slots (-1: padding)
    and cols int32 [B, Ks] sorted by row; bnd int32 [B, n+1] row
    pointers -> W @ X [B, n, r].  ``tiles``: the entries' schedule
    (wmul_tiles), which r > 1 runs on; built here when None (a host
    sync).  r = 1 runs K4's schedule, a pattern with no staged tile a
    warp a row, neither with the schedule."""
    B, n, r = X.shape
    Ko, Ks = W_o.shape[1], cols.shape[1]
    if (slots.shape != cols.shape or cols.shape[0] != B
            or W_d.shape != (B, n) or W_o.shape[0] != B
            or bnd.shape != (B, n + 1)):
        raise ValueError("wmul_csr: inconsistent shapes")
    if not _check("wmul_csr", [X, W_d, W_o], [slots, cols, bnd]):
        return wmul_csr_plain(X, W_d, W_o, slots, cols, bnd)
    out = torch.empty_like(X)
    t = None
    if r > 1:
        t = tiles if tiles is not None else wmul_tiles(slots, cols, bnd)
        _pairs("wmul_csr", t, cols)
    if t is None or not t.staged:
        _typed_launch("wmul_csr", "lt_wmul", X, X.data_ptr(),
                      W_d.data_ptr(), W_o.data_ptr(), slots.data_ptr(),
                      cols.data_ptr(), bnd.data_ptr(), out.data_ptr(), B, n,
                      Ko, Ks, r)
        return out
    ti = (t.slot, t.ij, t.bnd, t.col0, t.strip, t.rowptr)
    # parts a strip, so that the CTAs fill the card WMUL_WAVES deep
    P = max(1, min(WMUL_MAX_PARTS, -(-WMUL_WAVES * _sm_count(X.device)
                                     // (B * -(-n // t.rows)))))
    part = (torch.empty((P, B, n, r), dtype=torch.float64, device=X.device)
            if P > 1 else None)
    _typed_launch("wmul_csr", "lt_wmul_tiled", X, X.data_ptr(),
                  W_d.data_ptr(), W_o.data_ptr(), *(a.data_ptr() for a in ti),
                  out.data_ptr(), _ptr(part), B, n, Ko, Ks, r,
                  t.row0.shape[1], t.rows, t.cols, P)
    return out


# ---------------------------------------------------------------------------
# K6: a2 .* sym(X F^T) on the off pattern (+ the diagonal rowsum(X*F)).
# ---------------------------------------------------------------------------

def adj_a_offdiag_plain(X, F, rows, cols, a2, want_diag):
    d, o = uvt_split_plain(X, F, rows, cols)
    return (d if want_diag else None), a2 * o


def adj_a_offdiag(X: torch.Tensor, F: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, a2: torch.Tensor,
                  want_diag: bool = False, tiles: Tiles = None):
    """K6.  X, F [B, n, r]; rows, cols int32 [B, Ko]; a2 [B, Ko] ->
    (rowsum(X*F) [B, n] or None, a2 * sym(XF^T) at (rows, cols)
    [B, Ko]).  ``tiles``: the off slots' schedule (adj_tiles); built
    here when None."""
    B, n, r = X.shape
    Ko = rows.shape[1]
    if (F.shape != X.shape or cols.shape != rows.shape
            or rows.shape[0] != B or a2.shape != rows.shape):
        raise ValueError("adj_a_offdiag: inconsistent shapes")
    if not _check("adj_a_offdiag", [X, F, a2], [rows, cols]):
        return adj_a_offdiag_plain(X, F, rows, cols, a2, want_diag)
    t = _off_tiles("adj_a_offdiag", tiles, rows, cols, n)
    d = (torch.empty((B, n), dtype=X.dtype, device=X.device)
         if want_diag else None)
    W_o = torch.empty((B, Ko), dtype=X.dtype, device=X.device)
    _typed_launch("adj_a_offdiag", "lt_adj_a_offdiag", X, X.data_ptr(),
                  F.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                  a2.data_ptr(), *_tile_args(t, (d, W_o), B, n, Ko, r))
    return d, W_o


# ---------------------------------------------------------------------------
# K7a: a2 .* X + diag(W_d) on full [B, n, n] matrices.
# ---------------------------------------------------------------------------

def adj_a_dense_plain(X, a2, W_d):
    out = a2 * X
    return out if W_d is None else out + torch.diag_embed(W_d)


def adj_a_dense(X: torch.Tensor, a2: torch.Tensor,
                W_d=None) -> torch.Tensor:
    """K7a.  X, a2 [B, n, n]; W_d [B, n] or None (no diagonal term) ->
    a2 * X + diag(W_d) [B, n, n]."""
    if X.dim() != 3 or X.shape[1] != X.shape[2]:
        raise ValueError(f"adj_a_dense: X of shape {tuple(X.shape)}")
    B, n, _ = X.shape
    if a2.shape != X.shape or (W_d is not None and W_d.shape != (B, n)):
        raise ValueError("adj_a_dense: inconsistent shapes")
    if not _check("adj_a_dense", [X, a2, W_d], []):
        return adj_a_dense_plain(X, a2, W_d)
    out = torch.empty_like(X)
    _typed_launch("adj_a_dense", "lt_adj_a_dense", X, X.data_ptr(),
                  a2.data_ptr(), _ptr(W_d), out.data_ptr(), B, n)
    return out


# ---------------------------------------------------------------------------
# K8c: the Gauss-Seidel sweep over the LP columns.
# ---------------------------------------------------------------------------

def lp_gs_sweep_plain(pc_con, pc_val, obj, nrm2, upd, fixed, csum, rhs, dual,
                      rho, s=None):
    """A Python loop over the columns, in the kernel's order of
    operations: each lane l of 32 sums the terms k = l, l+32, ... in
    order, the partial sums combine as the shuffle tree does, and the
    deltas are added one per constraint slot.  ``s`` [n]: the DUAL_U_V
    term, added to m2 last."""
    n, L = pc_con.shape
    m = csum.shape[0]
    csum = csum.clone()
    new = torch.empty_like(upd)
    zero = torch.zeros((), dtype=csum.dtype, device=csum.device)
    # rho as a tensor: a division by a Python scalar may be taken as a
    # product with its reciprocal, which the kernel does not do
    rho_t = torch.tensor(rho, dtype=csum.dtype, device=csum.device)
    Lp = -(-L // 32) * 32
    for j in range(n):
        con = pc_con[j].long()
        ok = con < m
        c = torch.where(ok, con, 0)
        t = torch.where(ok, pc_val[j] * (rho * (csum[c] - rhs[c]) - dual[c]),
                        zero)
        t = torch.cat([t, t.new_zeros(Lp - L)]).reshape(Lp // 32, 32)
        acc = torch.zeros(32, dtype=csum.dtype, device=csum.device)
        for row in t:
            acc = acc + row
        for off in (16, 8, 4, 2, 1):
            acc = torch.cat([acc[:off] + acc[off:2 * off], acc[off:]])
        u, v, nr = upd[j], fixed[j], nrm2[j]
        wsum = (obj[j] + acc[0]) - rho * nr * u * v
        m2 = wsum * v - rho * v
        if s is not None:
            m2 = m2 + s[j]
        nj = (-m2 / rho_t) / (1.0 + nr * v * v)
        new[j] = nj
        csum.index_add_(0, con[ok], pc_val[j][ok] * (nj - u) * v)
    return new, csum


def lp_gs_sweep(pc_con: torch.Tensor, pc_val: torch.Tensor,
                obj: torch.Tensor, nrm2: torch.Tensor, upd: torch.Tensor,
                fixed: torch.Tensor, csum: torch.Tensor, rhs: torch.Tensor,
                dual: torch.Tensor, rho,
                s: Optional[torch.Tensor] = None):
    """K8c.  pc_con int32 [n, L] (padding ids = m) and pc_val [n, L]: the
    columns' padded entries; obj, nrm2 (||a_j||^2), upd (u), fixed (v)
    [n]; csum, rhs, dual [m]; ``rho`` a number or a 0-d tensor (the
    kernel reads it from the device, so that a graph replays it as it
    changes); ``s`` [n] or None: the DUAL_U_V variant's signed term,
    m2 + s_j (admm.py:253) -> (new u [n], csum after the sweep [m]).
    ``csum`` itself is not modified."""
    n, L = pc_con.shape
    m = csum.shape[0]
    if (pc_val.shape != pc_con.shape or rhs.shape != (m,)
            or dual.shape != (m,)
            or any(t.shape != (n,) for t in (obj, nrm2, upd, fixed))
            or (s is not None and s.shape != (n,))):
        raise ValueError("lp_gs_sweep: inconsistent shapes")
    if not _check("lp_gs_sweep", [csum, pc_val, obj, nrm2, upd, fixed, rhs,
                                  dual, s], [pc_con]):
        return lp_gs_sweep_plain(pc_con, pc_val, obj, nrm2, upd, fixed,
                                 csum, rhs, dual, float(rho), s)
    out_sum = csum.clone()
    new = torch.empty_like(upd)
    rho_t = (rho.to(device=csum.device, dtype=csum.dtype).reshape(1)
             .contiguous() if isinstance(rho, torch.Tensor)
             else torch.full((1,), rho, dtype=csum.dtype,
                             device=csum.device))
    _typed_launch("lp_gs_sweep", "lt_lp_gs_sweep", csum, pc_con.data_ptr(),
                  pc_val.data_ptr(), obj.data_ptr(), nrm2.data_ptr(),
                  upd.data_ptr(), fixed.data_ptr(), out_sum.data_ptr(),
                  rhs.data_ptr(), dual.data_ptr(), _ptr(s), new.data_ptr(),
                  n, L, m, rho_t.data_ptr())
    if s is not None:
        _bump("with_s", "lp_gs_sweep")
    return new, out_sum


# ---------------------------------------------------------------------------
# K9: eigenpairs of small symmetric matrices.
# ---------------------------------------------------------------------------

# the largest n K9 takes (two copies of A and V at f64 fill about 105 KB
# of shared memory)
SYM_EIG_MAX_N = 64


def sym_eig_small_plain(A):
    return torch.linalg.eigh(A)


def sym_eig_small(A: torch.Tensor, sweeps: Optional[torch.Tensor] = None):
    """K9.  A [B, n, n] symmetric, 1 <= n <= SYM_EIG_MAX_N, its lower
    triangle read (as torch.linalg.eigh reads it) -> (eigenvalues
    ascending [B, n], eigenvectors [B, n, n], column j the unit
    eigenvector of eigenvalue j), with no host synchronisation (parallel
    cyclic Jacobi, a CTA a matrix, over the indices whose off-diagonal row
    is not exactly zero; each other index keeps its diagonal and e_i).
    ``sweeps``: int32 [B] on the card or None; where given, the kernel
    writes each matrix's Jacobi sweeps there."""
    if A.dim() != 3 or A.shape[1] != A.shape[2] \
            or not 1 <= A.shape[1] <= SYM_EIG_MAX_N:
        raise ValueError(f"sym_eig_small: A of shape {tuple(A.shape)} "
                         f"(need [B, n, n], 1 <= n <= {SYM_EIG_MAX_N})")
    if not _check("sym_eig_small", [A], [] if sweeps is None else [sweeps]):
        return sym_eig_small_plain(A)
    B, n, _ = A.shape
    if sweeps is not None and sweeps.shape != (B,):
        raise ValueError("sym_eig_small: sweeps must be [B]")
    evals = torch.empty((B, n), dtype=A.dtype, device=A.device)
    evecs = torch.empty_like(A)
    _typed_launch("sym_eig_small", "lt_sym_eig", A, A.data_ptr(),
                  evals.data_ptr(), evecs.data_ptr(), _ptr(sweeps), B, n)
    return evals, evecs
