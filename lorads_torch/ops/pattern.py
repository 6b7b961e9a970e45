"""Pattern kernels for buckets of blocks: split sparse and dense.

Port of the split and dense subsets of lorads_tpu/ops/pattern.py.
Presolve groups blocks of one mode and size class into a bucket of B
blocks padded to the bucket's dim n (every tensor is [B, ...]; a padded
block's extra rows carry no entries).  A sparse bucket's pattern is
split into its diagonal (dense [B, n] vectors) and its strictly-lower
entries ("off slots").
Constraints sit on any diagonal or off slots; their entries are kept in
lorads_tpu's layout (``a_con_d``/``a_row_d``/``a_val_d`` on the
diagonal, ``a_con_o``/``a_pos_o``/``a_val_o`` on the off slots, and
their slot- and row-sorted copies ``a_*_s``).  Two shapes:

* diag-identity (``diag_ident``, Max-Cut): A_i = a_i e_i e_i^T, so A(.)
  and A^*(.) are elementwise and the sparse work is C @ X (``cmul``,
  kernel K2) and the off values of sym(U V^T) (``uvt``, K3);
* general (matrix completion, ...): A(.) and A^*(.) are gathers and
  segment sums (``constr_vals``, ``build_w``: K4), W @ X reads W's off
  values through the entry list (``w_mul``: K5), the line search's pair
  SDDMM is K3p (``uvt_pair``), and the ADMM CG operator's
  A^*(A(.)) is K6 (``a_adj_a``) when every off constraint owns a slot.

Layout decisions of the port (fields lorads_tpu has and this module does
not build):

* no column-order mirror of the off pattern (``off_col_perm``,
  ``off_cols_sp``, ``off_rows_cp``, ``c_off_cp``, ``a2_off_cp``,
  ``a_*_co_s``) and no row-sorted off copy (``off_row_perm``,
  ``off_rows_s``, ``off_cols_rp``).  They exist because unsorted TPU
  scatters run at random-access latency.  Instead every split bucket
  carries the full-symmetric row-sorted entry list (``sym_rows_rs``,
  ``sym_cols_rs``, ``bnd_sym_rows``, with ``c_sym_rs``) and, port-only,
  ``sym_slot_rs``: the off slot each entry reads, so W @ X is one pass;
* no gathered-row caches (``gather_cache`` gives None): the cached
  forms compute from the factors directly, which a fused SDDMM reads
  from L2;
* the tile schedules of the off slots (K3, K3p, K6) and of the
  full-symmetric entry list (K5) (``off_tile_*``, ``sym_tile_*``, built
  once where the bucket lies by kernels.adj_tiles and kernels.wmul_tiles
  in tile_fields; ``off_tiles`` and ``sym_tiles`` hold them as
  kernels.Tiles), so that the kernels stage factor rows in shared
  memory a tile at a time;
* a constraint-sorted copy of the off constraint entries with CSR
  bounds (``a_con_o_cs``, ``a_pos_o_cs``, ``a_val_o_cs``,
  ``bnd_a_con_o_cs``) that always exists (lorads_tpu has bounds only
  when ``a_con_o`` happens to be sorted).  The diagonal entries are
  constraint-sorted by construction (``a_con_d``, ``bnd_a_con_d``).

A dense block (Lovász theta: C = -J) presolves into one DenseBucketData
holding lorads_tpu's dense fields: the full symmetric C (``c_full``),
the constraint entries at their lower and mirrored flat slots
(``a_lin``, ``a_lin_t``) with values ``a_val`` / ``a_val_mirror`` /
``a_val_inner``, and, when every constraint is single-entry or
diagonal-only (``a_single_dense``), the static plane ``a2_full`` of
A^*(A(.)) and the diagonal-only entries ``dd_*``.  Products of the
factors are ``torch.matmul`` (lorads_tpu leaves them to XLA); A(.) and
C + A^*(w) are kernel K4 over port-only CSR layouts, and A^*(A(.)) of
the CG operator is kernel K7a (``a_adj_a_dense``).  Port-only layout:

* (i) the constraint entries sorted by constraint (``a_lin_cs``,
  ``a_val_inner_cs``, CSR bounds ``bnd_a_con_cs`` over m_loc): A(.) is
  K4 over the flat [B, n^2] view of sym(UV^T);
* (ii) the lower and mirrored entries sorted by flat slot
  (``a_con2_s``, ``a_val2_s``, bounds ``bnd_a_lin2`` over the n^2
  slots; lorads_tpu's ``a_lin2_perm`` / ``bnd_a_lin2``): build_w is K4
  with one segment per slot and ``c_full`` as its base;
* (iii) the ``dd_*`` entries sorted by constraint (``dd_row_cs``,
  ``dd_val_cs``, ``bnd_dd_con``) and by row (``dd_con_rs``,
  ``dd_val_rs``, ``bnd_dd_row``).

Every sorted list leaves out the entries whose value is 0 (padding and
the diagonal's zeroed mirrors) and any constraint id >= m_loc, so K4
never reads outside x.  lorads_tpu's two-plane f32 scatter of f64 W
(``a_lin2_exact``) is not ported: it exists because TPU f64 is emulated.

Constraint slots are local to each block (``glob_idx`` [B, m_loc] maps
them to global ones, padding to m).  One block on the global slots
(``glob_ident``) scatters and gathers by identity; otherwise
``scatter_constr`` is K4 over a port-only list of every (block, local
slot) sorted by global slot (``scat_idx``, ``scat_val``, ``bnd_scat``),
and ``gather_w`` an ``index_select``.  ``bucket_slice`` gives one block
as a B = 1 bucket of views, for the ADMM's bucket Gauss-Seidel scan.

The shard layouts (lorads_tpu's, parallel/pattern_sharded.py and
row_sharded.py) reuse both bucket kinds with a B axis of shards of one
cone: ``summed`` split buckets (slot ranges of one sparse cone's
pattern) and ``rowshard`` dense ones (row slabs [B, n_loc, n] of one
dense cone).  Their factors stay [1, n, r] (``_expand``), factor-shaped
results sum or gather back (``_reduce``, ``_unslab``) and constraint
values are per-shard partials (``cone_total``).  ``local_bucket`` places
a bucket on a ``comm.Mesh``: a rank keeps its blocks or shards, with its
port-only fields built anew, and every sum over the B axis ends in one
collective (parallel/comm.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lorads_torch import device as dev
from lorads_torch.core.presolve import BucketPlan
from lorads_torch.ops import kernels
from lorads_torch.parallel import comm


def comp_segment_sum(data: torch.Tensor, bounds: torch.Tensor):
    """Sorted segment sum of ``data`` [B, N(, r)] over ``bounds``
    [B, S+1] (pattern.py:138-170) -> [B, S(, r)]: kernel K1."""
    return kernels.segment_sum(data, bounds)


def single_segment_sum(data: torch.Tensor, bounds: torch.Tensor):
    """Segment sum when every segment holds at most one entry
    (pattern.py:220-233).  K1 sums a one-entry segment exactly, so this
    is the same kernel."""
    return kernels.segment_sum(data, bounds)


@dataclasses.dataclass(frozen=True)
class BucketData:
    """Device tensors of one split bucket ([B, ...]).

    Field names and layouts are those of lorads_tpu's BucketData, plus
    the port-only fields named in the module docstring."""

    n: int
    B: int
    K: int
    m_loc: int
    m_glob: int
    Ko: int
    Ks: int
    nnz_d: int
    nnz_o: int
    has_off: bool
    has_diag_a: bool
    has_off_a: bool
    a_off_unique: bool
    glob_ident: bool
    diag_ident: bool
    glob_idx: torch.Tensor      # int32 [B, m_loc]
    c_diag: torch.Tensor        # [B, n]
    off_rows: torch.Tensor      # int32 [B, Ko] strictly-lower rows
    off_cols: torch.Tensor      # int32 [B, Ko]
    c_off: torch.Tensor         # [B, Ko]
    c_off2: torch.Tensor        # [B, Ko] = 2 * c_off
    # diagonal constraint entries, sorted by constraint (diag_ident:
    # constraint i == diagonal entry i, so a_val_d is [B, n])
    a_con_d: torch.Tensor       # int32 [B, nnz_d]
    a_row_d: torch.Tensor       # int32 [B, nnz_d]
    a_val_d: torch.Tensor       # [B, nnz_d]
    bnd_a_con_d: torch.Tensor   # int32 [B, m_loc+1]
    # ... and sorted by row (build_w's W_d)
    a_row_d_s: torch.Tensor     # int32 [B, nnz_d]
    a_con_d_s: torch.Tensor     # int32 [B, nnz_d]
    a_val_d_s: torch.Tensor     # [B, nnz_d]
    bnd_a_row_d_s: torch.Tensor  # int32 [B, n+1]
    # off constraint entries (raw values; <A, X> doubles them)
    a_con_o: torch.Tensor       # int32 [B, nnz_o]
    a_pos_o: torch.Tensor       # int32 [B, nnz_o] off slot
    a_val_o: torch.Tensor       # [B, nnz_o]
    # ... sorted by slot (build_w's W_o)
    a_pos_o_s: torch.Tensor     # int32 [B, nnz_o]
    a_con_o_s: torch.Tensor     # int32 [B, nnz_o]
    a_val_o_s: torch.Tensor     # [B, nnz_o]
    bnd_a_pos_o_s: torch.Tensor  # int32 [B, Ko+1]
    a2_off: torch.Tensor        # [B, Ko] sum of 2 a^2 per slot
    # full-symmetric entries (lower + mirror), row-sorted
    sym_rows_rs: torch.Tensor   # int32 [B, Ks]
    sym_cols_rs: torch.Tensor   # int32 [B, Ks]
    c_sym_rs: torch.Tensor      # [B, Ks]
    bnd_sym_rows: torch.Tensor  # int32 [B, n+1]
    # port-only: the off slot of each sym entry (-1: padding) and the
    # constraint-sorted off constraint entries
    sym_slot_rs: torch.Tensor   # int32 [B, Ks]
    a_con_o_cs: torch.Tensor    # int32 [B, nnz_o]
    a_pos_o_cs: torch.Tensor    # int32 [B, nnz_o]
    a_val_o_cs: torch.Tensor    # [B, nnz_o]
    bnd_a_con_o_cs: torch.Tensor  # int32 [B, m_loc+1]
    # port-only: the tile schedules (kernels.Tiles) of the off slots
    # (K6: each slot its own, [B, Ko]) and of the sym entries (K5:
    # each entry's off slot, [B, Ks]); U_o / U_s units a block
    off_tile_slot: torch.Tensor  # int32 [B, Ko]
    off_tile_ij: torch.Tensor   # int32 [B, Ko]
    off_tile_bnd: torch.Tensor  # int32 [B, U_o+1]
    off_tile_row0: torch.Tensor  # int32 [B, U_o]
    off_tile_col0: torch.Tensor  # int32 [B, U_o]
    sym_tile_slot: torch.Tensor  # int32 [B, Ks]
    sym_tile_ij: torch.Tensor   # int32 [B, Ks]
    sym_tile_bnd: torch.Tensor  # int32 [B, U_s+1]
    sym_tile_row0: torch.Tensor  # int32 [B, U_s]
    sym_tile_col0: torch.Tensor  # int32 [B, U_s]
    sym_tile_strip: torch.Tensor  # int32 [B, ceil(n / WMUL_STRIP) + 1]
    sym_tile_rowptr: torch.Tensor  # int32 [B, U_s * (WMUL_STRIP + 1)]
    # port-only: the scatter into the global m-vector (scatter_fields)
    scat_idx: torch.Tensor      # int32 [1, L]
    scat_val: torch.Tensor      # [1, L]
    bnd_scat: torch.Tensor      # int32 [1, m_glob+1]
    split: bool = True
    dense: bool = False
    # port-only: per block, (staged units, units of sparse tiles) of each
    # tile schedule (kernels.unit_counts; host values, no device read)
    off_tile_units: tuple = ()
    sym_tile_units: tuple = ()
    # the shard layouts and their placement (see SHARD_FIELDS): summed
    # (the B axis is a shard axis of one sparse cone), a diag-identity
    # parent cone's full diagonal map a_val_d_full [B, n] and the
    # scatter of shard 0's values (diag_scat_*), the mesh the B axis
    # lies on (comm.Mesh; None: unplaced) and this rank's first block
    # b0 of the B_all blocks (or shards) of the whole bucket
    summed: bool = False
    rowshard: bool = False
    n_loc: int = 0
    diag_parent: bool = False
    a_val_d_full: torch.Tensor = None
    diag_scat_idx: torch.Tensor = None
    diag_scat_val: torch.Tensor = None
    bnd_diag_scat: torch.Tensor = None
    mesh: object = None
    b0: int = 0
    B_all: int = 0

    def __post_init__(self):
        # the schedules as kernels.Tiles (``off_tiles``, ``sym_tiles``),
        # made once from the fields above; attributes, not fields
        object.__setattr__(self, "off_tiles", bucket_tiles(self, "off"))
        object.__setattr__(self, "sym_tiles", bucket_tiles(self, "sym"))

    @property
    def dtype(self) -> torch.dtype:
        return self.c_diag.dtype


# the arrays a BucketData is made of.  INT_FIELDS and FLOAT_FIELDS are
# shared with lorads_tpu's BucketData for every split bucket; SYM_*
# exist in lorads_tpu for diag-identity buckets only; PORT_* are the
# port's own.
INT_FIELDS = ("glob_idx", "off_rows", "off_cols", "a_con_d", "a_row_d",
              "bnd_a_con_d", "a_row_d_s", "a_con_d_s", "bnd_a_row_d_s",
              "a_con_o", "a_pos_o", "a_pos_o_s", "a_con_o_s",
              "bnd_a_pos_o_s")
FLOAT_FIELDS = ("c_diag", "a_val_d", "c_off", "c_off2", "a_val_d_s",
                "a_val_o", "a_val_o_s", "a2_off")
SYM_INT_FIELDS = ("sym_rows_rs", "sym_cols_rs", "bnd_sym_rows")
SYM_FLOAT_FIELDS = ("c_sym_rs",)
PORT_INT_FIELDS = ("sym_slot_rs", "a_con_o_cs", "a_pos_o_cs",
                   "bnd_a_con_o_cs", "scat_idx", "bnd_scat")
# the tile schedules' fields (tile_fields): K6's, K5's
TILE_FIELDS = {"off": ("slot", "ij", "bnd", "row0", "col0"),
               "sym": ("slot", "ij", "bnd", "row0", "col0", "strip",
                       "rowptr")}
TILE_INT_FIELDS = tuple(f"{p}_tile_{f}" for p, fs in TILE_FIELDS.items()
                        for f in fs)
PORT_FLOAT_FIELDS = ("a_val_o_cs", "scat_val")
# the bucket-wide [1, ...] fields (every other tensor is per block)
_SCATTER_FIELDS = ("scat_idx", "scat_val", "bnd_scat")
ALL_INT_FIELDS = (INT_FIELDS + SYM_INT_FIELDS + PORT_INT_FIELDS
                  + TILE_INT_FIELDS)
ALL_FLOAT_FIELDS = FLOAT_FIELDS + SYM_FLOAT_FIELDS + PORT_FLOAT_FIELDS
# the scalar layout (meta) of a BucketData
META_FIELDS = ("n", "B", "K", "m_loc", "m_glob", "Ko", "Ks", "nnz_d",
               "nnz_o", "has_off", "has_diag_a", "has_off_a",
               "a_off_unique", "glob_ident", "diag_ident")


def bucket_from_arrays(meta: dict, arrays: dict, dtype,
                       device) -> BucketData:
    """BucketData from numpy arrays (``arrays``) and the scalar layout
    (``meta``: META_FIELDS), with its tile schedules built on ``device``
    (tile_fields)."""
    t = {k: torch.as_tensor(np.array(arrays[k], dtype=np.int32),
                            device=device)
         for k in ALL_INT_FIELDS if k not in TILE_INT_FIELDS}
    t.update({k: torch.as_tensor(np.array(arrays[k], dtype=np.float64),
                                 device=device).to(dtype).contiguous()
              for k in ALL_FLOAT_FIELDS})
    t.update(tile_fields(meta["n"], t["off_rows"], t["off_cols"],
                         t["sym_slot_rs"], t["sym_cols_rs"],
                         t["bnd_sym_rows"]))
    return BucketData(**meta, **t)


def tile_fields(n: int, off_rows, off_cols, sym_slot, sym_cols,
                bnd_sym) -> dict:
    """The bucket fields of K6's tile schedule over the off slots
    (off_rows, off_cols int32 [B, Ko]: kernels.adj_tiles) and of K5's
    over the full-symmetric entry list (sym_slot, sym_cols [B, Ks],
    bnd_sym [B, n+1]: kernels.wmul_tiles), built where the tensors lie
    (one host read each for the unit counts), padding slots and entries
    included: ``off_tile_*``, ``sym_tile_*`` and the per-block unit
    counts ``off_tile_units``, ``sym_tile_units``."""
    tiles = {"off": kernels.adj_tiles(off_rows, off_cols, n),
             "sym": kernels.wmul_tiles(sym_slot, sym_cols, bnd_sym)}
    out = {f"{p}_tile_{f}": getattr(tiles[p], f)
           for p, fs in TILE_FIELDS.items() for f in fs}
    out.update({f"{p}_tile_units": tuple(map(tuple, kernels.unit_counts(
        t.row0, t.col0, n).tolist())) for p, t in tiles.items()})
    return out


def _bounds_np(ids: np.ndarray, S: int) -> np.ndarray:
    """bnd[b, j] = first position in the sorted ids[b] with value >= j."""
    out = np.zeros((ids.shape[0], S + 1), np.int32)
    r = np.arange(S + 1)
    for b in range(ids.shape[0]):
        out[b] = np.searchsorted(ids[b], r)
    return out


def sorted_prefix_bounds(ids, S: int) -> np.ndarray:
    """CSR bounds of per-block ids [B, L] that are sorted up to a tail of
    padding (zeros, after a block's last real entry; value 0): each
    row's sorted prefix is bounded over [0, S) and its tail, sent past
    the last bound, is left out.  lorads_tpu keeps no bounds for such
    rows and scatters by id instead (pattern.py:749-750)."""
    ids = np.array(ids, np.int64)
    for row in ids:
        down = np.nonzero(np.diff(row) < 0)[0]
        if down.size:
            row[down[0] + 1:] = S
    return _bounds_np(ids, S)


def _pad(x, L, fill=0):
    """[1, L] copy of the 1-D ``x`` padded with ``fill``."""
    out = np.full((1, L), fill, dtype=np.asarray(x).dtype)
    out[0, :x.size] = x
    return out


def _stack(rows, L, dtype, fill=0):
    """[B, L] array of the 1-D ``rows``, each padded with ``fill``."""
    out = np.full((len(rows), L), fill, dtype=dtype)
    for b, x in enumerate(rows):
        out[b, :np.asarray(x).size] = x
    return out


def scatter_fields(glob_idx, m_glob: int) -> dict:
    """The port's scatter of a bucket's local constraint values into the
    global m-vector: every (block b, local slot j) whose global slot
    glob_idx[b, j] is real (< m), as the flat index b * m_loc + j, stably
    sorted by its global slot (so each slot sums its blocks in order),
    with values 1 and CSR bounds over m -- one K4 launch
    (scatter_constr)."""
    g = np.asarray(glob_idx, np.int64).reshape(-1)
    keep = np.nonzero(g < m_glob)[0]
    flat = keep[np.argsort(g[keep], kind="stable")]
    L = max(flat.size, 1)
    return dict(scat_idx=_pad(flat, L), scat_val=_pad(np.ones(flat.size), L),
                bnd_scat=_bounds_np(g[flat][None], m_glob))


def port_fields(n: int, m_loc: int, off_rows, off_cols, c_off, a_con_o,
                a_pos_o, a_val_o) -> dict:
    """The port's host-built arrays of a split bucket, from its
    lorads_tpu-layout off pattern ([B, Ko] off_rows/off_cols/c_off, each
    block's real entries first) and off constraint entries ([B, nnz_o]
    a_con_o/a_pos_o/a_val_o): per block, the full-symmetric row-sorted
    entry list with each entry's off slot, and the constraint-sorted off
    constraint entries with CSR bounds.  Padding slots (value 0) are left
    out of the entry list; its own padding carries (row 0, col 0, value
    0, slot -1) and sorts to the front of row 0's segment."""
    B = off_rows.shape[0]
    ks = [int(np.count_nonzero(off_rows[b] != off_cols[b])) for b in range(B)]
    Ks = max(2 * max(ks), 1)
    sym_rows = np.zeros((B, Ks), np.int64)
    sym_cols = np.zeros((B, Ks), np.int64)
    sym_vals = np.zeros((B, Ks))
    sym_slot = np.full((B, Ks), -1, np.int64)
    for b, k in enumerate(ks):
        orow = off_rows[b, :k].astype(np.int64)
        ocol = off_cols[b, :k].astype(np.int64)
        sr = np.concatenate([orow, ocol])
        o_rs = np.argsort(sr, kind="stable")
        sym_rows[b, :2 * k] = sr[o_rs]
        sym_cols[b, :2 * k] = np.concatenate([ocol, orow])[o_rs]
        sym_vals[b, :2 * k] = np.tile(np.asarray(c_off[b, :k],
                                                 np.float64), 2)[o_rs]
        sym_slot[b, :2 * k] = np.tile(np.arange(k), 2)[o_rs]
        rs = np.argsort(sym_rows[b], kind="stable")
        for a in (sym_rows, sym_cols, sym_vals, sym_slot):
            a[b] = a[b][rs]
    oc = np.argsort(a_con_o, axis=1, kind="stable")
    ta = np.take_along_axis
    con_cs = ta(np.asarray(a_con_o), oc, 1)
    return dict(
        Ks=Ks, sym_rows_rs=sym_rows, sym_cols_rs=sym_cols,
        c_sym_rs=sym_vals, bnd_sym_rows=_bounds_np(sym_rows, n),
        sym_slot_rs=sym_slot, a_con_o_cs=con_cs,
        a_pos_o_cs=ta(np.asarray(a_pos_o), oc, 1),
        a_val_o_cs=ta(np.asarray(a_val_o), oc, 1),
        bnd_a_con_o_cs=_bounds_np(con_cs, m_loc))


@dataclasses.dataclass(frozen=True)
class DenseBucketData:
    """Device tensors of one dense bucket ([B, ...]).

    Field names and layouts are those of lorads_tpu's dense BucketData,
    plus the port-only sorted copies named in the module docstring.
    The a2_full / dd_* fields exist only when a_single_dense."""

    n: int
    B: int
    K: int
    m_loc: int
    m_glob: int
    nnz_a: int
    glob_ident: bool
    a_single_dense: bool
    nnz_dd: int
    glob_idx: torch.Tensor      # int32 [B, m_loc]
    c_full: torch.Tensor        # [B, n, n] full symmetric C
    a_lin: torch.Tensor         # int32 [B, nnz_a] row * n + col
    a_lin_t: torch.Tensor       # int32 [B, nnz_a] col * n + row
    a_con_loc: torch.Tensor     # int32 [B, nnz_a]
    a_val: torch.Tensor         # [B, nnz_a]
    a_val_mirror: torch.Tensor  # [B, nnz_a] 0 on the diagonal
    a_val_inner: torch.Tensor   # [B, nnz_a] x2 off the diagonal
    # port-only (i): A(.) layout
    a_lin_cs: torch.Tensor      # int32 [B, N1]
    a_val_inner_cs: torch.Tensor  # [B, N1]
    bnd_a_con_cs: torch.Tensor  # int32 [B, m_loc+1]
    # port-only (ii): A^*(w) layout
    a_con2_s: torch.Tensor      # int32 [B, N2]
    a_val2_s: torch.Tensor      # [B, N2]
    bnd_a_lin2: torch.Tensor    # int32 [B, n*n+1]
    # port-only: the scatter into the global m-vector (scatter_fields)
    scat_idx: torch.Tensor      # int32 [1, L]
    scat_val: torch.Tensor      # [1, L]
    bnd_scat: torch.Tensor      # int32 [1, m_glob+1]
    # single-entry / diagonal-only constraints (a_single_dense)
    a2_full: torch.Tensor = None  # [B, n, n] static plane of A^*(A(.))
    dd_con: torch.Tensor = None   # int32 [B, max(nnz_dd, 1)]
    dd_row: torch.Tensor = None   # int32 [B, max(nnz_dd, 1)]
    dd_val: torch.Tensor = None   # [B, max(nnz_dd, 1)]
    # port-only (iii): the dd entries by constraint and by row
    dd_row_cs: torch.Tensor = None
    dd_val_cs: torch.Tensor = None
    bnd_dd_con: torch.Tensor = None  # int32 [B, m_loc+1]
    dd_con_rs: torch.Tensor = None
    dd_val_rs: torch.Tensor = None
    bnd_dd_row: torch.Tensor = None  # int32 [B, n+1]
    split: bool = False
    dense: bool = True
    diag_ident: bool = False
    a_off_unique: bool = False
    # the row-slab layout (rowshard: c_full holds [B, n_loc, n] row slabs
    # of one dense cone) and the placement, as on BucketData
    summed: bool = False
    rowshard: bool = False
    n_loc: int = 0
    diag_parent: bool = False
    mesh: object = None
    b0: int = 0
    B_all: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return self.c_full.dtype


# the arrays of a DenseBucketData shared with lorads_tpu (the DD_*
# ones only when a_single_dense), its scalar layout, and its integer
# fields
DENSE_FIELDS = ("glob_idx", "c_full", "a_lin", "a_lin_t", "a_con_loc",
                "a_val", "a_val_mirror", "a_val_inner")
DENSE_DD_FIELDS = ("a2_full", "dd_con", "dd_row", "dd_val")
DENSE_META_FIELDS = ("n", "B", "K", "m_loc", "m_glob", "nnz_a",
                     "glob_ident", "a_single_dense", "nnz_dd")
_DENSE_INT_FIELDS = frozenset((
    "glob_idx", "a_lin", "a_lin_t", "a_con_loc", "a_lin_cs",
    "bnd_a_con_cs", "a_con2_s", "bnd_a_lin2", "dd_con", "dd_row",
    "dd_row_cs", "bnd_dd_con", "dd_con_rs", "bnd_dd_row", "scat_idx",
    "bnd_scat"))


def _csr(key, idx, val, S: int):
    """Per block b, the entries (key, idx, val) of [B, N] arrays whose
    value is nonzero and whose key lies in [0, S), stably sorted by key
    -> ([B, L] idx, [B, L] val, [B, S+1] bounds), L = max(largest count,
    1); each block's padding (idx 0, value 0) lies past its last bound."""
    key, idx, val = (np.asarray(a) for a in (key, idx, val))
    rows = []
    for b in range(key.shape[0]):
        keep = (val[b] != 0) & (key[b] >= 0) & (key[b] < S)
        o = np.argsort(key[b][keep], kind="stable")
        rows.append((key[b][keep][o], idx[b][keep][o], val[b][keep][o]))
    L = max(max(r[0].size for r in rows), 1)
    bnd = np.zeros((len(rows), S + 1), np.int32)
    for b, (k, _, _) in enumerate(rows):
        bnd[b] = np.searchsorted(k, np.arange(S + 1))
    return (_stack([r[1] for r in rows], L, np.int64),
            _stack([r[2] for r in rows], L, np.float64), bnd)


def dense_port_fields(n: int, m_loc: int, a_lin, a_lin_t, a_con_loc,
                      a_val, a_val_mirror, a_val_inner, dd_con=None,
                      dd_row=None, dd_val=None, slots=None) -> dict:
    """The port's host-built sorted copies (i)-(iii) of a dense bucket
    from its lorads_tpu-layout [B, nnz_a] entry arrays (and the dd
    entries when a_single_dense).  Entries of constraint id >= m_loc are
    left out (their value is taken as 0).  ``slots``: the flat slots of
    W (n^2; a rowshard layout's n_loc * n slab slots)."""
    slots = n * n if slots is None else slots
    con = np.asarray(a_con_loc)
    ok = con < m_loc
    out = {}
    out["a_lin_cs"], out["a_val_inner_cs"], out["bnd_a_con_cs"] = _csr(
        con, a_lin, np.where(ok, a_val_inner, 0.0), m_loc)
    out["a_con2_s"], out["a_val2_s"], out["bnd_a_lin2"] = _csr(
        np.concatenate([a_lin, a_lin_t], axis=1),
        np.concatenate([con, con], axis=1),
        np.where(np.concatenate([ok, ok], axis=1),
                 np.concatenate([a_val, a_val_mirror], axis=1), 0.0), slots)
    if dd_con is not None:
        out["dd_row_cs"], out["dd_val_cs"], out["bnd_dd_con"] = _csr(
            dd_con, dd_row, dd_val, m_loc)
        out["dd_con_rs"], out["dd_val_rs"], out["bnd_dd_row"] = _csr(
            dd_row, dd_con, np.where(np.asarray(dd_con) < m_loc, dd_val,
                                     0.0), n)
    return out


def dense_bucket_from_arrays(meta: dict, arrays: dict, dtype,
                             device) -> DenseBucketData:
    """DenseBucketData from numpy arrays (None stays None) and the scalar
    layout (``meta``: DENSE_META_FIELDS)."""
    t = {}
    for k, a in arrays.items():
        if a is None:
            t[k] = None
        elif k in _DENSE_INT_FIELDS:
            t[k] = torch.as_tensor(np.array(a, dtype=np.int32),
                                   device=device)
        else:
            t[k] = torch.as_tensor(np.array(a, dtype=np.float64),
                                   device=device).to(dtype).contiguous()
    return DenseBucketData(**meta, **t)


def _glob_ident(bp: BucketPlan, m_glob: int) -> bool:
    """One block whose constraint slots are the global ones."""
    return (bp.B == 1 and bp.m_loc == m_glob
            and bool(np.array_equal(bp.glob_idx[0], np.arange(m_glob))))


def build_dense_bucket_data(bp: BucketPlan, m_glob: int, dtype,
                            device) -> DenseBucketData:
    """Host construction of a dense bucket in lorads_tpu's layout
    (pattern.py:826-908), plus the port's sorted copies
    (dense_port_fields) and its scatter (scatter_fields).  Blocks of a
    smaller dim are padded to n: their C, entries and factor rows are
    zero there."""
    B, n = bp.B, bp.n
    if n * n >= 2 ** 31:
        raise ValueError(f"dense bucket n={n}: n^2 slots overflow int32")
    rows = bp.pat_rows.astype(np.int64)
    cols = bp.pat_cols.astype(np.int64)
    ap = bp.a_pos.astype(np.int64)
    a_rows = np.take_along_axis(rows, ap, axis=1)
    a_cols = np.take_along_axis(cols, ap, axis=1)
    is_diag = rows == cols
    a_val_inner = bp.a_val * np.where(a_rows == a_cols, 1.0, 2.0)
    a_val_mirror = np.where(a_rows == a_cols, 0.0, bp.a_val)
    c_full = np.zeros((B, n, n))
    bidx = np.repeat(np.arange(B), bp.K)
    np.add.at(c_full, (bidx, rows.ravel(), cols.ravel()), bp.c_pat.ravel())
    np.add.at(c_full, (bidx, cols.ravel(), rows.ravel()),
              np.where(is_diag, 0.0, bp.c_pat).ravel())

    # every (real) constraint single-entry or diagonal-only, per block
    # (pattern.py:855-893)
    single_ok = True
    a2_full = np.zeros((B, n, n))
    dd = []
    for b in range(B):
        real = bp.a_val[b] != 0.0
        con = bp.a_con_loc[b][real].astype(np.int64)
        r_, c_, v_ = a_rows[b][real], a_cols[b][real], bp.a_val[b][real]
        d_ = r_ == c_
        all_diag = np.ones(bp.m_loc, bool)
        np.logical_and.at(all_diag, con, d_)
        cnts = np.bincount(con, minlength=bp.m_loc)
        single_ok &= bool(np.all(all_diag[con] | (cnts[con] == 1)))
        dsel = all_diag[con]
        dd.append((con[dsel], r_[dsel], v_[dsel]))
        osel = ~dsel
        w2 = np.where(d_[osel], 1.0, 2.0) * v_[osel] ** 2
        np.add.at(a2_full[b], (r_[osel], c_[osel]), w2)
        np.add.at(a2_full[b], (c_[osel], r_[osel]),
                  np.where(d_[osel], 0.0, w2))
    nnz_dd = max(d[0].size for d in dd)
    meta = dict(n=n, B=B, K=bp.K, m_loc=bp.m_loc, m_glob=m_glob,
                nnz_a=bp.nnz_a, glob_ident=_glob_ident(bp, m_glob),
                a_single_dense=single_ok, nnz_dd=nnz_dd)
    arrays = dict(glob_idx=bp.glob_idx, c_full=c_full,
                  a_lin=a_rows * n + a_cols, a_lin_t=a_cols * n + a_rows,
                  a_con_loc=bp.a_con_loc, a_val=bp.a_val,
                  a_val_mirror=a_val_mirror, a_val_inner=a_val_inner)
    if single_ok:
        L = max(nnz_dd, 1)
        arrays.update(a2_full=a2_full,
                      dd_con=_stack([d[0] for d in dd], L, np.int64),
                      dd_row=_stack([d[1] for d in dd], L, np.int64),
                      dd_val=_stack([d[2] for d in dd], L, np.float64))
    arrays.update(dense_port_fields(
        n, bp.m_loc, arrays["a_lin"], arrays["a_lin_t"], bp.a_con_loc,
        bp.a_val, a_val_mirror, a_val_inner,
        *(arrays[k] for k in ("dd_con", "dd_row", "dd_val"))
        if single_ok else ()))
    arrays.update(scatter_fields(bp.glob_idx, m_glob))
    return dense_bucket_from_arrays(meta, arrays, dtype, device)


def build_bucket_data(bp: BucketPlan, m_glob: int, dtype, device):
    """Host construction of one bucket: dense buckets in
    build_dense_bucket_data, split ones here in lorads_tpu's layout
    (pattern.py:578-766, 909-930), block by block and padded to the
    bucket's widths, plus the port's own fields (port_fields,
    scatter_fields)."""
    if bp.dense:
        return build_dense_bucket_data(bp, m_glob, dtype, device)
    B, n = bp.B, bp.n
    per_off, per_ad, per_ao = [], [], []
    c_diag = np.zeros((B, n))
    ident = True
    for b in range(B):
        pr = bp.pat_rows[b].astype(np.int64)
        pc = bp.pat_cols[b].astype(np.int64)
        cp = bp.c_pat[b]
        is_d = pr == pc
        off_idx = np.nonzero(~is_d)[0]
        off_of = np.zeros(pr.size, np.int64)
        off_of[off_idx] = np.arange(off_idx.size)
        np.add.at(c_diag[b], pr[is_d], cp[is_d])
        per_off.append((pr[off_idx], pc[off_idx], cp[off_idx]))
        ap = bp.a_pos[b].astype(np.int64)
        ac = bp.a_con_loc[b].astype(np.int64)
        av = bp.a_val[b]
        ed = is_d[ap]
        # diagonal entries ordered by constraint slot
        con_d, row_d, val_d = ac[ed], pr[ap[ed]], av[ed]
        od = np.argsort(con_d, kind="stable")
        per_ad.append((con_d[od], row_d[od], val_d[od]))
        eo = ~ed
        per_ao.append((ac[eo], off_of[ap[eo]], av[eo]))
        p = bp.plans[b]
        # "identity" demands pure diagonal-entry constraints
        # (pattern.py:615-623)
        ident &= (p.dim == n and p.m_loc == n and con_d.size == n
                  and not np.any(eo)
                  and bool(np.all(per_ad[-1][0] == np.arange(n)))
                  and bool(np.all(per_ad[-1][1] == np.arange(n))))
    Ko = max(max(o[0].size for o in per_off), 1)
    nnz_d = max(max(a[0].size for a in per_ad), 1)
    nnz_o = max(max(a[0].size for a in per_ao), 1)
    ident = ident and all(a[0].size == nnz_d for a in per_ad)
    off_rows, off_cols = (_stack([o[i] for o in per_off], Ko, np.int64)
                          for i in (0, 1))
    c_off = _stack([o[2] for o in per_off], Ko, np.float64)
    a_con_d, a_row_d = (_stack([a[i] for a in per_ad], nnz_d, np.int64)
                        for i in (0, 1))
    a_val_d = _stack([a[2] for a in per_ad], nnz_d, np.float64)
    a_con_o, a_pos_o = (_stack([a[i] for a in per_ao], nnz_o, np.int64)
                        for i in (0, 1))
    a_val_o = _stack([a[2] for a in per_ao], nnz_o, np.float64)
    ta = np.take_along_axis
    po = np.argsort(a_pos_o, axis=1, kind="stable")
    rd = np.argsort(a_row_d, axis=1, kind="stable")

    # A^*(A(.)) is slot-diagonal on the off pattern when, in every
    # block, each off entry owns a distinct slot and a distinct
    # constraint, disjoint from the diagonal constraints
    # (pattern.py:671-683)
    off_unique = True
    a2_off = np.zeros((B, Ko))
    for b, ((con_o, pos_o, val_o), (con_d, _, _)) in enumerate(
            zip(per_ao, per_ad)):
        off_unique &= (np.unique(pos_o).size == pos_o.size
                       and np.unique(con_o).size == con_o.size
                       and not np.intersect1d(con_o, con_d).size)
        np.add.at(a2_off[b], pos_o, 2.0 * val_o ** 2)

    has_off_a = any(a[0].size for a in per_ao)
    meta = dict(n=n, B=B, K=bp.K, m_loc=bp.m_loc, m_glob=m_glob, Ko=Ko,
                nnz_d=nnz_d, nnz_o=nnz_o,
                has_off=any(o[0].size for o in per_off),
                has_diag_a=any(a[0].size for a in per_ad),
                has_off_a=has_off_a,
                a_off_unique=bool(off_unique and has_off_a),
                glob_ident=_glob_ident(bp, m_glob), diag_ident=bool(ident))
    arrays = dict(
        glob_idx=bp.glob_idx, c_diag=c_diag, off_rows=off_rows,
        off_cols=off_cols, c_off=c_off, c_off2=2.0 * c_off,
        a_con_d=a_con_d, a_row_d=a_row_d, a_val_d=a_val_d,
        bnd_a_con_d=sorted_prefix_bounds(a_con_d, bp.m_loc),
        a_row_d_s=ta(a_row_d, rd, 1), a_con_d_s=ta(a_con_d, rd, 1),
        a_val_d_s=ta(a_val_d, rd, 1),
        bnd_a_row_d_s=_bounds_np(ta(a_row_d, rd, 1), n),
        a_con_o=a_con_o, a_pos_o=a_pos_o, a_val_o=a_val_o,
        a_pos_o_s=ta(a_pos_o, po, 1), a_con_o_s=ta(a_con_o, po, 1),
        a_val_o_s=ta(a_val_o, po, 1),
        bnd_a_pos_o_s=_bounds_np(ta(a_pos_o, po, 1), Ko), a2_off=a2_off)
    port = port_fields(n, bp.m_loc, off_rows, off_cols, c_off, a_con_o,
                       a_pos_o, a_val_o)
    meta["Ks"] = port.pop("Ks")
    arrays.update(port)
    arrays.update(scatter_fields(bp.glob_idx, m_glob))
    return bucket_from_arrays(meta, arrays, dtype, device)


# ---------------------------------------------------------------------------
# Buckets from lorads_tpu's layout, the shard layouts and placement.
# ---------------------------------------------------------------------------

# the shard fields of either bucket kind (host values)
SHARD_META = ("summed", "rowshard", "n_loc", "diag_parent", "b0", "B_all")


def split_from_layout(meta: dict, arrays: dict, dtype, device,
                      a_val_d_full=None, **shard) -> BucketData:
    """A split BucketData from lorads_tpu's layout: ``meta``
    (META_FIELDS but Ks) and ``arrays`` (INT_FIELDS, FLOAT_FIELDS as
    numpy), the port-only fields built on the host from those arrays
    (port_fields, sorted_prefix_bounds, scatter_fields) and the tile
    schedules on ``device``.  ``shard``: SHARD_META values and ``mesh``;
    ``a_val_d_full`` (a diag-parent shard layout's full diagonal map)
    brings the scatter of shard 0's values (diag_scat_*)."""
    meta, arrays = dict(meta), dict(arrays)
    port = port_fields(meta["n"], meta["m_loc"], arrays["off_rows"],
                       arrays["off_cols"], arrays["c_off"],
                       arrays["a_con_o"], arrays["a_pos_o"],
                       arrays["a_val_o"])
    meta["Ks"] = port.pop("Ks")
    arrays.update(port)
    arrays["bnd_a_con_d"] = sorted_prefix_bounds(arrays["a_con_d"],
                                                 meta["m_loc"])
    arrays.update(scatter_fields(arrays["glob_idx"], meta["m_glob"]))
    bk = bucket_from_arrays(meta, arrays, dtype, device)
    if a_val_d_full is not None:
        sc = scatter_fields(np.asarray(arrays["glob_idx"])[:1],
                            meta["m_glob"])
        shard.update(
            a_val_d_full=torch.as_tensor(
                np.array(a_val_d_full, np.float64),
                device=device).to(dtype),
            diag_scat_idx=torch.as_tensor(sc["scat_idx"].astype(np.int32),
                                          device=device),
            diag_scat_val=torch.as_tensor(sc["scat_val"],
                                          device=device).to(dtype),
            bnd_diag_scat=torch.as_tensor(sc["bnd_scat"], device=device))
    return dataclasses.replace(bk, **shard) if shard else bk


def dense_from_layout(meta: dict, arrays: dict, dtype, device,
                      **shard) -> DenseBucketData:
    """A DenseBucketData from lorads_tpu's layout (DENSE_META_FIELDS;
    DENSE_FIELDS and, when a_single_dense, DENSE_DD_FIELDS as numpy),
    the port-only fields built on the host (dense_port_fields over the
    n^2 slots, or a rowshard layout's n_loc * n slab slots,
    scatter_fields).  ``shard``: SHARD_META values and ``mesh``."""
    arrays = dict(arrays)
    slots = (shard["n_loc"] if shard.get("rowshard") else meta["n"]) \
        * meta["n"]
    ent = {k: arrays[k] for k in ("a_lin", "a_lin_t", "a_con_loc", "a_val",
                                  "a_val_mirror", "a_val_inner")}
    if shard.get("rowshard"):
        # a slab's entry list holds the mirrors: no mirrored copy
        ent.update(a_lin_t=np.zeros_like(ent["a_lin"]),
                   a_val_mirror=np.zeros_like(ent["a_val"]))
    arrays.update(dense_port_fields(
        meta["n"], meta["m_loc"], *ent.values(),
        *(arrays[k] for k in ("dd_con", "dd_row", "dd_val"))
        if meta["a_single_dense"] else (), slots=slots))
    arrays.update(scatter_fields(arrays["glob_idx"], meta["m_glob"]))
    bk = dense_bucket_from_arrays(meta, arrays, dtype, device)
    return dataclasses.replace(bk, **shard) if shard else bk


def layout_of(bk):
    """(meta, arrays, shard) of a port bucket in lorads_tpu's layout, the
    arrays as host numpy, a counted read each (the inverse of
    split_from_layout and dense_from_layout)."""
    host = lambda t: dev.host_array(t, "other")  # noqa: E731
    shard = {k: getattr(bk, k) for k in SHARD_META}
    if bk.dense:
        meta = {k: getattr(bk, k) for k in DENSE_META_FIELDS}
        names = DENSE_FIELDS + (DENSE_DD_FIELDS if bk.a_single_dense
                                else ())
        return meta, {k: host(getattr(bk, k)) for k in names}, shard
    meta = {k: getattr(bk, k) for k in META_FIELDS if k != "Ks"}
    arrays = {k: host(getattr(bk, k)) for k in INT_FIELDS + FLOAT_FIELDS}
    if bk.diag_parent:
        shard["a_val_d_full"] = host(bk.a_val_d_full)
    return meta, arrays, shard


def local_bucket(bk, mesh, device=None):
    """This rank's part of an unplaced bucket (lorads_tpu's device_put of
    its B axis, parallel/sharded.py:100-121): blocks (dp) or shards (the
    shard layouts) [b0, b0 + B / mesh.size) of lorads_tpu's layout, the
    port-only fields built anew from them (never sliced from the whole
    bucket's), placed on ``mesh``."""
    if bk.B % mesh.size:
        raise ValueError(f"{bk.B} blocks over {mesh.size} ranks")
    k = bk.B // mesh.size
    b0 = mesh.index * k
    meta, arrays, shard = layout_of(bk)
    arrays = {n: a[b0:b0 + k] for n, a in arrays.items()}
    meta.update(B=k)
    shard.update(mesh=mesh, b0=b0, B_all=bk.B)
    dtype, device = bk.dtype, device or mesh.device
    if bk.dense:
        return dense_from_layout(meta, arrays, dtype, device, **shard)
    if shard.get("a_val_d_full") is not None:
        shard["a_val_d_full"] = shard["a_val_d_full"][b0:b0 + k]
    return split_from_layout(meta, arrays, dtype, device, **shard)


def bucket_slice(bk, b: int):
    """Block b of a bucket as a B = 1 bucket whose tensors are views of
    the bucket's (the bucket Gauss-Seidel scan updates one block at a
    time; lorads_tpu slices the same way inside its lax.scan,
    admm.py:287-293).  Its scatter takes the block's own local slots,
    which are sorted by global slot (presolve's loc2glob), with bounds
    over m; padded slots (global id m) lie past the last bound."""
    own = {}
    for f in dataclasses.fields(bk):
        v = getattr(bk, f.name)
        if isinstance(v, torch.Tensor) and f.name not in _SCATTER_FIELDS:
            own[f.name] = v[b:b + 1]
    g = bk.glob_idx[b].contiguous()
    dev = g.device
    if not bk.dense:  # the block's own unit counts
        own.update(off_tile_units=(bk.off_tile_units[b],),
                   sym_tile_units=(bk.sym_tile_units[b],))
    own.update(
        B=1, glob_ident=False, mesh=None,
        scat_idx=torch.arange(bk.m_loc, dtype=torch.int32, device=dev)[None],
        scat_val=torch.ones((1, bk.m_loc), dtype=bk.dtype, device=dev),
        bnd_scat=torch.searchsorted(
            g, torch.arange(bk.m_glob + 1, dtype=torch.int32, device=dev),
            out_int32=True)[None])
    return dataclasses.replace(bk, **own)


def cast_floats(bk, dtype):
    """The bucket with every float tensor cast to ``dtype`` (the f32 view
    the Lanczos certificate and the mixed-precision CG sweep on)."""
    fields = (k.name for k in dataclasses.fields(bk))
    return dataclasses.replace(bk, **{
        k: getattr(bk, k).to(dtype) for k in fields
        if isinstance(getattr(bk, k), torch.Tensor)
        and getattr(bk, k).is_floating_point()})


def scale_bucket(bk, s: float):
    """The bucket with its objective data scaled by s (reopt;
    lorads_tpu/alg/aop.py:68-79)."""
    if bk.dense:
        return dataclasses.replace(bk, c_full=bk.c_full * s)
    return dataclasses.replace(
        bk, c_diag=bk.c_diag * s, c_off=bk.c_off * s, c_off2=bk.c_off2 * s,
        c_sym_rs=bk.c_sym_rs * s)


# ---------------------------------------------------------------------------
# The shard layouts' glue (pattern.py:993-1053).  A summed or rowshard
# bucket's B axis is a shard axis of ONE cone: its factors are [1, n, r]
# on every shard; factor-shaped outputs are summed (summed) or gathered
# (rowshard) back to [1, n, r], and constraint values are per-shard
# partials that cone_total and scatter_constr sum.  A dp bucket's B axis
# holds blocks.  Unplaced (mesh None) the B axis holds every shard or
# block and each sum is local; placed, a rank holds its own and the local
# sum is followed by one collective (parallel/comm.py).  lorads_tpu's
# with_sharding_constraint pins (_pin, pin_factor_summed) have no
# counterpart: placement here is explicit.
# ---------------------------------------------------------------------------

def dp_mesh(bk):
    """The mesh of a bucket whose blocks are spread over ranks (dp), else
    None (unplaced buckets, and the shard layouts, whose factors are
    whole on every rank)."""
    return None if (bk.summed or bk.rowshard) else bk.mesh


def n_blocks(bk) -> int:
    """The bucket's blocks over all ranks (a dp bucket holds B_all, this
    rank B of them); a shard layout's B counts shards, not blocks."""
    return bk.B_all if dp_mesh(bk) is not None else bk.B


def shard_sum(bk, x: torch.Tensor, site: str) -> torch.Tensor:
    """The sum of a per-block or per-shard quantity over the whole bucket
    (objective partials, say): torch.sum, then over the mesh."""
    return comm.all_reduce(torch.sum(x), bk.mesh, site)


def factor_sum(bk, x: torch.Tensor, site: str) -> torch.Tensor:
    """The sum of a factor-shaped quantity of one bucket ([B, n, r]
    products): over the mesh only where the factors are split over ranks
    (dp); a shard layout's factors are whole on every rank."""
    return comm.all_reduce(torch.sum(x), dp_mesh(bk), site)


def _expand(bk, X: torch.Tensor) -> torch.Tensor:
    """A summed bucket's [1, n, r] factor broadcast to its [B, n, r]
    shards (pattern.py:993-1003)."""
    if bk.summed and X.shape[0] != bk.B:
        return X.expand((bk.B,) + tuple(X.shape[1:])).contiguous()
    return X


def _reduce(bk, X: torch.Tensor, site: str = "reduce") -> torch.Tensor:
    """A summed bucket's per-shard factor-shaped partials summed to
    [1, ...] (pattern.py:1006-1016): over the local shards, then over
    the mesh."""
    if bk.summed:
        return comm.all_reduce(torch.sum(X, 0, keepdim=True), bk.mesh,
                               site)
    return X


def _shards(bk) -> int:
    """Shards of a shard layout over all ranks."""
    return bk.B_all if bk.mesh is not None else bk.B


def _slab(bk, X: torch.Tensor) -> torch.Tensor:
    """This rank's row slabs [B, n_loc, r] of a [1, n, r] factor
    (pattern.py:1031-1037)."""
    r = X.shape[-1]
    D = _shards(bk)
    P = torch.nn.functional.pad(X[0], (0, 0, 0, D * bk.n_loc - bk.n))
    return P.reshape(D, bk.n_loc, r)[bk.b0:bk.b0 + bk.B]


def _unslab(bk, X: torch.Tensor) -> torch.Tensor:
    """Disjoint row slabs [B, n_loc, r] concatenated to [1, n, r]
    (pattern.py:1040-1043): an all_gather over the mesh."""
    X = comm.all_gather(X, bk.mesh, "unslab")
    return X.reshape(1, -1, X.shape[-1])[:, :bk.n]


def cone_total(bk, vals: torch.Tensor) -> torch.Tensor:
    """Per-cone constraint values (pattern.py:1046-1053): on the shard
    layouts the sum of the per-shard partials, on every shard (over the
    mesh where placed); else the values themselves."""
    if bk.summed or bk.rowshard:
        tot = comm.all_reduce(torch.sum(vals, 0, keepdim=True), bk.mesh,
                              "cone_total")
        return tot.expand_as(vals).contiguous()
    return vals


# ---------------------------------------------------------------------------
# Kernels.  Factors are [B, n, r].
# ---------------------------------------------------------------------------

def _sym_product(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """sym(UV^T) = (UV^T + VU^T) / 2 as full [B, n, n] matrices: one
    torch.matmul (TF32 is off, device.py), as lorads_tpu leaves the
    dense product to XLA at full precision (pattern.py:1078-1084)."""
    P = torch.matmul(U, V.transpose(1, 2))
    return 0.5 * (P + P.transpose(1, 2))


def uvt(bk, U: torch.Tensor, V: torch.Tensor):
    """sym(UV^T): full [B, n, n] on dense buckets, else on the split
    pattern (diag [B, n], off [B, Ko]) -- kernel K3
    (pattern.py:1085-1092) over the off slots' schedule, one dot an
    entry when V is U."""
    if bk.rowshard:
        # this rank's row slabs of sym(UV^T): 0.5 (U_loc V^T + V_loc U^T)
        # (pattern.py:1063-1076), the row-distributed dsyr2k
        return 0.5 * (torch.matmul(_slab(bk, U), V[0].transpose(0, 1))
                      + torch.matmul(_slab(bk, V), U[0].transpose(0, 1)))
    if bk.dense:
        return _sym_product(U, V)
    U, V = _expand(bk, U), _expand(bk, V)
    return kernels.uvt_split(U.contiguous(), V.contiguous(), bk.off_rows,
                             bk.off_cols, tiles=bk.off_tiles)


def uvt_pair(bk, R: torch.Tensor, D: torch.Tensor):
    """(sym(RD^T), sym(DD^T)) for the ALM line search: two dense
    products on dense buckets (pattern.py:1108-1109), else the pattern
    values in one pass -- kernel K3p (pattern.py:1110-1119)."""
    if bk.rowshard:
        return uvt(bk, R, D), uvt(bk, D, D)
    if bk.dense:
        return _sym_product(R, D), _sym_product(D, D)
    R, D = _expand(bk, R), _expand(bk, D)
    rd_d, rd_o, dd_d, dd_o = kernels.uvt_pair_split(
        R.contiguous(), D.contiguous(), bk.off_rows, bk.off_cols,
        tiles=bk.off_tiles)
    return (rd_d, rd_o), (dd_d, dd_o)


def constr_vals(bk, uvt_val) -> torch.Tensor:
    """A(sym(UV^T)) -> [B, m_loc] (pattern.py:1146-1173): on dense
    buckets kernel K4 over the flat [B, n^2] view at the
    constraint-sorted entries (layout (i)); elementwise for
    diag-identity buckets; else K4 over the diagonal entries and over
    the off entries (whose <A, X> weight is 2 a)."""
    if bk.dense:
        # (on a row slab [B, n_loc, n] too: its entries index the slab)
        B = uvt_val.shape[0]
        return kernels.gather_segsum(
            uvt_val.reshape(B, -1).contiguous(), bk.a_lin_cs,
            bk.a_val_inner_cs, bk.bnd_a_con_cs)
    d, o = uvt_val
    if bk.diag_ident:
        return bk.a_val_d * d            # constraint i == diag entry i
    vals = None
    if bk.has_diag_a:
        vals = kernels.gather_segsum(d, bk.a_row_d, bk.a_val_d,
                                     bk.bnd_a_con_d)
    if bk.has_off_a:
        vals = kernels.gather_segsum(o, bk.a_pos_o_cs, bk.a_val_o_cs,
                                     bk.bnd_a_con_o_cs, base=vals,
                                     alpha=2.0)
    if vals is None:
        vals = torch.zeros((d.shape[0], bk.m_loc), dtype=d.dtype,
                           device=d.device)
    return vals


def obj_inner(bk, uvt_val) -> torch.Tensor:
    """<C, sym(UV^T)> per block -> [B]."""
    if bk.dense:
        return torch.sum(bk.c_full * uvt_val, dim=(1, 2))
    d, o = uvt_val
    out = torch.sum(bk.c_diag * d, dim=1)
    if bk.has_off:
        out = out + torch.sum(bk.c_off2 * o, dim=1)
    return out


def scatter_constr(bk, vals: torch.Tensor) -> torch.Tensor:
    """Local constraint values [B, m_loc] -> the global m-vector
    (pattern.py:1189-1204): the identity for one block on the global
    slots, else kernel K4 over the port's list of every (block, local
    slot) sorted by global slot (scatter_fields)."""
    if bk.glob_ident:
        return vals[0]
    tot = kernels.gather_segsum(vals.reshape(1, -1), bk.scat_idx,
                                bk.scat_val, bk.bnd_scat)[0]
    # a placed bucket's other blocks or shards: over the mesh
    return comm.all_reduce(tot, bk.mesh, "scatter_constr")


def gather_w(bk, w: torch.Tensor) -> torch.Tensor:
    """The global m-vector at this bucket's constraint slots -> [B, m_loc]
    (pattern.py:1207-1212); padded slots (global id m) read 0.  A pure
    gather, which lorads_tpu also leaves to XLA: ``index_select``."""
    if bk.glob_ident:
        return w[None]
    w1 = torch.cat([w, w.new_zeros(1)])
    return w1.index_select(0, bk.glob_idx.reshape(-1)).reshape(
        bk.glob_idx.shape)


def build_w(bk, w_loc: torch.Tensor, include_obj: bool = True):
    """W = [C +] sum_i w_i A_i.  Dense buckets: full [B, n, n], kernel
    K4 with one segment per flat slot over the slot-sorted entries and
    their mirrors (layout (ii)), C riding in as K4's base
    (pattern.py:1250-1274).  Split buckets: (W_d [B, n], W_o [B, Ko])
    (pattern.py:1275-1304); general ones sum each diagonal row and
    each off slot over its constraint entries with K4, the objective
    as K4's base.  (lorads_tpu also returns a column-order mirror of
    W_o; the port has none.)"""
    if bk.dense:
        # (a rowshard bucket's W: this rank's row slabs [B, n_loc, n],
        # one segment per slab slot, pattern.py:1223-1248)
        B, shape = w_loc.shape[0], bk.c_full.shape[1:]
        base = bk.c_full.reshape(B, -1) if include_obj else None
        return kernels.gather_segsum(w_loc, bk.a_con2_s, bk.a_val2_s,
                                     bk.bnd_a_lin2,
                                     base=base).reshape((B,) + shape)
    z = lambda L: torch.zeros((w_loc.shape[0], L),  # noqa: E731
                              dtype=w_loc.dtype, device=w_loc.device)
    if bk.diag_ident:
        W_d = bk.a_val_d * w_loc         # row i == constraint i
        if include_obj:
            return bk.c_diag + W_d, bk.c_off + z(bk.Ko)
        return W_d, z(bk.Ko)
    if bk.has_diag_a:
        W_d = kernels.gather_segsum(
            w_loc, bk.a_con_d_s, bk.a_val_d_s, bk.bnd_a_row_d_s,
            base=bk.c_diag if include_obj else None)
    else:
        W_d = bk.c_diag + z(bk.n) if include_obj else z(bk.n)
    if bk.has_off_a:
        W_o = kernels.gather_segsum(
            w_loc, bk.a_con_o_s, bk.a_val_o_s, bk.bnd_a_pos_o_s,
            base=bk.c_off if include_obj else None)
    else:
        W_o = bk.c_off + z(bk.Ko) if include_obj else z(bk.Ko)
    return W_d, W_o


def _unit_totals(units):
    """(staged, sparse) units over a bucket's blocks."""
    return (sum(u[0] for u in units), sum(u[1] for u in units))


def bucket_tiles(f, kind: str) -> kernels.Tiles:
    """K6's ("off") or K5's ("sym") schedule, as kernels.Tiles, from the
    fields of a bucket (or of anything that carries tile_fields'
    names)."""
    fs = [getattr(f, f"{kind}_tile_{k}") for k in TILE_FIELDS[kind]]
    size = ((kernels.ADJ_TILE, kernels.ADJ_TILE) if kind == "off"
            else (kernels.WMUL_STRIP, kernels.WMUL_COLS))
    return kernels.checked_tiles(kernels.Tiles(
        *fs, *[None] * (7 - len(fs)), *size,
        *_unit_totals(getattr(f, f"{kind}_tile_units"))))


def w_mul(bk, W, X: torch.Tensor) -> torch.Tensor:
    """W @ X [B, n, r] for a build_w output: torch.matmul on dense
    buckets (pattern.py:1326-1329), else kernel K5
    (pattern.py:1330-1347): one pass over the full-symmetric row-sorted
    entry list, each entry reading its W_o slot."""
    if bk.rowshard:
        # the row-distributed dsymm: disjoint row slabs of W @ X,
        # gathered to [1, n, r] (pattern.py:1317-1324)
        return _unslab(bk, torch.matmul(W, X[0]))
    if bk.dense:
        return torch.matmul(W, X)
    W_d, W_o = W
    return _reduce(bk, kernels.wmul_csr(
        _expand(bk, X).contiguous(), W_d.contiguous(), W_o.contiguous(),
        bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows,
        tiles=bk.sym_tiles), "w_mul")


def densify_w(bk, W) -> torch.Tensor:
    """A split build_w output as full symmetric [B, n, n] matrices
    (certificate-time only, for the exact-eigh branch); dense buckets'
    W is already full."""
    if bk.dense:
        raise ValueError("densify_w is for sparse-mode buckets")
    W_d, W_o = W
    out = torch.diag_embed(W_d)
    if bk.has_off:
        rows, cols = bk.off_rows.long(), bk.off_cols.long()
        for b in range(out.shape[0]):
            # pad slots carry zero values, so their additions are no-ops
            out[b].index_put_((rows[b], cols[b]), W_o[b], accumulate=True)
            out[b].index_put_((cols[b], rows[b]), W_o[b], accumulate=True)
    return out


def a_adj_a(bk: BucketData, X: torch.Tensor, F: torch.Tensor):
    """W = A^*(A(sym(X F^T))) for buckets whose off constraint entries
    own distinct slots (bk.a_off_unique; pattern.py:1476-1506, which
    takes sym(X F^T) from uvt_half_cached): the off plane is the static
    scale a2_off of sym(X F^T)_o, one launch of kernel K6 from (X, F);
    diagonal constraints compose through constraint space with two K4
    launches.  Returns (W_d, W_o)."""
    d, W_o = kernels.adj_a_offdiag(X.contiguous(), F.contiguous(),
                                   bk.off_rows, bk.off_cols, bk.a2_off,
                                   want_diag=bk.has_diag_a,
                                   tiles=bk.off_tiles)
    if not bk.has_diag_a:
        return torch.zeros((X.shape[0], bk.n), dtype=X.dtype,
                           device=X.device), W_o
    vals = kernels.gather_segsum(d, bk.a_row_d, bk.a_val_d, bk.bnd_a_con_d)
    W_d = kernels.gather_segsum(vals, bk.a_con_d_s, bk.a_val_d_s,
                                bk.bnd_a_row_d_s)
    return W_d, W_o


def a_adj_a_dense(bk: DenseBucketData, X_full: torch.Tensor):
    """W = A^*(A(X)) [B, n, n] for dense buckets whose constraints are
    each single-entry or diagonal-only (bk.a_single_dense;
    pattern.py:1458-1473), X_full = sym(x F^T): the single-entry part
    is the static plane a2_full .* X, the diagonal-only constraints
    (theta's trace) compose through constraint space with two K4 sums
    over layout (iii), and kernel K7a writes a2_full .* X + diag(W_d)
    in one pass."""
    W_d = None
    if bk.nnz_dd:
        d = torch.diagonal(X_full, dim1=1, dim2=2).contiguous()
        vals = kernels.gather_segsum(d, bk.dd_row_cs, bk.dd_val_cs,
                                     bk.bnd_dd_con)
        W_d = kernels.gather_segsum(vals, bk.dd_con_rs, bk.dd_val_rs,
                                    bk.bnd_dd_row)
    return kernels.adj_a_dense(X_full.contiguous(), bk.a2_full, W_d)


def cmul(bk: BucketData, X: torch.Tensor,
         include_diag: bool = True) -> torch.Tensor:
    """C @ X [B, n, r] over the full-symmetric row-sorted entry list --
    kernel K2 (pattern.py:1509-1550).  The fused kernel never writes the
    [Ks, r] product, so the TPU version's entry chunking is gone."""
    return _reduce(bk, kernels.cmul_csr(
        _expand(bk, X).contiguous(), bk.c_diag if include_diag else None,
        bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows), "cmul")


# ---------------------------------------------------------------------------
# The cached forms.  lorads_tpu keeps gathered pattern rows of the ALM
# and ADMM factors (X[off_rows], X[off_cols], a column-order mirror) and
# advances them by tau * D, because its scatters at unsorted ids are
# slow.  The port's fused SDDMM kernels stage the rows of a tile in
# shared memory, or read them from L2, so there is no cache: the names
# stay and every form computes from the factors.
# ---------------------------------------------------------------------------

def gather_cache(bk: BucketData, X: torch.Tensor):
    """No gathered-row cache (see above)."""
    return None


def uvt_from_cache(bk: BucketData, R: torch.Tensor, cache):
    """sym(RR^T) pattern values (pattern.py:1417-1422)."""
    return uvt(bk, R, R)


def uvt_pair_cached(bk: BucketData, R: torch.Tensor, D: torch.Tensor,
                    cache):
    """uvt_pair and D's (absent) cache (pattern.py:1425-1440)."""
    return uvt_pair(bk, R, D), None


def uvt_half_cached(bk: BucketData, X: torch.Tensor, F: torch.Tensor,
                    fcache):
    """sym(X F^T) pattern values (pattern.py:1443-1455)."""
    return uvt(bk, X, F)


def w_mul_cached(bk: BucketData, W, X: torch.Tensor, cache):
    """w_mul (pattern.py:1553-1573)."""
    return w_mul(bk, W, X)
