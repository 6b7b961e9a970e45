"""SDPA sparse-format (.dat-s) reader/writer.

Reproduces the semantics of the reference reader `LReadSDPA`
(src_semi/io/lorads_file_io.c:21-417):

* comment lines start with '*' or '"';
* line 1: m (#constraints); line 2: nBlocks; line 3: block dims where a
  NEGATIVE dim denotes the LP (diagonal) block, which must be last
  (lorads_file_io.c:139-156);
* line 4: the m RHS entries b;
* then 5-tuples ``iCon iBlk iRow iCol val``, 1-based; ``iCon == 0`` is
  the objective block F0, stored NEGATED so the solver minimizes
  <C, X> with C = -F0 (lorads_file_io.c:260-281);
* entries with |val| < 1e-12 are dropped (lorads_file_io.c:250-256);
* SDP entries are normalized to lower-triangular (row >= col after the
  swap at lorads_file_io.c:273-277).

The output is a host-side :class:`~lorads_torch.core.problem.SDPProblem`.

A copy of ``lorads_tpu/io/sdpa.py``: the C++ tokenizer
(lorads_torch/native, built with g++ on first use) reads the file and
``_from_raw`` applies the rules above as NumPy ops; without g++ (or if
the build fails) the pure-Python reader below takes the file.
``LAST_READER`` names the reader of the last file read ("native" or
"python").
"""

from __future__ import annotations

import numpy as np

from lorads_torch.core.problem import LPBlockData, SDPBlockData, SDPProblem

TINY_ENTRY_TOL = 1e-12  # lorads_file_io.c:250

# the reader that took the last file: "native" or "python"
LAST_READER = None


def _data_lines(path):
    with open(path, "r") as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in "*\"":
                continue
            yield s


def _parse_int_list(tokens):
    out = []
    for t in tokens:
        t = t.strip("{}(),'\" \t")
        if not t:
            continue
        out.append(int(float(t)))
    return out


def read_sdpa(path: str, native: bool = True) -> SDPProblem:
    """Parse an SDPA .dat-s file into an SDPProblem: the C++ tokenizer
    first (``native``), else the pure-Python reader."""
    global LAST_READER
    if native:
        problem = _read_sdpa_native(path)
        if problem is not None:
            LAST_READER = "native"
            return problem
    problem = _read_sdpa_python(path)
    LAST_READER = "python"
    return problem


def _read_sdpa_native(path: str):
    """The file through the native tokenizer, or None without it."""
    from lorads_torch import native as native_mod

    lib = native_mod.load()
    if lib is None:
        return None
    h = lib.sdpa_parse(str(path).encode())
    try:
        err = lib.sdpa_error(h)
        if err:
            raise ValueError(
                f"SDPA parse error: {err.decode()} ({path})")
        m = int(lib.sdpa_m(h))
        nb = int(lib.sdpa_n_blocks(h))
        ne = int(lib.sdpa_n_entries(h))
        dims = np.zeros(nb, dtype=np.int64)
        rhs = np.zeros(m, dtype=np.float64)
        lib.sdpa_copy_header(h, dims.ctypes.data, rhs.ctypes.data)
        con = np.zeros(ne, dtype=np.int32)
        blk = np.zeros(ne, dtype=np.int32)
        row = np.zeros(ne, dtype=np.int32)
        col = np.zeros(ne, dtype=np.int32)
        val = np.zeros(ne, dtype=np.float64)
        lib.sdpa_copy_entries(h, con.ctypes.data, blk.ctypes.data,
                              row.ctypes.data, col.ctypes.data,
                              val.ctypes.data)
    finally:
        lib.sdpa_free(h)
    return _from_raw(m, list(dims), rhs, con, blk, row, col, val)


def _from_raw(m, dims, rhs, con, blk, row, col, val) -> SDPProblem:
    """Apply the reference reader's semantic rules to raw 1-based
    5-tuples (vectorized): tiny-entry drop, objective negation, LP
    block split, lower-tri normalization, dedup."""
    keep = np.abs(val) >= TINY_ENTRY_TOL
    con, blk = con[keep], blk[keep]
    row, col, val = row[keep], col[keep], val[keep].copy()
    val[con == 0] = -val[con == 0]

    n_lp = 0
    sdp_dims = []
    for i, d in enumerate(dims):
        if d < 0:
            if i != len(dims) - 1:
                raise ValueError("LP (negative-dim) block must be last")
            n_lp = -int(d)
        else:
            sdp_dims.append(int(d))
    n_sdp = len(sdp_dims)
    lp_block_id = n_sdp + 1  # 1-based block id of the LP block

    blocks = []
    for j in range(n_sdp):
        sel = blk == (j + 1)
        r = np.maximum(row[sel], col[sel]) - 1
        c = np.minimum(row[sel], col[sel]) - 1
        blocks.append(_make_block(
            sdp_dims[j], m, con[sel].astype(np.int64),
            r.astype(np.int64), c.astype(np.int64), val[sel]))

    lp = None
    if n_lp > 0:
        sel = blk == lp_block_id
        lp = _make_lp_block(
            n_lp, m, con[sel].astype(np.int64),
            (row[sel] - 1).astype(np.int64), val[sel])

    return SDPProblem(m=m, rhs=rhs, blocks=blocks, lp=lp)


def _read_sdpa_python(path: str) -> SDPProblem:
    """Pure-Python reader (reference implementation)."""
    lines = _data_lines(path)

    m = int(next(lines).split()[0])
    n_blocks_decl = int(next(lines).split()[0])

    dims_tokens = []
    while len(dims_tokens) < n_blocks_decl:
        dims_tokens.extend(next(lines).replace(",", " ").split())
    dims = _parse_int_list(dims_tokens)
    if len(dims) != n_blocks_decl:
        raise ValueError(
            f"expected {n_blocks_decl} block dims, got {len(dims)}")

    # Negative dim => LP block; reference requires it to be last
    # (lorads_file_io.c:121-128 errors on a non-final diagonal block).
    n_lp = 0
    sdp_dims = []
    for i, d in enumerate(dims):
        if d < 0:
            if i != len(dims) - 1:
                raise ValueError("LP (negative-dim) block must be last")
            n_lp = -d
        else:
            sdp_dims.append(d)
    n_sdp = len(sdp_dims)
    lp_block_id = n_sdp  # 0-based block id of the LP block, if any

    rhs_tokens = []
    while len(rhs_tokens) < m:
        rhs_tokens.extend(next(lines).replace(",", " ").split())
    rhs = np.array([float(t) for t in rhs_tokens[:m]], dtype=np.float64)

    # Accumulate triplets per block.
    sdp_con = [[] for _ in range(n_sdp)]
    sdp_row = [[] for _ in range(n_sdp)]
    sdp_col = [[] for _ in range(n_sdp)]
    sdp_val = [[] for _ in range(n_sdp)]
    lp_con, lp_idx, lp_val = [], [], []

    for s in lines:
        if s.startswith("BEGIN.COMMENT"):
            break
        parts = s.replace(",", " ").split()
        if len(parts) < 5:
            continue
        icon = int(float(parts[0]))
        iblk = int(float(parts[1])) - 1
        irow = int(float(parts[2])) - 1
        icol = int(float(parts[3])) - 1
        val = float(parts[4])
        if abs(val) < TINY_ENTRY_TOL:
            continue
        if icon == 0:
            val = -val  # objective negated (lorads_file_io.c:260-262, 279-281)
        if n_lp > 0 and iblk == lp_block_id:
            # diagonal block: row index is the LP column
            lp_con.append(icon)
            lp_idx.append(irow)
            lp_val.append(val)
        else:
            if irow > icol:
                irow, icol = icol, irow
            # store lower-tri: row >= col
            sdp_con[iblk].append(icon)
            sdp_row[iblk].append(icol)
            sdp_col[iblk].append(irow)
            sdp_val[iblk].append(val)

    blocks = []
    for j in range(n_sdp):
        blocks.append(
            _make_block(
                sdp_dims[j],
                m,
                np.asarray(sdp_con[j], dtype=np.int64),
                np.asarray(sdp_row[j], dtype=np.int64),
                np.asarray(sdp_col[j], dtype=np.int64),
                np.asarray(sdp_val[j], dtype=np.float64),
            )
        )

    lp = None
    if n_lp > 0:
        lp = _make_lp_block(
            n_lp,
            m,
            np.asarray(lp_con, dtype=np.int64),
            np.asarray(lp_idx, dtype=np.int64),
            np.asarray(lp_val, dtype=np.float64),
        )

    return SDPProblem(m=m, rhs=rhs, blocks=blocks, lp=lp)


def _dedup(keys: np.ndarray, vals: np.ndarray):
    """Sum duplicate entries sharing the same composite key."""
    if keys.size == 0:
        return keys, vals
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    vals = vals[order]
    uniq, start = np.unique(keys, return_index=True)
    summed = np.add.reduceat(vals, start)
    return uniq, summed


def _make_block(dim, m, con, row, col, val) -> SDPBlockData:
    # Deduplicate (con,row,col) summing values.
    key = (con * dim + row) * dim + col
    key, val = _dedup(key, val)
    col = key % dim
    row = (key // dim) % dim
    con = key // (dim * dim)

    is_obj = con == 0
    return SDPBlockData(
        dim=int(dim),
        m=int(m),
        obj_row=row[is_obj].astype(np.int32),
        obj_col=col[is_obj].astype(np.int32),
        obj_val=val[is_obj],
        a_con=(con[~is_obj] - 1).astype(np.int32),
        a_row=row[~is_obj].astype(np.int32),
        a_col=col[~is_obj].astype(np.int32),
        a_val=val[~is_obj],
    )


def _make_lp_block(n_lp, m, con, idx, val) -> LPBlockData:
    key = con * n_lp + idx
    key, val = _dedup(key, val)
    idx = key % n_lp
    con = key // n_lp
    is_obj = con == 0
    c = np.zeros(n_lp, dtype=np.float64)
    np.add.at(c, idx[is_obj], val[is_obj])
    return LPBlockData(
        n_cols=int(n_lp),
        m=int(m),
        obj=c,
        a_con=(con[~is_obj] - 1).astype(np.int32),
        a_col=idx[~is_obj].astype(np.int32),
        a_val=val[~is_obj],
    )


def write_sdpa(path: str, problem: SDPProblem) -> None:
    """Write an SDPProblem back to .dat-s (inverse of read_sdpa).

    Objective entries are re-negated on write so that a round trip is the
    identity, and the file is consumable by the reference LoRADS binary.
    """
    nblk = len(problem.blocks) + (1 if problem.lp is not None else 0)
    with open(path, "w") as f:
        f.write(f"{problem.m}\n{nblk}\n")
        dims = [str(b.dim) for b in problem.blocks]
        if problem.lp is not None:
            dims.append(str(-problem.lp.n_cols))
        f.write(" ".join(dims) + "\n")
        f.write(" ".join(f"{x:.17g}" for x in problem.rhs) + "\n")
        for j, b in enumerate(problem.blocks, start=1):
            for r, c, v in zip(b.obj_row, b.obj_col, b.obj_val):
                f.write(f"0 {j} {r + 1} {c + 1} {-v:.17g}\n")
            for i, r, c, v in zip(b.a_con, b.a_row, b.a_col, b.a_val):
                f.write(f"{i + 1} {j} {r + 1} {c + 1} {v:.17g}\n")
        if problem.lp is not None:
            jb = nblk
            for k, v in enumerate(problem.lp.obj):
                if v != 0.0:
                    f.write(f"0 {jb} {k + 1} {k + 1} {-v:.17g}\n")
            for i, k, v in zip(problem.lp.a_con, problem.lp.a_col,
                               problem.lp.a_val):
                f.write(f"{i + 1} {jb} {k + 1} {k + 1} {v:.17g}\n")
