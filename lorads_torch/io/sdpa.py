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

A copy of ``lorads_tpu/io/sdpa.py`` without its C tokenizer fast path:
the pure-Python reader below is the only one (the native reader is
queued for a later slice of the port).
"""

from __future__ import annotations

import numpy as np

from lorads_torch.core.problem import LPBlockData, SDPBlockData, SDPProblem

TINY_ENTRY_TOL = 1e-12  # lorads_file_io.c:250


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


def read_sdpa(path: str) -> SDPProblem:
    """Parse an SDPA .dat-s file into an SDPProblem (pure Python)."""
    return _read_sdpa_python(path)


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
