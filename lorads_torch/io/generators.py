"""Benchmark/test instance generators.

The reference repo ships no test data; its benchmark suite (Max-Cut
G-set, Lovász theta, matrix completion — README.md:148-151,
arXiv:2403.09133) is external.  These generators produce the same
problem families directly as :class:`SDPProblem` (and via
``write_sdpa`` as .dat-s files consumable by the reference binary).
"""

from __future__ import annotations

import numpy as np

from lorads_torch.core.problem import LPBlockData, SDPBlockData, SDPProblem


def _coo_dedup(rows, cols, vals, dim):
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    r = np.maximum(rows, cols)
    c = np.minimum(rows, cols)
    key = r * dim + c
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq, start = np.unique(key, return_index=True)
    vals = np.add.reduceat(vals, start)
    return (uniq // dim).astype(np.int32), (uniq % dim).astype(np.int32), vals


def _random_graph(n, avg_degree, seed, weighted=False):
    rng = np.random.default_rng(seed)
    n_edges = int(n * avg_degree / 2)
    i = rng.integers(0, n, size=2 * n_edges)
    j = rng.integers(0, n, size=2 * n_edges)
    keep = i != j
    i, j = i[keep], j[keep]
    a, b = np.maximum(i, j), np.minimum(i, j)
    key = np.unique(a.astype(np.int64) * n + b)[:n_edges]
    a, b = (key // n).astype(np.int32), (key % n).astype(np.int32)
    if weighted:
        w = rng.choice([-1.0, 1.0], size=a.size)
    else:
        w = np.ones(a.size)
    return a, b, w


def maxcut(n: int = 800, avg_degree: float = 6.0, seed: int = 0,
           weighted: bool = False) -> SDPProblem:
    """Max-Cut SDP:  min <-L/4, X>  s.t.  X_ii = 1, X PSD.

    G-set-like instances (the reference's headline benchmark family).
    """
    a, b, w = _random_graph(n, avg_degree, seed, weighted)
    # Laplacian L = D - W ;  C = -L/4
    rows = np.concatenate([np.arange(n), a])
    cols = np.concatenate([np.arange(n), b])
    deg = np.zeros(n)
    np.add.at(deg, a, w)
    np.add.at(deg, b, w)
    vals = np.concatenate([-deg / 4.0, w / 4.0])
    orow, ocol, oval = _coo_dedup(rows, cols, vals, n)
    keep = oval != 0.0
    blk = SDPBlockData(
        dim=n, m=n,
        obj_row=orow[keep], obj_col=ocol[keep], obj_val=oval[keep],
        a_con=np.arange(n, dtype=np.int32),
        a_row=np.arange(n, dtype=np.int32),
        a_col=np.arange(n, dtype=np.int32),
        a_val=np.ones(n),
    )
    return SDPProblem(m=n, rhs=np.ones(n), blocks=[blk])


def lovasz_theta(n: int = 100, avg_degree: float = 8.0,
                 seed: int = 0) -> SDPProblem:
    """Lovász theta:  max <J, X>  s.t.  X_ij = 0 (ij in E), tr X = 1.

    As a minimization: C = -J (dense objective, sparse constraints).
    """
    a, b, _ = _random_graph(n, avg_degree, seed)
    n_e = a.size
    orow, ocol = np.tril_indices(n)
    blk = SDPBlockData(
        dim=n, m=n_e + 1,
        obj_row=orow.astype(np.int32), obj_col=ocol.astype(np.int32),
        obj_val=-np.ones(orow.size),
        a_con=np.concatenate([np.arange(n_e),
                              np.full(n, n_e)]).astype(np.int32),
        a_row=np.concatenate([a, np.arange(n)]).astype(np.int32),
        a_col=np.concatenate([b, np.arange(n)]).astype(np.int32),
        a_val=np.concatenate([np.full(n_e, 0.5), np.ones(n)]),
    )
    rhs = np.zeros(n_e + 1)
    rhs[n_e] = 1.0
    return SDPProblem(m=n_e + 1, rhs=rhs, blocks=[blk])


def matrix_completion(n1: int = 60, n2: int = 60, true_rank: int = 3,
                      frac_obs: float = 0.3, seed: int = 0) -> SDPProblem:
    """Nuclear-norm matrix completion SDP.

    min tr(X)  s.t.  X[i, n1+j] = M_ij for observed (i,j), X PSD,
    with X = [[W1, Z], [Z^T, W2]] of dim n1+n2.
    """
    rng = np.random.default_rng(seed)
    M = (rng.standard_normal((n1, true_rank))
         @ rng.standard_normal((true_rank, n2)))
    obs = rng.random((n1, n2)) < frac_obs
    oi, oj = np.nonzero(obs)
    m = oi.size
    n = n1 + n2
    blk = SDPBlockData(
        dim=n, m=m,
        obj_row=np.arange(n, dtype=np.int32),
        obj_col=np.arange(n, dtype=np.int32),
        obj_val=np.ones(n),
        a_con=np.arange(m, dtype=np.int32),
        a_row=(n1 + oj).astype(np.int32),
        a_col=oi.astype(np.int32),
        a_val=np.full(m, 0.5),
    )
    return SDPProblem(m=m, rhs=M[oi, oj], blocks=[blk])


def random_multiblock(n_blocks: int = 4, dim: int = 20, m: int = 30,
                      density: float = 0.3, n_lp: int = 0,
                      seed: int = 0) -> SDPProblem:
    """Random feasible BOUNDED multi-block SDP (+ optional LP block).

    Feasibility by construction: b = A(X0) for a random PSD X0 (and
    positive LP part), so the instance has a strictly feasible point.
    Boundedness by construction: each block objective is shifted by
    (|lambda_min| + 1) I so C is positive definite (then <C,X> >=
    lambda_min(C) tr X >= 0 on the PSD cone), and LP costs are strictly
    positive.
    """
    rng = np.random.default_rng(seed)
    blocks = []
    consts = []
    for _ in range(n_blocks):
        rows, cols, vals, cons = [], [], [], []
        orow, ocol, oval = [], [], []
        # random symmetric sparse objective
        for r in range(dim):
            for c in range(r + 1):
                if rng.random() < density:
                    orow.append(r)
                    ocol.append(c)
                    oval.append(rng.standard_normal())
        # PSD shift on the diagonal to make the instance bounded
        orow0, ocol0, oval0 = _coo_dedup(orow, ocol, oval, dim)
        Cd = np.zeros((dim, dim))
        Cd[orow0, ocol0] = oval0
        Cd = Cd + Cd.T - np.diag(np.diag(Cd))
        shift = abs(float(np.linalg.eigvalsh(Cd)[0])) + 1.0
        orow, ocol, oval = _coo_dedup(
            np.concatenate([orow0, np.arange(dim)]),
            np.concatenate([ocol0, np.arange(dim)]),
            np.concatenate([oval0, np.full(dim, shift)]), dim)
        orow, ocol, oval = list(orow), list(ocol), list(oval)
        for i in range(m):
            for r in range(dim):
                for c in range(r + 1):
                    if rng.random() < density:
                        cons.append(i)
                        rows.append(r)
                        cols.append(c)
                        vals.append(rng.standard_normal())
        blk = SDPBlockData(
            dim=dim, m=m,
            obj_row=np.array(orow, dtype=np.int32),
            obj_col=np.array(ocol, dtype=np.int32),
            obj_val=np.array(oval, dtype=np.float64),
            a_con=np.array(cons, dtype=np.int32),
            a_row=np.array(rows, dtype=np.int32),
            a_col=np.array(cols, dtype=np.int32),
            a_val=np.array(vals, dtype=np.float64),
        )
        blocks.append(blk)
        R0 = rng.standard_normal((dim, 3))
        X0 = R0 @ R0.T / 3.0
        consts.append(np.array([np.sum(blk.dense_constr(i) * X0)
                                for i in range(m)]))
    rhs = np.sum(consts, axis=0)

    lp = None
    if n_lp > 0:
        cons, colids, vals = [], [], []
        for j in range(n_lp):
            for i in range(m):
                if rng.random() < 0.5:
                    cons.append(i)
                    colids.append(j)
                    vals.append(rng.standard_normal())
        lp = LPBlockData(
            n_cols=n_lp, m=m,
            obj=np.abs(rng.standard_normal(n_lp)) + 0.1,
            a_con=np.array(cons, dtype=np.int32),
            a_col=np.array(colids, dtype=np.int32),
            a_val=np.array(vals, dtype=np.float64),
        )
        x0 = rng.random(n_lp) + 0.1
        rhs = rhs + lp.dense_matrix() @ x0

    return SDPProblem(m=m, rhs=rhs, blocks=blocks, lp=lp)


def read_graph(path: str):
    """Read a rudy/G-set-format graph file.

    Format (the G-set distribution, e.g. web.stanford.edu/~yyye/yyye/Gset):
    a header line ``n_vertices n_edges`` followed by one ``i j w`` line
    per edge, vertices 1-based; ``w`` optional (default 1).  Returns
    (n, a, b, w) with 0-based int32 endpoint arrays.
    """
    with open(path) as fh:
        first = fh.readline().split()
        n = int(first[0])
        rows, cols, vals = [], [], []
        for line in fh:
            parts = line.split()
            if len(parts) < 2:
                continue
            i, j = int(parts[0]), int(parts[1])
            w = float(parts[2]) if len(parts) > 2 else 1.0
            if i == j:
                continue
            rows.append(i - 1)
            cols.append(j - 1)
            vals.append(w)
    a = np.asarray(rows, dtype=np.int32)
    b = np.asarray(cols, dtype=np.int32)
    w = np.asarray(vals, dtype=np.float64)
    if a.size and (a.min() < 0 or b.min() < 0 or a.max() >= n
                   or b.max() >= n):
        raise ValueError(
            f"{path}: vertex index out of range 1..{n} "
            "(G-set files are 1-based)")
    return n, a, b, w


def maxcut_from_graph(path: str) -> SDPProblem:
    """Max-Cut SDP from a rudy/G-set graph file (see read_graph):
    min <-L/4, X> s.t. X_ii = 1, X PSD — the reference's headline
    benchmark family (README.md:148-151, arXiv:2403.09133)."""
    n, a, b, w = read_graph(path)
    rows = np.concatenate([np.arange(n), a])
    cols = np.concatenate([np.arange(n), b])
    deg = np.zeros(n)
    np.add.at(deg, a, w)
    np.add.at(deg, b, w)
    vals = np.concatenate([-deg / 4.0, w / 4.0])
    orow, ocol, oval = _coo_dedup(rows, cols, vals, n)
    keep = oval != 0.0
    blk = SDPBlockData(
        dim=n, m=n,
        obj_row=orow[keep], obj_col=ocol[keep], obj_val=oval[keep],
        a_con=np.arange(n, dtype=np.int32),
        a_row=np.arange(n, dtype=np.int32),
        a_col=np.arange(n, dtype=np.int32),
        a_val=np.ones(n),
    )
    return SDPProblem(m=n, rhs=np.ones(n), blocks=[blk])


def theta_from_graph(path: str) -> SDPProblem:
    """Lovász theta SDP from a rudy/G-set graph file (see read_graph):
    max <J, X> s.t. X_ij = 0 on edges, tr X = 1 (minimized as C=-J)."""
    n, a, b, _ = read_graph(path)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = np.unique(hi.astype(np.int64) * n + lo)
    a = (key // n).astype(np.int32)
    b = (key % n).astype(np.int32)
    n_e = a.size
    orow, ocol = np.tril_indices(n)
    blk = SDPBlockData(
        dim=n, m=n_e + 1,
        obj_row=orow.astype(np.int32), obj_col=ocol.astype(np.int32),
        obj_val=-np.ones(orow.size),
        a_con=np.concatenate([np.arange(n_e),
                              np.full(n, n_e)]).astype(np.int32),
        a_row=np.concatenate([a, np.arange(n)]).astype(np.int32),
        a_col=np.concatenate([b, np.arange(n)]).astype(np.int32),
        a_val=np.concatenate([np.full(n_e, 0.5), np.ones(n)]),
    )
    rhs = np.zeros(n_e + 1)
    rhs[n_e] = 1.0
    return SDPProblem(m=n_e + 1, rhs=rhs, blocks=[blk])


def write_graph(path: str, n: int, a, b, w=None):
    """Write a rudy/G-set-format graph file (see read_graph): header
    ``n_vertices n_edges``, then one 1-based ``i j w`` line per edge."""
    a = np.asarray(a)
    b = np.asarray(b)
    w = np.ones(a.size) if w is None else np.asarray(w)
    with open(path, "w") as fh:
        fh.write(f"{n} {a.size}\n")
        for i, j, wij in zip(a, b, w):
            wi = int(wij) if float(wij).is_integer() else wij
            fh.write(f"{int(i) + 1} {int(j) + 1} {wi}\n")


def gset_torus(nx: int = 100, ny: int = 100, seed: int = 0):
    """G-set torus-class Max-Cut graph: the 2-D toroidal grid with
    random +/-1 edge weights — the structure of the G-set's torus
    instances (G62-G67, G81; the reference README.md:148-151 names
    the G-set suite as the headline benchmark).  The REAL G-set files
    are not vendorable in this zero-egress image and rudy's exact PRNG
    stream is not reproducible offline, so the weight signs come from
    a seeded NumPy RNG: same topology (n = nx*ny nodes, 2n edges,
    4-regular), same weight distribution, not the byte-identical
    instance.  Returns (n, a, b, w) like read_graph."""
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    right = np.roll(idx, -1, axis=1)
    down = np.roll(idx, -1, axis=0)
    a = np.concatenate([idx.ravel(), idx.ravel()]).astype(np.int32)
    b = np.concatenate([right.ravel(), down.ravel()]).astype(np.int32)
    rng = np.random.default_rng(seed)
    w = rng.choice([-1.0, 1.0], size=a.size)
    return n, a, b, w
