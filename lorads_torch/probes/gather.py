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

Ids are int32 and values float32, as in the probes.  Ids out of
[0, n) raise in the wrapper (one host read of their range; pass
``check=False`` for ids already checked), never in the kernel.  The
plain versions are ``index_select`` and ``index_add_`` (f64
accumulation, rounded once); CPU tensors take them, CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import math

import torch

from lorads_torch.ops.kernels import _check, _launch


def _check_ids(name, ids, n):
    if ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0 or hi >= n:
            raise IndexError(f"{name}: ids in [{lo}, {hi}], table of {n}")


# ---------------------------------------------------------------------------
# P3: unsorted row gather.
# ---------------------------------------------------------------------------

def row_gather_plain(X, ids, layout="kr"):
    if X.dim() == 1 or layout == "kr":
        return X.index_select(0, ids.long())
    return X.index_select(1, ids.long())


def row_gather(X: torch.Tensor, ids: torch.Tensor, layout="kr",
               check=True) -> torch.Tensor:
    """P3.  X f32 [n, r] ("kr") -> X[ids] [K, r]; X [r, n] ("rk") ->
    X[:, ids] [r, K]; a 1-D X [n] -> X[ids] [K] (layout ignored)."""
    if layout not in ("kr", "rk"):
        raise ValueError(f"row_gather: layout {layout!r}")
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
    _launch("row_gather", "lt_row_gather", int(rk), X.data_ptr(),
            ids.data_ptr(), out.data_ptr(), n, K, r)
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
    [K] -> [n, r] or [n].  The kernel adds with f32 atomics in no fixed
    order, so two runs may differ in the last bits."""
    if vals.dtype != torch.float32 or vals.dim() not in (1, 2) \
            or ids.shape != vals.shape[:1]:
        raise TypeError("scatter_add: vals float32 [K] or [K, r], ids [K]")
    cuda = _check("scatter_add", [vals], [ids])
    if check:
        _check_ids("scatter_add", ids, n)
    if not cuda:
        return scatter_add_plain(vals, ids, n)
    r = 1 if vals.dim() == 1 else vals.shape[1]
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=vals.device)
    _launch("scatter_add", "lt_scatter_add", vals.data_ptr(), ids.data_ptr(),
            out.data_ptr(), vals.shape[0], r)
    return out
