"""The port's hand-written CUDA kernels, their wrappers and plain versions.

| wrapper        | CUDA source          | replaces (lorads_tpu/ops/pattern.py)       |
|----------------|----------------------|--------------------------------------------|
| segment_sum    | csrc/segment_sum.cu  | comp_segment_sum, single_segment_sum (K1)  |
| cmul_csr       | csrc/cmul.cu         | cmul (K2)                                  |
| uvt_split      | csrc/uvt.cu          | uvt, split branch (K3)                     |

Each wrapper checks its arguments, then takes the plain PyTorch version
(written with ``index_select`` / ``index_add_``) for CPU tensors, and
for CUDA tensors launches the kernel on the current stream or raises;
there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches per wrapper (plain-version calls are not counted).

Plain-version precision: f64 sums directly; f32 accumulates in f64 and
rounds once, which bounds its error by the compensated kernels' eps32
contract.
"""

from __future__ import annotations

import torch

KERNEL_NAMES = ("segment_sum", "cmul_csr", "uvt_split")
LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, floats, ints):
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
    LAUNCHES[name] += 1


def _is_f64(t):
    return int(t.dtype == torch.float64)


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
    _launch("segment_sum", "lt_segment_sum", _is_f64(data),
            data.data_ptr(), bounds.data_ptr(), out.data_ptr(), B, N, S, r)
    return out


# ---------------------------------------------------------------------------
# K2: C @ X over the full-symmetric row-sorted entry list.
# ---------------------------------------------------------------------------

def cmul_csr_plain(X, c_diag, cols, vals, bnd):
    B, n, r = X.shape
    Xg = torch.stack([X[b].index_select(0, cols[b].long())
                      for b in range(B)])                      # [B, Ks, r]
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
    _launch("cmul_csr", "lt_cmul", _is_f64(X), X.data_ptr(),
            c_diag.data_ptr() if c_diag is not None else None,
            cols.data_ptr(), vals.data_ptr(), bnd.data_ptr(),
            out.data_ptr(), B, n, Ks, r)
    return out


# ---------------------------------------------------------------------------
# K3: sym(U V^T) on the split pattern (diagonal + strictly-lower entries).
# ---------------------------------------------------------------------------

def uvt_split_plain(U, V, rows, cols):
    B = U.shape[0]
    d = torch.sum(U * V, -1)

    def take(X, idx):
        return torch.stack([X[b].index_select(0, idx[b].long())
                            for b in range(B)])

    ur, vc = take(U, rows), take(V, cols)
    uc, vr = take(U, cols), take(V, rows)
    o = 0.5 * (torch.sum(ur * vc, -1) + torch.sum(uc * vr, -1))
    return d, o


def uvt_split(U: torch.Tensor, V: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor):
    """K3.  U, V [B, n, r]; rows, cols int32 [B, Ko] ->
    (d [B, n] = rowsum(U*V), o [B, Ko] = sym(UV^T) at (rows, cols))."""
    B, n, r = U.shape
    Ko = rows.shape[1]
    if V.shape != U.shape or cols.shape != rows.shape \
            or rows.shape[0] != B:
        raise ValueError("uvt_split: inconsistent shapes")
    if not _check("uvt_split", [U, V], [rows, cols]):
        return uvt_split_plain(U, V, rows, cols)
    d = torch.empty((B, n), dtype=U.dtype, device=U.device)
    o = torch.empty((B, Ko), dtype=U.dtype, device=U.device)
    _launch("uvt_split", "lt_uvt_split", _is_f64(U), U.data_ptr(),
            V.data_ptr(), rows.data_ptr(), cols.data_ptr(), d.data_ptr(),
            o.data_ptr(), B, n, Ko, r)
    return d, o
