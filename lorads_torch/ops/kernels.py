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

and the probes' kernels, whose wrappers live in ``lorads_torch/probes``
(no solver module calls them; ``python -m lorads_torch.probes`` does):

| wrapper                 | CUDA source          | replaces (tools/probes/)              |
|-------------------------|----------------------|---------------------------------------|
| onehot.sorted_scatter   | csrc/onehot_mma.cu   | onehot.py: sorted_scatter and the one-hot window scatters (P1) |
| onehot.sorted_gather    | csrc/onehot_mma.cu   | onehot.py: sorted_gather (P2)         |
| gather.row_gather       | csrc/row_gather.cu   | the Pallas row / transposed / scalar gathers (P3) |
| gather.scatter_add      | csrc/scatter_add.cu  | microbench_gather9.py: fC (P4)        |

Each wrapper checks its arguments, then takes the plain PyTorch version
(written with ``index_select`` / ``index_add_``) for CPU tensors, and
for CUDA tensors launches the kernel on the current stream or raises;
there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches per wrapper (plain-version calls are not counted).

Plain-version precision: f64 sums directly.  At f32 the segment sums
(K1, K2, K4, K5) accumulate in f64 and round once, which bounds their
error by the compensated kernels' eps32 contract; the row dots of K3,
K3p and K6 (r terms each) sum in f32, as lorads_tpu's do.  K7a rounds
its product and its diagonal sum separately, as its plain version
does, so the two agree bit for bit.  K8c's plain version sums each
column's terms in the kernel's lane order (32 partial sums, then the
shuffle tree), so the two agree bit for bit too.
"""

from __future__ import annotations

import torch

KERNEL_NAMES = ("segment_sum", "cmul_csr", "uvt_split", "uvt_pair_split",
                "gather_segsum", "wmul_csr", "adj_a_offdiag",
                "adj_a_dense", "lp_gs_sweep", "onehot_scatter",
                "onehot_gather", "row_gather", "scatter_add")
LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    LAUNCHES[name] += 1


def _is_f64(t):
    return int(t.dtype == torch.float64)


def _take_rows(X, idx):
    """X [B, n, ...] at rows idx [B, K] -> [B, K, ...]."""
    return torch.stack([X[b].index_select(0, idx[b].long())
                        for b in range(X.shape[0])])


def _ptr(t):
    return t.data_ptr() if t is not None else None


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
    _launch("cmul_csr", "lt_cmul", _is_f64(X), X.data_ptr(),
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
                   cols: torch.Tensor):
    """K3p.  R, D [B, n, r]; rows, cols int32 [B, Ko] ->
    (rd_d, rd_o, dd_d, dd_o): rowsum(R*D) and rowsum(D*D) [B, n],
    sym(RD^T) and DD^T at (rows, cols) [B, Ko]."""
    B, n, r = R.shape
    Ko = rows.shape[1]
    if D.shape != R.shape or cols.shape != rows.shape \
            or rows.shape[0] != B:
        raise ValueError("uvt_pair_split: inconsistent shapes")
    if not _check("uvt_pair_split", [R, D], [rows, cols]):
        return uvt_pair_split_plain(R, D, rows, cols)
    rd_d, dd_d = (torch.empty((B, n), dtype=R.dtype, device=R.device)
                  for _ in range(2))
    rd_o, dd_o = (torch.empty((B, Ko), dtype=R.dtype, device=R.device)
                  for _ in range(2))
    _launch("uvt_pair_split", "lt_uvt_pair", _is_f64(R), R.data_ptr(),
            D.data_ptr(), rows.data_ptr(), cols.data_ptr(), rd_d.data_ptr(),
            rd_o.data_ptr(), dd_d.data_ptr(), dd_o.data_ptr(), B, n, Ko, r)
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
    _launch("gather_segsum", "lt_gather_segsum", _is_f64(x), x.data_ptr(),
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
             bnd: torch.Tensor) -> torch.Tensor:
    """K5.  X [B, n, r]; W_d [B, n]; W_o [B, Ko]; slots (-1: padding)
    and cols int32 [B, Ks] sorted by row; bnd int32 [B, n+1] row
    pointers -> W @ X [B, n, r]."""
    B, n, r = X.shape
    Ko, Ks = W_o.shape[1], cols.shape[1]
    if (slots.shape != cols.shape or cols.shape[0] != B
            or W_d.shape != (B, n) or W_o.shape[0] != B
            or bnd.shape != (B, n + 1)):
        raise ValueError("wmul_csr: inconsistent shapes")
    if not _check("wmul_csr", [X, W_d, W_o], [slots, cols, bnd]):
        return wmul_csr_plain(X, W_d, W_o, slots, cols, bnd)
    out = torch.empty_like(X)
    _launch("wmul_csr", "lt_wmul", _is_f64(X), X.data_ptr(),
            W_d.data_ptr(), W_o.data_ptr(), slots.data_ptr(),
            cols.data_ptr(), bnd.data_ptr(), out.data_ptr(), B, n, Ko, Ks, r)
    return out


# ---------------------------------------------------------------------------
# K6: a2 .* sym(X F^T) on the off pattern (+ the diagonal rowsum(X*F)).
# ---------------------------------------------------------------------------

def adj_a_offdiag_plain(X, F, rows, cols, a2, want_diag):
    d, o = uvt_split_plain(X, F, rows, cols)
    return (d if want_diag else None), a2 * o


def adj_a_offdiag(X: torch.Tensor, F: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, a2: torch.Tensor,
                  want_diag: bool = False):
    """K6.  X, F [B, n, r]; rows, cols int32 [B, Ko]; a2 [B, Ko] ->
    (rowsum(X*F) [B, n] or None, a2 * sym(XF^T) at (rows, cols)
    [B, Ko])."""
    B, n, r = X.shape
    Ko = rows.shape[1]
    if (F.shape != X.shape or cols.shape != rows.shape
            or rows.shape[0] != B or a2.shape != rows.shape):
        raise ValueError("adj_a_offdiag: inconsistent shapes")
    if not _check("adj_a_offdiag", [X, F, a2], [rows, cols]):
        return adj_a_offdiag_plain(X, F, rows, cols, a2, want_diag)
    d = (torch.empty((B, n), dtype=X.dtype, device=X.device)
         if want_diag else None)
    W_o = torch.empty((B, Ko), dtype=X.dtype, device=X.device)
    _launch("adj_a_offdiag", "lt_adj_a_offdiag", _is_f64(X), X.data_ptr(),
            F.data_ptr(), rows.data_ptr(), cols.data_ptr(), a2.data_ptr(),
            _ptr(d), W_o.data_ptr(), B, n, Ko, r)
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
    _launch("adj_a_dense", "lt_adj_a_dense", _is_f64(X), X.data_ptr(),
            a2.data_ptr(), _ptr(W_d), out.data_ptr(), B, n)
    return out


# ---------------------------------------------------------------------------
# K8c: the Gauss-Seidel sweep over the LP columns.
# ---------------------------------------------------------------------------

def lp_gs_sweep_plain(pc_con, pc_val, obj, nrm2, upd, fixed, csum, rhs, dual,
                      rho):
    """A Python loop over the columns, in the kernel's order of
    operations: each lane l of 32 sums the terms k = l, l+32, ... in
    order, the partial sums combine as the shuffle tree does, and the
    deltas are added one per constraint slot."""
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
        nj = (-m2 / rho_t) / (1.0 + nr * v * v)
        new[j] = nj
        csum.index_add_(0, con[ok], pc_val[j][ok] * (nj - u) * v)
    return new, csum


def lp_gs_sweep(pc_con: torch.Tensor, pc_val: torch.Tensor,
                obj: torch.Tensor, nrm2: torch.Tensor, upd: torch.Tensor,
                fixed: torch.Tensor, csum: torch.Tensor, rhs: torch.Tensor,
                dual: torch.Tensor, rho: float):
    """K8c.  pc_con int32 [n, L] (padding ids = m) and pc_val [n, L]: the
    columns' padded entries; obj, nrm2 (||a_j||^2), upd (u), fixed (v)
    [n]; csum, rhs, dual [m] -> (new u [n], csum after the sweep [m]).
    ``csum`` itself is not modified."""
    n, L = pc_con.shape
    m = csum.shape[0]
    if (pc_val.shape != pc_con.shape or rhs.shape != (m,)
            or dual.shape != (m,)
            or any(t.shape != (n,) for t in (obj, nrm2, upd, fixed))):
        raise ValueError("lp_gs_sweep: inconsistent shapes")
    if not _check("lp_gs_sweep", [csum, pc_val, obj, nrm2, upd, fixed, rhs,
                                  dual], [pc_con]):
        return lp_gs_sweep_plain(pc_con, pc_val, obj, nrm2, upd, fixed,
                                 csum, rhs, dual, float(rho))
    out_sum = csum.clone()
    new = torch.empty_like(upd)
    _launch("lp_gs_sweep", "lt_lp_gs_sweep", _is_f64(csum), pc_con.data_ptr(),
            pc_val.data_ptr(), obj.data_ptr(), nrm2.data_ptr(),
            upd.data_ptr(), fixed.data_ptr(), out_sum.data_ptr(),
            rhs.data_ptr(), dual.data_ptr(), new.data_ptr(), n, L, m,
            float(rho))
    return new, out_sum
