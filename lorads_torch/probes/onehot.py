"""One-hot window products on the tensor cores: the sorted segment sum
(P1 ``onehot_scatter``) and the sorted row gather (P2 ``onehot_gather``).

Port of ``tools/probes/onehot.py`` (``sorted_scatter``, ``sorted_gather``
and the probes' transposed-layout variants).  When the ids are sorted,
the rows feeding a CT-wide tile of output segments (scatter), or the
source rows feeding a KT-wide tile of gathered ids (gather), lie in one
contiguous window of the other operand, and the reduction is a product
with a one-hot matrix:

    scatter:  out[CT tile, r] = onehot[CT, window] @ vals[window, r]
    gather:   out[KT tile, r] = onehot[KT, window] @ X[window, r]

The one-hot factor is exact in bf16 and a bf16 x bf16 product is exact
in f32, so splitting the f32 operand into bf16 planes (``planes``)
gives exact-f32 products in three passes ("bf16x3") or ~2^-16 relative
in two ("bf16x2").  Mode "f32" is exact-f32 products too: on the card it
runs as the bf16x3 split (the reference runs an f32 product).

The planner is a copy of the reference's, fields and refusals
included (``_BAD`` for unsorted ids or too-wide spans, ``_MAX_WT``, the
reference's VMEM cap, kept for parity of the plans).  The Hopper kernel
(``csrc/onehot_mma.cu``) does not depend on the window size: it streams
only the rows that feed each 16-wide sub-tile.

Each wrapper takes its plain PyTorch version (``index_add_`` /
``index_select`` over the same planes, f64 accumulation rounded once)
for CPU tensors and launches the kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lorads_torch.ops.kernels import _check, _launch
from lorads_torch.probes.gather import add_rows_f64

# mode -> bf16 planes on the card ("f32" runs as the bf16x3 split)
MODES = {"f32": 3, "bf16x3": 3, "bf16x2": 2}
LAYOUTS = ("kr", "rk")                          # [K, r] or [r, K] values


def _ru(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Host-built window plan for one sorted-id shape (the reference's
    fields; ``wblock`` and ``ids_pad`` on ``device``).

    ``wblock`` (int32 [n_tiles]) holds the WT-unit window block each
    output tile reads (it and its successor: coverage 2*WT); ``ids_pad``
    (int32 [K_pad, 1]) the sorted ids padded with n_pad + 7, which
    matches no segment or row."""

    ok: bool
    kind: str             # scatter | gather | none
    n: int                # segment space (scatter) / table rows (gather)
    K: int                # id count
    CT: int               # output tile (KT for a gather plan)
    WT: int               # window unit
    n_pad: int
    K_pad: int
    wblock: Optional[torch.Tensor] = None
    ids_pad: Optional[torch.Tensor] = None


_BAD = WindowPlan(ok=False, kind="none", n=0, K=0, CT=0, WT=0,
                  n_pad=0, K_pad=0)

_MAX_WT = 1 << 14   # the reference's window cap (2 x 8 MB f32 at r=128)


def plan_sorted_scatter(ids, n: int, CT: int = 256, WT: int = 0,
                        device="cuda") -> WindowPlan:
    """Plan segment_sum(vals[K, r], sorted ids) -> [n, r].

    Output tiles cover CT segments; WT=0 picks the smallest power-of-2
    window covering the worst tile (min 512)."""
    ids = np.asarray(ids)
    K = int(ids.size)
    if K == 0 or np.any(np.diff(ids) < 0):
        return _BAD
    n_pad = _ru(max(n, CT), CT)
    nt = n_pad // CT
    starts = np.searchsorted(ids, np.arange(nt) * CT)
    ends = np.searchsorted(ids, np.arange(nt) * CT + CT)
    span = int((ends - starts).max()) if nt else 0
    if WT == 0:
        WT = 512
        while WT < span:
            WT *= 2
    if span > WT or WT > _MAX_WT:
        return _BAD
    K_pad = _ru(K, WT) + WT          # spare block: wblock+1 always valid
    wblock = np.minimum(starts // WT, K_pad // WT - 2).astype(np.int32)
    ids_pad = np.full((K_pad, 1), n_pad + 7, np.int32)
    ids_pad[:K, 0] = ids
    return WindowPlan(ok=True, kind="scatter", n=n, K=K, CT=CT, WT=WT,
                      n_pad=n_pad, K_pad=K_pad,
                      wblock=torch.as_tensor(wblock, device=device),
                      ids_pad=torch.as_tensor(ids_pad, device=device))


def plan_sorted_gather(ids, n: int, KT: int = 256, WT: int = 0,
                       device="cuda") -> WindowPlan:
    """Plan X[n, r][ids] -> [K, r] for sorted ids.

    Output tiles cover KT consecutive ids; the 2*WT window (aligned to
    WT) must cover the span of source rows those ids touch."""
    ids = np.asarray(ids)
    K = int(ids.size)
    if K == 0 or np.any(np.diff(ids) < 0) or int(ids.max()) >= n:
        return _BAD
    K_pad = _ru(K, KT)
    nt = K_pad // KT
    firsts = ids[np.minimum(np.arange(nt) * KT, K - 1)]
    lasts = ids[np.minimum((np.arange(nt) + 1) * KT - 1, K - 1)]
    if WT == 0:
        WT = 512
        while WT <= _MAX_WT and not np.all(lasts < (firsts // WT + 2) * WT):
            WT *= 2
    if WT > _MAX_WT or not np.all(lasts < (firsts // WT + 2) * WT):
        return _BAD
    n_pad = _ru(n, WT) + WT
    wblock = np.minimum(firsts // WT, n_pad // WT - 2).astype(np.int32)
    ids_pad = np.full((K_pad, 1), n_pad + 7, np.int32)
    ids_pad[:K, 0] = ids
    return WindowPlan(ok=True, kind="gather", n=n, K=K, CT=KT, WT=WT,
                      n_pad=n_pad, K_pad=K_pad,
                      wblock=torch.as_tensor(wblock, device=device),
                      ids_pad=torch.as_tensor(ids_pad, device=device))


def planes(v: torch.Tensor, mode: str):
    """f32 -> bf16 planes (round to nearest even) whose sum is v exactly
    ("bf16x3") or to ~2^-16 relative ("bf16x2"); "f32" is v itself."""
    if mode == "f32":
        return (v,)
    hi = v.to(torch.bfloat16)
    rem = v - hi.float()
    if mode == "bf16x2":
        return hi, rem.to(torch.bfloat16)
    mid = rem.to(torch.bfloat16)
    lo = (rem - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _check_mode(mode, layout="kr"):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} (need one of {sorted(MODES)})")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} (need 'kr' or 'rk')")


# ---------------------------------------------------------------------------
# P1: sorted segment sum.
# ---------------------------------------------------------------------------

def sorted_scatter_plain(vals, plan: WindowPlan, mode="bf16x3",
                         layout="kr"):
    """Each plane's segment sum in f64, the planes added in order (hi,
    mid, lo), rounded once to f32."""
    v = vals if layout == "kr" else vals.T
    ids = plan.ids_pad[:plan.K, 0]
    total = None
    for p in planes(v, mode):
        part = add_rows_f64(p, ids, plan.n)
        total = part if total is None else total + part
    out = total.float()
    return out if layout == "kr" else out.T.contiguous()


def sorted_scatter(vals: torch.Tensor, plan: WindowPlan, mode="bf16x3",
                   layout="kr") -> torch.Tensor:
    """P1.  segment_sum of ``vals`` f32 [K, r] ("kr") or [r, K] ("rk") by
    the plan's sorted ids -> [n, r] or [r, n]."""
    _check_mode(mode, layout)
    if not (plan.ok and plan.kind == "scatter"):
        raise ValueError("sorted_scatter: needs an ok scatter plan")
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise TypeError("sorted_scatter: vals must be 2-D float32")
    r = vals.shape[1] if layout == "kr" else vals.shape[0]
    K = vals.shape[0] if layout == "kr" else vals.shape[1]
    if K != plan.K:
        raise ValueError(f"sorted_scatter: {K} values for {plan.K} ids")
    if not _check("onehot_scatter", [vals], [plan.ids_pad, plan.wblock]):
        return sorted_scatter_plain(vals, plan, mode, layout)
    if plan.CT % 16:
        raise ValueError(f"onehot_scatter: CT={plan.CT} (need a multiple "
                         "of 16)")
    shape = (plan.n, r) if layout == "kr" else (r, plan.n)
    out = torch.empty(shape, dtype=torch.float32, device=vals.device)
    _launch("onehot_scatter", "lt_onehot_scatter", MODES[mode],
            int(layout == "rk"), vals.data_ptr(), plan.ids_pad.data_ptr(),
            plan.wblock.data_ptr(), out.data_ptr(), plan.K, plan.n,
            plan.n_pad, r, plan.CT, plan.WT)
    return out


# ---------------------------------------------------------------------------
# P2: sorted row gather.
# ---------------------------------------------------------------------------

def sorted_gather_plain(X, plan: WindowPlan, mode="bf16x3"):
    """The gathered rows' planes added in order in f32 (each output is
    one row's planes, so the kernel agrees bit for bit)."""
    rows = X.index_select(0, plan.ids_pad[:plan.K, 0].long())
    ps = planes(rows, mode)
    out = ps[0].float()
    for p in ps[1:]:
        out = out + p.float()
    return out


def sorted_gather(X: torch.Tensor, plan: WindowPlan,
                  mode="bf16x3") -> torch.Tensor:
    """P2.  Rows of ``X`` f32 [n, r] at the plan's sorted ids -> [K, r]."""
    _check_mode(mode)
    if not (plan.ok and plan.kind == "gather"):
        raise ValueError("sorted_gather: needs an ok gather plan")
    if X.dim() != 2 or X.dtype != torch.float32:
        raise TypeError("sorted_gather: X must be 2-D float32")
    if X.shape[0] != plan.n:
        raise ValueError(f"sorted_gather: X has {X.shape[0]} rows, the "
                         f"plan {plan.n}")
    if not _check("onehot_gather", [X], [plan.ids_pad]):
        return sorted_gather_plain(X, plan, mode)
    if plan.CT % 16:
        raise ValueError(f"onehot_gather: KT={plan.CT} (need a multiple "
                         "of 16)")
    r = X.shape[1]
    out = torch.empty((plan.K, r), dtype=torch.float32, device=X.device)
    _launch("onehot_gather", "lt_onehot_gather", MODES[mode], X.data_ptr(),
            plan.ids_pad.data_ptr(), out.data_ptr(), plan.K, plan.n, r,
            plan.CT)
    return out


# ---------------------------------------------------------------------------
# Work counts (for bounds): the tensor-core flops the kernels issue.
# ---------------------------------------------------------------------------

_MMA_FLOPS = 2 * 16 * 16 * 8      # one mma.m16n8k16


def scatter_mma_flops(plan: WindowPlan, r: int, mode: str) -> int:
    """P1's one-hot flops on these ids: each 16-segment sub-tile takes
    ceil(rows / 16) k-chunks of one mma per 8 columns per plane."""
    ids = plan.ids_pad[:plan.K, 0].cpu().numpy()
    rows = np.bincount(ids // 16, minlength=plan.n_pad // 16)
    chunks = int(np.sum((rows + 15) // 16))
    return chunks * _MMA_FLOPS * -(-r // 8) * MODES[mode]


def gather_mma_flops(plan: WindowPlan, r: int, mode: str) -> int:
    """P2's one-hot flops on these ids: each 16-id sub-tile takes one
    k-chunk per 16 source rows of its span, one mma per 8 columns per
    plane."""
    ids = plan.ids_pad[:plan.K, 0].cpu().numpy().astype(np.int64)
    t0 = np.arange(0, plan.K, 16)
    span = ids[np.minimum(t0 + 15, plan.K - 1)] - ids[t0]
    chunks = int(np.sum(span // 16 + 1))
    return chunks * _MMA_FLOPS * -(-r // 8) * MODES[mode]
