"""Solver state containers: factor vectors and the L-BFGS history.

Port of lorads_tpu/alg/state.py.  A ``FactorVec`` holds one tensor
[B, n, r] per bucket plus the LP columns [n_lp] (empty without an LP
block).  The L-BFGS history keeps stacked [L, ...] tensors on the
device, and its write head and valid count too (0-d int64 tensors), as
lorads_tpu's traced state does: a push writes at the device head, and
the two-loop runs over all L slots with 0/1 weights, so the ALM inner
loop runs in graphed chunks without a host read per step.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from lorads_torch.ops.pattern import dp_mesh
from lorads_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class FactorVec:
    """One 'vector' over all factor variables: tuple of [B, n, r] + [n_lp]."""

    cones: Tuple[torch.Tensor, ...]
    lp: torch.Tensor

    def __add__(self, o):
        return FactorVec(tuple(a + b for a, b in zip(self.cones, o.cones)),
                         self.lp + o.lp)

    def scale(self, t):
        return FactorVec(tuple(t * a for a in self.cones), t * self.lp)

    def axpy(self, t, o):
        """self + t * o."""
        return FactorVec(
            tuple(a + t * b for a, b in zip(self.cones, o.cones)),
            self.lp + t * o.lp)

    def average(self, o):
        """(self + o) / 2."""
        return FactorVec(
            tuple(0.5 * (a + b) for a, b in zip(self.cones, o.cones)),
            0.5 * (self.lp + o.lp))


def fv_dot(a: FactorVec, b: FactorVec, pd=None) -> torch.Tensor:
    """<a, b>; without LP columns the sum starts at the first cone's
    (the same value, two kernels fewer).  With ``pd`` (the ProblemData),
    the cones of buckets whose blocks are split over ranks (dp) hold this
    rank's blocks: their partial sums are added up and summed over the
    ranks by one all_reduce, GSPMD's implicit psum made explicit."""
    tot = torch.sum(a.lp * b.lp) if a.lp.numel() or not a.cones else None
    part, mesh = None, None
    for i, (x, y) in enumerate(zip(a.cones, b.cones)):
        s = torch.sum(x * y)
        m = None if pd is None else dp_mesh(pd.buckets[i])
        if m is not None:
            part, mesh = (s if part is None else part + s), m
            continue
        tot = s if tot is None else tot + s
    if part is not None:
        part = comm.all_reduce(part, mesh, "fv_dot")
        tot = part if tot is None else tot + part
    return tot


def fv_norm2sq(a: FactorVec, pd=None) -> torch.Tensor:
    return fv_dot(a, a, pd)


@dataclasses.dataclass(frozen=True)
class LBFGSHistory:
    """Circular L-BFGS history (reference def_lorads_lbfgs.h:5-17):
    stacked s/y FactorVecs with leading axis L, ``beta = 1/<y,s>``."""

    s: FactorVec
    y: FactorVec
    beta: torch.Tensor      # [L]
    head: torch.Tensor      # int64 0-d: the next slot to write
    n_valid: torch.Tensor   # int64 0-d: slots holding usable pairs

    @property
    def length(self) -> int:
        return self.beta.shape[0]


def make_history(template: FactorVec, length: int) -> LBFGSHistory:
    def stack(fv):
        return FactorVec(
            tuple(torch.zeros((length,) + x.shape, dtype=x.dtype,
                              device=x.device) for x in fv.cones),
            torch.zeros((length,) + fv.lp.shape, dtype=fv.lp.dtype,
                        device=fv.lp.device))
    dev = template.lp.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return LBFGSHistory(s=stack(template), y=stack(template),
                        beta=torch.zeros((length,), dtype=template.lp.dtype,
                                         device=dev),
                        head=zero, n_valid=zero)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index (no host read)."""
    return x.index_select(0, i.reshape(1))[0]


def _slot(fv: FactorVec, i: torch.Tensor) -> FactorVec:
    return FactorVec(tuple(_at(x, i) for x in fv.cones), _at(fv.lp, i))


def _put(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor):
    """A copy of x with x[i] = v."""
    return torch.index_copy(x, 0, i.reshape(1), v[None])


def _where(c, a: FactorVec, b: FactorVec) -> FactorVec:
    return FactorVec(tuple(torch.where(c, x, y)
                           for x, y in zip(a.cones, b.cones)),
                     torch.where(c, a.lp, b.lp))


def history_push(hist: LBFGSHistory, s: FactorVec, y: FactorVec,
                 ok=None, pd=None) -> LBFGSHistory:
    """Store (s, y, beta=1/<y,s>) at the head slot and advance
    (setlbfgsHisTwo, lorads_alm.c:657-678); where the 0-d bool ``ok``
    is False the history comes back unchanged; ``pd``: as fv_dot."""
    L, i = hist.length, hist.head
    beta = 1.0 / fv_dot(y, s, pd)
    head = (hist.head + 1) % L
    n_valid = torch.clamp(hist.n_valid + 1, max=L)
    if ok is not None:
        s = _where(ok, s, _slot(hist.s, i))
        y = _where(ok, y, _slot(hist.y, i))
        beta = torch.where(ok, beta, _at(hist.beta, i))
        head = torch.where(ok, head, hist.head)
        n_valid = torch.where(ok, n_valid, hist.n_valid)
    return LBFGSHistory(
        s=FactorVec(tuple(_put(x, i, v) for x, v in zip(hist.s.cones,
                                                       s.cones)),
                    _put(hist.s.lp, i, s.lp)),
        y=FactorVec(tuple(_put(x, i, v) for x, v in zip(hist.y.cones,
                                                       y.cones)),
                    _put(hist.y.lp, i, y.lp)),
        beta=_put(hist.beta, i, beta), head=head, n_valid=n_valid)


def history_reset(hist: LBFGSHistory, when=None) -> LBFGSHistory:
    """Invalidate all pairs (reference clearLBFGS=0,
    lorads_alm.c:1075-1078); with a 0-d bool ``when``, only where it
    holds."""
    zero = torch.zeros_like(hist.n_valid)
    return dataclasses.replace(
        hist, n_valid=zero if when is None
        else torch.where(when, zero, hist.n_valid))


def lbfgs_direction_twoloop(hist: LBFGSHistory, grad: FactorVec,
                            pd=None) -> FactorVec:
    """Two-loop recursion with H0 = I; D = -grad with no valid history
    (LBFGSDirection, lorads_alm.c:230-391).  As in lorads_tpu
    (state.py:131-160) it runs over all L slots, newest first from the
    device head; the min(#steps since reset, L) valid ones weigh 1, the
    others 0 (a weight 0 leaves q unchanged bit for bit).  The slots are
    gathered once, newest first; ``pd``: as fv_dot."""
    L = hist.length
    ks = torch.arange(L, device=hist.head.device)
    order = (hist.head - 1 - ks) % L
    valid = (ks < hist.n_valid).to(grad.lp.dtype)
    beta = hist.beta.index_select(0, order)
    S = FactorVec(tuple(x.index_select(0, order) for x in hist.s.cones),
                  hist.s.lp.index_select(0, order))
    Y = FactorVec(tuple(x.index_select(0, order) for x in hist.y.cones),
                  hist.y.lp.index_select(0, order))
    slot = lambda fv, k: FactorVec(  # noqa: E731
        tuple(x[k] for x in fv.cones), fv.lp[k])
    q = grad
    alphas = []
    # newest -> oldest
    for k in range(L):
        alpha = valid[k] * beta[k] * fv_dot(slot(S, k), q, pd)
        q = q.axpy(-alpha, slot(Y, k))
        alphas.append(alpha)
    # oldest -> newest
    for k in reversed(range(L)):
        w = valid[k] * (alphas[k] - beta[k] * fv_dot(slot(Y, k), q, pd))
        q = q.axpy(w, slot(S, k))
    d = q.scale(-1.0)
    # descent safeguard: steepest descent if <D, g> >= 0
    # (LBFGSDirectionUseGrad, lorads_alm.c:469-489)
    use_grad = fv_dot(d, grad, pd) >= 0
    return FactorVec(
        tuple(torch.where(use_grad, -g, x) for x, g in zip(d.cones,
                                                           grad.cones)),
        torch.where(use_grad, -grad.lp, d.lp))


lbfgs_direction = lbfgs_direction_twoloop
