"""Solver state containers: factor vectors and the L-BFGS history.

Port of lorads_tpu/alg/state.py.  A ``FactorVec`` holds one tensor
[B, n, r] per bucket plus the LP columns [n_lp] (empty here: LP blocks
are not ported).  The L-BFGS history keeps stacked [L, ...] tensors on
the device; its write head and valid count are host integers, since
every push and reset is a host decision in the eager loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


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


def fv_dot(a: FactorVec, b: FactorVec) -> torch.Tensor:
    tot = torch.sum(a.lp * b.lp)
    for x, y in zip(a.cones, b.cones):
        tot = tot + torch.sum(x * y)
    return tot


def fv_norm2sq(a: FactorVec) -> torch.Tensor:
    return fv_dot(a, a)


@dataclasses.dataclass(frozen=True)
class LBFGSHistory:
    """Circular L-BFGS history (reference def_lorads_lbfgs.h:5-17):
    stacked s/y FactorVecs with leading axis L, ``beta = 1/<y,s>``."""

    s: FactorVec
    y: FactorVec
    beta: torch.Tensor   # [L]
    head: int = 0        # next slot to write
    n_valid: int = 0     # slots holding usable pairs

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
    return LBFGSHistory(s=stack(template), y=stack(template),
                        beta=torch.zeros((length,), dtype=template.lp.dtype,
                                         device=template.lp.device))


def _slot(fv: FactorVec, i: int) -> FactorVec:
    return FactorVec(tuple(x[i] for x in fv.cones), fv.lp[i])


def _set_slot(fv: FactorVec, i: int, val: FactorVec) -> FactorVec:
    def put(x, v):
        x = x.clone()
        x[i] = v
        return x
    return FactorVec(tuple(put(x, v) for x, v in zip(fv.cones, val.cones)),
                     put(fv.lp, val.lp))


def history_push(hist: LBFGSHistory, s: FactorVec,
                 y: FactorVec) -> LBFGSHistory:
    """Store (s, y, beta=1/<y,s>) at the head slot and advance
    (setlbfgsHisTwo, lorads_alm.c:657-678)."""
    L = hist.length
    beta = hist.beta.clone()
    beta[hist.head] = 1.0 / fv_dot(y, s)
    return LBFGSHistory(s=_set_slot(hist.s, hist.head, s),
                        y=_set_slot(hist.y, hist.head, y), beta=beta,
                        head=(hist.head + 1) % L,
                        n_valid=min(hist.n_valid + 1, L))


def history_reset(hist: LBFGSHistory) -> LBFGSHistory:
    """Invalidate all pairs (reference clearLBFGS=0, lorads_alm.c:1075-1078)."""
    return dataclasses.replace(hist, n_valid=0)


def lbfgs_direction_twoloop(hist: LBFGSHistory,
                            grad: FactorVec) -> FactorVec:
    """Two-loop recursion with H0 = I; D = -grad with no valid history
    (LBFGSDirection, lorads_alm.c:230-391).  Only the min(#steps since
    reset, L) newest pairs are used."""
    L = hist.length
    q = grad
    alphas = []
    # newest -> oldest: slots head-1, head-2, ...
    for k in range(min(hist.n_valid, L)):
        idx = (hist.head - 1 - k) % L
        alpha = hist.beta[idx] * fv_dot(_slot(hist.s, idx), q)
        q = q.axpy(-alpha, _slot(hist.y, idx))
        alphas.append((idx, alpha))
    # oldest -> newest
    for idx, alpha in reversed(alphas):
        w = alpha - hist.beta[idx] * fv_dot(_slot(hist.y, idx), q)
        q = q.axpy(w, _slot(hist.s, idx))
    d = q.scale(-1.0)
    # descent safeguard: steepest descent if <D, g> >= 0
    # (LBFGSDirectionUseGrad, lorads_alm.c:469-489)
    use_grad = fv_dot(d, grad) >= 0
    return FactorVec(
        tuple(torch.where(use_grad, -g, x) for x, g in zip(d.cones,
                                                           grad.cones)),
        torch.where(use_grad, -grad.lp, d.lp))


lbfgs_direction = lbfgs_direction_twoloop
