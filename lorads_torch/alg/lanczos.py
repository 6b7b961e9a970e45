"""Batched Lanczos smallest-eigenvalue estimation (dual certificate).

Port of lorads_tpu/alg/lanczos.py (30-237): the replacement of the
reference's ARPACK dsaupd_ "SA" call (lorads_sdp_conic.c:1286-1349).
A k-step sweep with full reorthogonalization runs its matvecs on the
device; the k x k tridiagonal eigenproblems are a batched
``torch.linalg.eigh`` on the device; the restart loop's convergence test
is evaluated on the device and read once per restart (counted).
"""

from __future__ import annotations

from typing import Callable

import torch

from lorads_torch import device as dev


def _bnorm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _sweep(matvec: Callable, v0: torch.Tensor, k: int):
    """One k-step Lanczos sweep with full reorthogonalization.

    v0: [B, n].  Returns (alphas [k, B], betas [k, B], Vs [k, B, n],
    alive [B, 1]); alpha slots after a breakdown hold +1e30 so the
    dead tail never contributes the minimum.
    """
    B, n = v0.shape
    dt, device = v0.dtype, v0.device
    BIG = torch.tensor(1e30, dtype=dt, device=device)

    v = v0 / torch.clamp(_bnorm(v0), min=1e-30)
    Vs = torch.zeros((k, B, n), dtype=dt, device=device)
    alphas = torch.full((k, B), 1e30, dtype=dt, device=device)
    betas = torch.zeros((k, B), dtype=dt, device=device)
    alive = torch.ones((B, 1), dtype=dt, device=device)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((B, 1), dtype=dt, device=device)
    for j in range(k):
        w = matvec(v)
        a = torch.sum(w * v, dim=-1)
        w = w - a[:, None] * v - beta_prev * v_prev
        coef = torch.einsum("kbn,bn->kb", Vs, w)
        w = w - torch.einsum("kbn,kb->bn", Vs, coef)
        b = _bnorm(w)
        alive_next = alive * (b[:, 0:1] > 1e-12).to(dt)
        v_next = torch.where(b > 1e-30, w / torch.clamp(b, min=1e-30),
                             torch.zeros_like(w))
        Vs[j] = v * alive
        alphas[j] = torch.where(alive[:, 0] > 0, a, BIG)
        betas[j] = torch.where(alive_next[:, 0] > 0, b[:, 0],
                               torch.zeros_like(b[:, 0]))
        v_prev, v, beta_prev, alive = v, v_next, b, alive_next
    return alphas, betas, Vs, alive


def _min_ritz(matvec: Callable, v: torch.Tensor, k: int):
    """One k-step sweep + tridiagonal eigh: smallest Ritz value, its
    Ritz vector, and the residual bound ||A u - lam u|| = beta_k |s_k|.

    Breakdown slots are re-pointed at alpha_0 (a Rayleigh quotient,
    >= lambda_min) with zero coupling instead of the +1e30 sentinel, so
    the batched eigh stays well conditioned."""
    alphas, betas, Vs, _ = _sweep(matvec, v, k)
    al = alphas.T                                   # [B, k]
    al = torch.where(al >= 1e29, al[:, 0:1].expand_as(al), al)
    be = betas.T[:, : max(k - 1, 0)]                # [B, k-1]
    T = (torch.diag_embed(al) + torch.diag_embed(be, 1)
         + torch.diag_embed(be, -1))
    evals, evecs = torch.linalg.eigh(T)
    lam = evals[:, 0]
    s = evecs[:, :, 0]                              # [B, k]
    resid = betas[k - 1] * torch.abs(s[:, k - 1])   # [B]
    v_next = torch.einsum("kbn,bk->bn", Vs, s)
    return lam, v_next, resid


def lanczos_min_eig_device(matvec: Callable, v0: torch.Tensor,
                           k: int = 36, tol: float = 1e-2,
                           maxit: int = 600, matvec_hi: Callable = None,
                           return_vec: bool = False):
    """Adaptive restarted Lanczos: restart from the smallest Ritz vector
    until, on EVERY block, the Ritz residual meets ARPACK's rule
    ||A u - lam u|| <= tol * |lam| (floored), the positivity bound
    lam - resid >= -tol * floor holds, or the geometrically
    extrapolated remaining drift of lam is under tol/2 * |lam|; at most
    ceil(maxit / k) restarts.  See lorads_tpu/alg/lanczos.py for the
    derivation of each exit.

    ``matvec_hi``: the same operator at a higher precision; the loop then
    runs at v0's precision and the returned eigenvalue is the final
    Ritz vector's Rayleigh quotient under ``matvec_hi`` (f64).
    Returns (lam [B], restarts[, unit Ritz vectors [B, n]]).
    """
    B, n = v0.shape
    k = min(k, n)
    max_restarts = max(-(-maxit // k), 2)
    dt, device = v0.dtype, v0.device
    floor = 1e-4 if dt == torch.float64 else 3e-3
    pos_floor = 1e-4 if matvec_hi is not None else floor
    fmax = torch.finfo(dt).max

    big = torch.full((B,), fmax, dtype=dt, device=device)
    it, lam, v = 0, torch.zeros((B,), dtype=dt, device=device), v0
    resid, lam_prev, step_prev = big, -big, big

    def done_all():
        band = tol * torch.clamp(torch.abs(lam), min=floor)
        step = torch.abs(lam - lam_prev)
        q = torch.clamp(step / torch.clamp(step_prev, min=1e-30), max=0.9)
        remaining = step * q / (1.0 - q)
        settled = (step_prev < fmax) & (remaining <= 0.5 * tol
                                        * torch.abs(lam))
        done = ((resid <= band) | (lam - resid >= -tol * pos_floor)
                | settled)
        return bool(dev.host_read(torch.all(done)))

    while it < max_restarts and not done_all():
        lam_n, v, resid = _min_ritz(matvec, v, k)
        step_prev = torch.abs(lam - lam_prev)
        lam_prev, lam = lam, lam_n
        it += 1
    if matvec_hi is not None:
        # Rayleigh-quotient refinement at f64; a broken-down block can
        # carry v ~ 0 -- keep its sweep value there
        vh = v.to(torch.float64)
        den = torch.sum(vh * vh, dim=-1)
        num = torch.sum(vh * matvec_hi(vh), dim=-1)
        lam = torch.where(den > 1e-8, num / torch.clamp(den, min=1e-30),
                          lam.to(torch.float64))
    if return_vec:
        nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        return lam, it, v / torch.clamp(nrm, min=1e-30)
    return lam, it
