"""Batched Lanczos smallest-eigenvalue estimation (dual certificate).

Port of lorads_tpu/alg/lanczos.py (30-237): the replacement of the
reference's ARPACK dsaupd_ "SA" call (lorads_sdp_conic.c:1286-1349).
The restart loop is one device-decided loop (``lanczos_loop``,
alg/devloop.py; lorads_tpu's ``lax.while_loop``, lanczos.py:222).  A
restart runs a k-step sweep with full reorthogonalization, its steps
nested through ``devloop.repeat`` (one WHILE node of one step, the step's
row of Vs, alpha and beta written at a device counter), then the k x k
tridiagonal Ritz problem on the small symmetric eigensolver (kernel K9,
``kernels.sym_eig_small``), the Ritz residual and the Ritz vector; the
exit test is evaluated on the device.  On CUDA tensors a run replays one
graph and reads the host once: the pack [lambda (B) | restarts], with the
optional higher-precision Rayleigh refinement and the eigenvalues' scale
computed inside the graph.  On CPU tensors the same steps run eagerly,
the host reading the exit test before each restart, and K9 takes its
plain version (torch.linalg.eigh).

The matvec reads the per-certificate tensors it is given as arguments
(``ops``: the loop's inputs, which a graph reads at its buffers'
addresses), never tensors it closes over, except static ones that the
loop's key keeps alive.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from lorads_torch.alg import devloop
from lorads_torch.ops import kernels


def _bnorm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _sweep(matvec: Callable, ops, v0: torch.Tensor, k: int):
    """One k-step Lanczos sweep with full reorthogonalization.

    v0: [B, n].  Returns (alphas [k, B], betas [k, B], Vs [k, B, n]);
    alpha slots after a breakdown hold +1e30 so the dead tail never
    contributes the minimum.
    """
    B, n = v0.shape
    dt, device = v0.dtype, v0.device

    def step(ops, st, j):
        v, v_prev, beta_prev, Vs, alphas, betas, alive = st
        w = matvec(v, *ops)
        a = torch.sum(w * v, dim=-1)
        w = w - a[:, None] * v - beta_prev * v_prev
        coef = torch.einsum("kbn,bn->kb", Vs, w)
        w = w - torch.einsum("kbn,kb->bn", Vs, coef)
        b = _bnorm(w)
        alive_next = alive * (b[:, 0:1] > 1e-12).to(dt)
        v_next = torch.where(b > 1e-30, w / torch.clamp(b, min=1e-30),
                             torch.zeros_like(w))
        at = j.reshape(1)
        Vs.index_copy_(0, at, (v * alive)[None])
        alphas.index_copy_(0, at, torch.where(alive[:, 0] > 0, a,
                                              1e30)[None])
        betas.index_copy_(0, at, torch.where(
            alive_next[:, 0] > 0, b[:, 0], torch.zeros_like(b[:, 0]))[None])
        return (v_next, v, b, Vs, alphas, betas, alive_next)

    st = (v0 / torch.clamp(_bnorm(v0), min=1e-30),
          torch.zeros((B, n), dtype=dt, device=device),
          torch.zeros((B, 1), dtype=dt, device=device),
          torch.zeros((k, B, n), dtype=dt, device=device),
          torch.full((k, B), 1e30, dtype=dt, device=device),
          torch.zeros((k, B), dtype=dt, device=device),
          torch.ones((B, 1), dtype=dt, device=device))
    _, _, _, Vs, alphas, betas, _ = devloop.repeat(step, ops, st, k)
    return alphas, betas, Vs


def _min_ritz(matvec: Callable, ops, v: torch.Tensor, k: int):
    """One k-step sweep + tridiagonal eigh: smallest Ritz value, its
    Ritz vector, and the residual bound ||A u - lam u|| = beta_k |s_k|.

    Breakdown slots are re-pointed at alpha_0 (a Rayleigh quotient,
    >= lambda_min) with zero coupling instead of the +1e30 sentinel, so
    the batched eigh stays well conditioned."""
    alphas, betas, Vs = _sweep(matvec, ops, v, k)
    al = alphas.T                                   # [B, k]
    al = torch.where(al >= 1e29, al[:, 0:1].expand_as(al), al)
    be = betas.T[:, : max(k - 1, 0)]                # [B, k-1]
    T = (torch.diag_embed(al) + torch.diag_embed(be, 1)
         + torch.diag_embed(be, -1))
    evals, evecs = kernels.sym_eig_small(T)
    # the loop carries lam: a contiguous [B] (a column of evals is
    # strided where B > 1)
    lam = evals[:, 0].contiguous()
    s = evecs[:, :, 0]                              # [B, k]
    resid = betas[k - 1] * torch.abs(s[:, k - 1])   # [B]
    v_next = torch.einsum("kbn,bk->bn", Vs, s)
    return lam, v_next, resid


@dataclasses.dataclass
class LanczosState:
    """The restart loop's carry (lorads_tpu's while_loop carry)."""

    it: torch.Tensor          # int64 0-d: restarts run
    lam: torch.Tensor         # [B] the smallest Ritz value
    v: torch.Tensor           # [B, n] its Ritz vector
    resid: torch.Tensor       # [B] its residual bound
    lam_prev: torch.Tensor    # [B] the restart before's
    step_prev: torch.Tensor   # [B] |lam - lam_prev| the restart before


@dataclasses.dataclass
class LanczosInputs:
    """What a run reads: the matvec's tensors, those of the
    higher-precision matvec (empty without it), the eigenvalues' scale
    ([B] or None)."""

    ops: tuple
    ops_hi: tuple
    scale: Optional[torch.Tensor]


def lanczos_loop(matvec: Callable, v0: torch.Tensor, k: int = 36,
                 tol: float = 1e-2, maxit: int = 600,
                 matvec_hi: Callable = None, ops=(), ops_hi=(),
                 scale: Optional[torch.Tensor] = None,
                 key=None) -> devloop.Loop:
    """The adaptive restart loop as a device-decided devloop.Loop (label
    ``lanczos``): restart from the smallest Ritz vector until, on EVERY
    block, the Ritz residual meets ARPACK's rule ||A u - lam u|| <= tol *
    |lam| (floored), the positivity bound lam - resid >= -tol * floor
    holds, or the geometrically extrapolated remaining drift of lam is
    under tol/2 * |lam|; at most ceil(maxit / k) restarts.  See
    lorads_tpu/alg/lanczos.py for the derivation of each exit.

    ``matvec(x, *ops)``: the operator on [B, n]; ``matvec_hi(x, *ops_hi)``:
    the same operator at a higher precision, or None; the loop then runs
    at v0's precision and the pack's eigenvalue is the final Ritz
    vector's Rayleigh quotient under ``matvec_hi`` (f64).  ``scale``
    ([B] or None) multiplies the pack's eigenvalues.  ``key`` names what
    the matvecs close over (``devloop.ident`` of a bucket); None: the
    matvecs themselves.  The pack: [lam (B) | restarts], float64."""
    B, n = v0.shape
    k = min(k, n)
    max_restarts = max(-(-maxit // k), 2)
    dt, device = v0.dtype, v0.device
    floor = 1e-4 if dt == torch.float64 else 3e-3
    hi = matvec_hi is not None
    pos_floor = 1e-4 if hi else floor
    fmax = torch.finfo(dt).max
    if key is None:
        key = (devloop.ident(matvec), devloop.ident(matvec_hi))

    def running(inp, c):
        band = tol * torch.clamp(torch.abs(c.lam), min=floor)
        step = torch.abs(c.lam - c.lam_prev)
        q = torch.clamp(step / torch.clamp(c.step_prev, min=1e-30), max=0.9)
        remaining = step * q / (1.0 - q)
        settled = (c.step_prev < fmax) & (remaining <= 0.5 * tol
                                          * torch.abs(c.lam))
        done = ((c.resid <= band) | (c.lam - c.resid >= -tol * pos_floor)
                | settled)
        return (c.it < max_restarts) & ~torch.all(done)

    def step(inp, c, kind):
        lam_n, v_next, resid = _min_ritz(matvec, inp.ops, c.v, k)
        return LanczosState(it=c.it + 1, lam=lam_n, v=v_next, resid=resid,
                            lam_prev=c.lam,
                            step_prev=torch.abs(c.lam - c.lam_prev))

    def pack(inp, c):
        lam = c.lam
        if hi:
            # Rayleigh-quotient refinement at f64; a broken-down block
            # can carry v ~ 0 -- keep its sweep value there
            vh = c.v.to(torch.float64)
            den = torch.sum(vh * vh, dim=-1)
            num = torch.sum(vh * matvec_hi(vh, *inp.ops_hi), dim=-1)
            lam = torch.where(den > 1e-8, num / torch.clamp(den, min=1e-30),
                              lam.to(torch.float64))
        if inp.scale is not None:
            lam = lam * inp.scale
        return torch.cat([lam.to(torch.float64),
                          c.it.to(torch.float64).reshape(1)])

    big = torch.full((B,), fmax, dtype=dt, device=device)
    state = LanczosState(
        it=torch.zeros((), dtype=torch.int64, device=device),
        lam=torch.zeros((B,), dtype=dt, device=device), v=v0, resid=big,
        lam_prev=-big, step_prev=big)
    return devloop.Loop(
        key=("lanczos", key, k, tol, maxit, hi), step=step, pack=pack,
        inputs=LanczosInputs(tuple(ops), tuple(ops_hi), scale),
        state=state, label="lanczos", running=running)


def lanczos_result(state: LanczosState, out):
    """(lam [B] float64 numpy array, restarts, unit Ritz vectors [B, n])
    of a run of a Lanczos loop that ended in ``state`` with the pack
    ``out``."""
    B = state.lam.shape[0]
    nrm = torch.sqrt(torch.sum(state.v * state.v, dim=-1, keepdim=True))
    return (np.asarray(out[:B], dtype=np.float64), int(out[B]),
            state.v / torch.clamp(nrm, min=1e-30))


def lanczos_min_eig_device(matvec: Callable, v0: torch.Tensor,
                           k: int = 36, tol: float = 1e-2,
                           maxit: int = 600, matvec_hi: Callable = None,
                           ops=(), ops_hi=(),
                           scale: Optional[torch.Tensor] = None, key=None):
    """The restart loop (``lanczos_loop``) run to its exit: one graph
    replay and one host read on CUDA tensors.  Returns (lam [B] float64
    numpy array, times ``scale`` where given, restarts)."""
    loop = lanczos_loop(matvec, v0, k, tol, maxit, matvec_hi, ops, ops_hi,
                        scale, key)
    return lanczos_result(*devloop.run(loop))[:2]
