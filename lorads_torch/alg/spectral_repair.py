"""Spectral-bundle dual repair (port of lorads_tpu/alg/spectral_repair.py).

Shifts the dual along the least-squares preimage of the slack's
offending eigendirections.  It runs when the certificate's dinf fails
its band after Phase II (solver._try_dual_refine), before the CGNR
dual refinement, and is what certifies Lovász theta.  Per round:

* a certificate pass gives each block's lowest eigenpairs of
  S = C - A^*(lambda) (up to 12 from the exact eigh);
* the eigenvectors below 2 * band join an orthonormal basis B per block
  (at most P_CAP = 48 columns, oldest dropped first);
* the active-set loop (``_active_set``, at most 12 iterations) takes
  the projected slack P = B^T S(lambda + d) B, its eigen-directions u
  below delta = band/2 (scaled), their affine pieces <C, uu^T> and
  A(uu^T), and a b-orthogonal, proximally regularized least-squares
  step d that moves every active Rayleigh quotient to delta, so dObj
  and the gap stay exactly where they were.

Rounds stop when the re-measured dinf is under 0.7 * band, fails to
improve, or 30 rounds are spent; the best certified dual is kept if it
improved dinf, and accepted if it passes the band.

The active-set loop is one device-decided loop, as lorads_tpu's
while_loop is (``active_set_loop``, alg/devloop.py): on CUDA tensors a
run replays one graph and reads the host once; the projected slacks'
eigenpairs come from kernel K9 (``kernels.sym_eig_small``), the step's
regularized k x k solve from torch.linalg.solve_ex at f32, as in
lorads_tpu (spectral_repair.py:153-162), so both packages take the same
steps.  On CPU tensors the steps run eagerly, the host reading the exit
test before each, with K9's plain version (torch.linalg.eigh).  A
repair's graphs are dropped with it (``devloop.phase``).
When the bases span several buckets, the round runs lorads_tpu's host
active-set loop instead (``_host_active_set``,
spectral_repair.py:328-381): per iteration each bucket's projected
slack on the device (``_proj_slack``), its eigen-directions by a host
eigh, their affine pieces on the device, and an f64 least-squares step
on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lorads_torch import device as dev
from lorads_torch.alg import devloop
from lorads_torch.ops import kernels
from lorads_torch.ops import pattern as pat

# basis columns kept per block, and directions taken per active-set
# iteration (spectral_repair.py:197, 302)
P_CAP = 48
CON_PAD = 12
# active-set iterations per round and repair rounds (:72, :210)
N_ITERS = 12
MAX_ROUNDS = 30


def _pieces(bk, u: torch.Tensor):
    """(<C, uu^T>, A(uu^T) [m]) for one direction slab u [B, n, 1]."""
    uv = pat.uvt(bk, u, u)
    return (torch.sum(pat.obj_inner(bk, uv)),
            pat.scatter_constr(bk, pat.constr_vals(bk, uv)))


def _proj_slack(bk, dual, Bmat: torch.Tensor) -> torch.Tensor:
    """Projected slack P = B^T (C - A^*(dual)) B per block [b_eff, p, p]
    for the direction bases Bmat [b_eff, n, p] (spectral_repair.py:42-53)."""
    W = pat.build_w(bk, pat.gather_w(bk, -dual))
    return torch.matmul(Bmat.transpose(1, 2), pat.w_mul(bk, W, Bmat))


def _host_active_set(solver, bases: dict, delta: float, sigma: float):
    """One repair round's active-set loop over several buckets
    (spectral_repair.py:328-381) -> (dual step [m] on the host,
    constraints collected).  ``bases``: (bucket j, block bi) ->
    orthonormal [n, p] numpy basis."""
    Bmats, p_real = {}, {}
    for j, bk in enumerate(solver.pd.buckets):
        blocks = [bi for (jj, bi) in bases if jj == j]
        if not blocks:
            continue
        Bm = np.zeros((solver.last_cert_vecs[j].shape[0], bk.n, P_CAP))
        for bi in blocks:
            Bb = bases[(j, bi)]
            Bm[bi, :, :Bb.shape[1]] = Bb
            p_real[(j, bi)] = Bb.shape[1]
        Bmats[j] = solver._tensor(Bm)
    b = np.asarray(dev.host_read(solver.pd.rhs.double(), "repair"), np.float64)
    bb = float(b @ b)
    lam = np.asarray(dev.host_read(solver.dual.double(), "repair"), np.float64)
    d_tot = np.zeros(solver.pd.m)
    cons_c, cons_g = [], []
    for _ in range(N_ITERS):
        dual_cur = solver._tensor(lam + d_tot)
        new_dirs = []          # (j, bi, u)
        for j, Bm in Bmats.items():
            P_all = np.asarray(dev.host_read(_proj_slack(
                solver.pd.buckets[j], dual_cur, Bm).double(), "repair"),
                np.float64)
            for (jj, bi), pw in p_real.items():
                if jj != j:
                    continue
                P = P_all[bi][:pw, :pw]
                evals, W = np.linalg.eigh(0.5 * (P + P.T))
                for ei in np.nonzero(evals < delta * (1 - 1e-9))[0][:CON_PAD]:
                    new_dirs.append((j, bi, bases[(j, bi)] @ W[:pw, ei]))
        if not new_dirs:
            break               # lam_min(P) >= delta everywhere
        # affine pieces of the new directions, bucket by bucket
        for j in sorted({d[0] for d in new_dirs}):
            bk = solver.pd.buckets[j]
            dirs_j = [d for d in new_dirs if d[0] == j][:CON_PAD]
            Vk = np.zeros((len(dirs_j), Bmats[j].shape[0], bk.n, 1))
            for q, (_, bi, u) in enumerate(dirs_j):
                Vk[q, bi, :, 0] = u
            Vkd = solver._tensor(Vk)
            pieces = [_pieces(bk, Vkd[q]) for q in range(len(dirs_j))]
            got = np.asarray(dev.host_read(torch.stack(
                [torch.cat([c[None], g]) for c, g in pieces]).double(),
                "repair"), np.float64)
            cons_c.extend(got[:, 0])
            cons_g.extend(got[:, 1:])
        G = np.stack(cons_g)
        cs = np.asarray(cons_c)
        Gp = (G - (G @ b / max(bb, 1e-300))[:, None] * b[None]
              if bb > 0 else G)
        rq = cs - G @ (lam + d_tot)
        t = rq - np.maximum(rq, delta)
        M = Gp @ Gp.T
        reg = sigma * max(np.trace(M) / max(len(M), 1), 1e-30)
        alpha = np.linalg.solve(M + reg * np.eye(len(M)), t)
        d_tot = d_tot + Gp.T @ alpha
    return d_tot, len(cons_g)


@dataclasses.dataclass
class ActiveSetState:
    """The active-set loop's carry (lorads_tpu :172-174)."""

    d_tot: torch.Tensor      # [m] the round's dual step so far
    G: torch.Tensor          # [n_iters * con_pad, m] the constraints' A(uu^T)
    cs: torch.Tensor         # [n_iters * con_pad] their <C, uu^T>
    rv: torch.Tensor         # [n_iters * con_pad] 1 where a row is active
    it: torch.Tensor         # int64 0-d: iterations run
    none_new: torch.Tensor   # bool 0-d: the last found no direction


def active_set_loop(bk, Bmat: torch.Tensor, p_mask: torch.Tensor, dual0,
                    rhs: torch.Tensor, delta, sigma,
                    n_iters: int = N_ITERS,
                    con_pad: int = CON_PAD) -> devloop.Loop:
    """One repair round's active-set loop for a single bucket as a
    device-decided devloop.Loop (label ``repair``; _active_set_device,
    spectral_repair.py:71-178).  Per iteration: P = B^T (C - A^*(dual0 +
    d)) B per block, masked to each block's real basis width; its
    eigenpairs (kernel K9); the con_pad lowest across the bucket's blocks
    become candidate directions (eigenvalue below delta); their affine
    pieces (K3, K4) fill the fixed-width constraint buffer at rows it *
    con_pad; a b-orthogonal, proximally regularized least-squares step
    moves every active Rayleigh quotient to delta, unless no direction
    was new.  Runs while it < n_iters and the last iteration found a
    direction.  ``delta`` and ``sigma`` (numbers or 0-d tensors) are
    inputs: sigma changes from round to round.  The pack: [d_tot (m) |
    constraints collected | iterations run], float64."""
    b_eff, n, P = Bmat.shape
    m = rhs.shape[0]
    dt, device = Bmat.dtype, Bmat.device
    R_rows = n_iters * con_pad

    def step(inp, st, kind):
        Bmat, p_mask, dual0, rhs, delta, sigma = inp
        # padded eigh dims sit safely above the activation threshold
        big = delta + torch.abs(delta) + 1.0
        bb = torch.dot(rhs, rhs)
        m2 = p_mask[:, :, None] * p_mask[:, None, :]
        eyeP = torch.eye(P, dtype=dt, device=device)[None]
        eyeR = torch.eye(R_rows, dtype=dt, device=device)
        blocks = torch.arange(b_eff, device=device)
        dual_cur = dual0 + st.d_tot
        W = pat.build_w(bk, pat.gather_w(bk, -dual_cur))
        SB = pat.w_mul(bk, W, Bmat)
        Pm = torch.matmul(Bmat.transpose(1, 2), SB)
        Pm = 0.5 * (Pm + Pm.transpose(1, 2))
        Pm = Pm * m2 + big * (1.0 - m2) * eyeP
        evals, Wv = kernels.sym_eig_small(Pm)                 # ascending
        flat = evals.reshape(-1)
        idx = torch.topk(-flat, con_pad).indices              # lowest k
        ev_sel = flat[idx]
        bi, ci = idx // P, idx % P
        valid = (ev_sel < delta * (1 - 1e-9)).to(dt)
        u_q = torch.einsum("knp,kp->kn", Bmat[bi], Wv[bi, :, ci])
        slab = (blocks[None, :] == bi[:, None]).to(dt)       # [k, b_eff]
        Vq = u_q[:, None, :, None] * slab[:, :, None, None]
        pieces = [_pieces(bk, Vq[q]) for q in range(con_pad)]
        cu = torch.stack([p[0] for p in pieces])
        gu = torch.stack([p[1] for p in pieces]) * valid[:, None]
        # invalid rows: g = 0 and cs = delta make their target t = 0
        cs_q = torch.where(valid > 0, cu, delta)
        # the new rows at it * con_pad (out of place: a run leaves the
        # state it was given as it was)
        rows = st.it * con_pad + torch.arange(con_pad, device=device)
        G = st.G.index_copy(0, rows, gu)
        cs = st.cs.index_copy(0, rows, cs_q)
        rv = st.rv.index_copy(0, rows, valid)
        Gp = torch.where(bb > 0, G - (G @ rhs / torch.clamp(bb, min=1e-300))
                         [:, None] * rhs[None], G)
        rq = cs - G @ dual_cur
        t = rq - torch.clamp(rq, min=delta)
        M = Gp @ Gp.T
        nval = torch.clamp(torch.sum(rv), min=1.0)
        reg = sigma * torch.clamp(torch.trace(M) / nval, min=1e-30)
        # the tiny regularized system is scale-normalized and solved at
        # f32, as lorads_tpu does; the step feeds a proximal loop that
        # re-measures dinf and backtracks.  solve_ex: no host check
        Mn = M + reg * eyeR
        sc = torch.clamp(torch.amax(torch.abs(Mn)), min=1e-30)
        alpha = torch.linalg.solve_ex((Mn / sc).to(torch.float32),
                                      (t / sc).to(torch.float32))[0].to(dt)
        # no new directions: no step, and the loop ends
        none_new = torch.sum(valid) == 0
        d_tot = torch.where(none_new, st.d_tot, st.d_tot + Gp.T @ alpha)
        return ActiveSetState(d_tot=d_tot, G=G, cs=cs, rv=rv, it=st.it + 1,
                              none_new=none_new)

    def pack(inp, st):
        return torch.cat([st.d_tot.to(torch.float64),
                          torch.stack([torch.sum(st.rv),
                                       st.it.to(dt)]).to(torch.float64)])

    state = ActiveSetState(
        d_tot=torch.zeros((m,), dtype=dt, device=device),
        G=torch.zeros((R_rows, m), dtype=dt, device=device),
        cs=torch.zeros((R_rows,), dtype=dt, device=device),
        rv=torch.zeros((R_rows,), dtype=dt, device=device),
        it=torch.zeros((), dtype=torch.int64, device=device),
        none_new=torch.zeros((), dtype=torch.bool, device=device))
    return devloop.Loop(
        key=("active_set", devloop.ident(bk), n_iters, con_pad), step=step,
        pack=pack,
        inputs=(Bmat, p_mask, dual0, rhs, devloop.scalar(delta, dt, device),
                devloop.scalar(sigma, dt, device)),
        state=state, label="repair",
        running=lambda inp, st: (st.it < n_iters) & ~st.none_new)


def _active_set(bk, Bmat: torch.Tensor, p_mask: torch.Tensor, dual0,
                rhs: torch.Tensor, delta: float, sigma: float,
                n_iters: int = N_ITERS, con_pad: int = CON_PAD):
    """The active-set loop (``active_set_loop``) run to its exit: one
    graph replay and one host read on CUDA tensors.  Returns (d_tot
    [m], constraints collected, iterations run)."""
    state, out = devloop.run(active_set_loop(bk, Bmat, p_mask, dual0, rhs,
                                             delta, sigma, n_iters, con_pad))
    m = rhs.shape[0]
    return state.d_tot, int(out[m]), int(out[m + 1])


def try_spectral_repair(solver, admm_stats) -> bool:
    """Run the repair on ``solver`` (a LoradsSolver); returns True iff
    the repaired dual passes its dinf band (admm_stats updated).  The
    outcome is kept in ``solver.spectral_repair_info``; the graphs of its
    certificates and active-set loops are dropped at its end."""
    with devloop.phase():
        return _spectral_repair(solver, admm_stats)


def _spectral_repair(solver, admm_stats) -> bool:
    params = solver.params
    band = (params.phase2_tol if params.high_acc_mode
            else 5 * params.phase2_tol)
    t0 = time.time()
    dinf0 = admm_stats.dinf_l1
    old_dual = solver.dual
    norm = solver.scale_obj_his * (solver.pd.c_nrm1 + 1.0)
    b = solver.pd.rhs
    best_dinf, best_dual = dinf0, None
    floor = 1e-14 * max(1.0, float(solver.pd.c_nrm_inf))
    prev_dinf, since_impr = np.inf, 0
    traj = []
    bases = {}        # (bucket j, block bi) -> orthonormal [n, p]
    delta = 0.5 * band * norm
    n_cons = 0
    # proximal weight of the constraint solve: heavier after a round
    # whose dinf regressed (with the dual restored), lighter after one
    # that improved
    sigma = 1e-2
    last_dinf, last_dual = np.inf, None
    for rnd in range(MAX_ROUNDS):
        lp_part, lams = solver._dual_infeas_pass()
        dinf = lp_part
        for lam in lams:
            dinf += float(np.sum(np.abs(np.minimum(lam, 0.0))))
        dinf /= norm
        traj.append(dinf)
        if dinf < best_dinf:
            best_dinf, best_dual = dinf, solver.dual
        if dinf <= 0.7 * band:
            break
        restored = False
        if dinf > last_dinf * 1.02 and last_dual is not None:
            solver.dual = last_dual
            sigma *= 8.0
            restored = True
            if sigma > 1e5:
                break
        else:
            last_dinf, last_dual = dinf, solver.dual
            sigma = max(sigma * 0.9, 1e-4)
        # plateau exit: five non-backtracked rounds without improving
        # the best certified dinf by 10%
        if not restored:
            since_impr = 0 if dinf < 0.9 * prev_dinf else since_impr + 1
            prev_dinf = min(prev_dinf, dinf)
        if since_impr >= 5:
            break
        # grow each block's basis with the newly measured
        # eigendirections (orthonormalized)
        grab = 2.0 * band * norm
        for j in range(len(solver.pd.buckets)):
            vec = np.asarray(dev.host_read(solver.last_cert_vecs[j], "repair"),
                             np.float64)
            lk = np.asarray(dev.host_read(solver.last_cert_lams_k[j],
                                          "repair"), np.float64)
            for bi, ki in zip(*np.nonzero(lk < max(grab, floor))):
                Bb = bases.get((j, bi))
                v = vec[bi, ki].copy()
                if Bb is not None:
                    v -= Bb @ (Bb.T @ v)
                nv = np.linalg.norm(v)
                if nv < 1e-6:
                    continue
                bases[(j, bi)] = (
                    (v / nv)[:, None] if Bb is None
                    else np.concatenate([Bb, (v / nv)[:, None]], 1))
        if not bases:
            break
        for key in list(bases):
            if bases[key].shape[1] > P_CAP:
                bases[key] = bases[key][:, -P_CAP:]
        if len({j for j, _ in bases}) > 1:
            d_tot, n_cons = _host_active_set(solver, bases, delta, sigma)
            solver.dual = solver.dual + solver._tensor(d_tot)
            continue
        j = next(iter(bases))[0]
        bk = solver.pd.buckets[j]
        b_eff = solver.last_cert_vecs[j].shape[0]
        Bm = np.zeros((b_eff, bk.n, P_CAP))
        pm = np.zeros((b_eff, P_CAP))
        for (_, bi), Bb in bases.items():
            Bm[bi, :, :Bb.shape[1]] = Bb
            pm[bi, :Bb.shape[1]] = 1.0
        d_tot, n_cons, _ = _active_set(
            bk, solver._tensor(Bm), solver._tensor(pm), solver.dual, b,
            delta, sigma)
        solver.dual = solver.dual + d_tot
    accept = best_dinf <= band and best_dual is not None
    improved = best_dual is not None and best_dinf < dinf0
    solver.spectral_repair_info = dict(
        rounds=rnd + 1, dinf_before=dinf0, dinf_after=best_dinf,
        accepted=accept, seconds=time.time() - t0)
    solver.log(f"spectral dual repair: dinf {dinf0:.2e} -> {best_dinf:.2e} "
               f"in {rnd + 1} rounds "
               f"({' '.join(f'{d:.1e}' for d in traj)}), basis "
               f"{sum(B.shape[1] for B in bases.values())} cons "
               f"{n_cons} [{time.time() - t0:.2f}s] -> "
               + ("accepted" if accept else
                  "kept (band unmet)" if improved else "rejected"))
    if accept or improved:
        # b-orthogonal moves leave dObj/gap untouched, so a strictly
        # better certified dinf is kept even when the band is unmet
        solver.dual = best_dual
        dobj_new = dev.host_read(torch.dot(solver.pd.rhs, solver.dual),
                                 "repair")
        dobj_new /= solver.scale_obj_his
        solver.dobj = dobj_new
        solver.gap = abs(solver.pobj - dobj_new) / (
            1.0 + abs(solver.pobj) + abs(dobj_new))
        admm_stats.dobj = dobj_new
        admm_stats.gap = solver.gap
        admm_stats.dinf_l1 = best_dinf
        admm_stats.dinf_inf = best_dinf * (1 + solver.pd.c_nrm1) / (
            1 + solver.pd.c_nrm_inf)
        return accept
    solver.dual = old_dual
    return False
