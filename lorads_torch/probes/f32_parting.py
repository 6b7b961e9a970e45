"""Where an f32 solve on the card parts from the CPU's, and whether the
hand-written kernels have a hand in it, on one NVIDIA GPU.

    python -m lorads_torch.probes.f32_parting [--save PATH]

multiblock_lp (chip_smoke.py's instance: ``generators.random_multiblock(
n_blocks=8, dim=40, m=120, density=0.05, n_lp=400, seed=5)`` with
``lp_gauss_seidel``) at ``dtype="f32"`` on the card, from the start to
the end of its first ADMM phase (the divergence retry and the gap
continuation included), twice: as the solver runs it (the loops replayed
from CUDA graphs, every kernel wrapper launching its kernel), and with
every wrapper taking its plain PyTorch branch on the same CUDA tensors,
the loops run eagerly (a plain version may read the host, which no graph
may).  Prints each run's ALM exit (inner steps, pObj, dObj) and ADMM exit
(iterations, pObj, dObj, gap, rho), whether the two runs' U, V and dual
agree bit for bit, the card's name and power limit, and last a JSON
line.  ``--save PATH``: the first run's state at the ALM exit as a
checkpoint (``LoradsSolver.save``), which either package loads on the
CPU to run the rest of the solve from the card's state.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from lorads_torch import timing


def _problem():
    from lorads_torch.io import generators
    return generators.random_multiblock(n_blocks=8, dim=40, m=120,
                                        density=0.05, n_lp=400, seed=5)


def _run(plain: bool, save=None):
    """(exits, [U cones, U lp, V cones, V lp, dual] on the host) of one
    run to the end of the first ADMM phase."""
    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.alg import devloop
    from lorads_torch.alg.admm import ADMMStats
    from lorads_torch.alg.alm import ALMStats
    from lorads_torch.ops import kernels

    real_check, real_tracing = kernels._check, devloop.tracing

    def plain_check(*a):
        real_check(*a)          # the wrapper's argument checks
        return False            # then its plain branch
    if plain:
        kernels._check = plain_check
        devloop.tracing = lambda: True
    try:
        s = LoradsSolver(_problem(), LoradsParams(
            dtype="f32", lp_gauss_seidel=True, verbose=False),
            device="cuda")
        alm = ALMStats(rho=s.ps.rho0)
        s.alm_phase(alm, time.time())
        if save:
            s.save(save, alm, None, "post_alm")
        st = ADMMStats(rho=s.ps.rho0)
        s.alm_to_admm(alm, st)
        s.admm_phase(st, s.params.max_admm_iter, time.time())
        torch.cuda.synchronize()
    finally:
        kernels._check, devloop.tracing = real_check, real_tracing
        devloop.drop()
    exits = dict(alm=[alm.inner_iter, alm.pobj, alm.dobj],
                 admm=[st.iter, st.pobj, st.dobj, st.gap, st.rho],
                 retries=s.admm_retries)
    state = [t.cpu() for fv in (s.U, s.V) for t in fv.cones + (fv.lp,)]
    return exits, state + [s.dual.cpu()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", help="checkpoint of the ALM exit's state")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_parting: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    card = timing.card_line()
    out = {}
    states = {}
    for name, plain in (("kernels", False), ("plain", True)):
        t0 = time.time()
        exits, states[name] = _run(plain, args.save if not plain else None)
        out[name] = dict(exits, seconds=time.time() - t0)
        print(f"f32 multiblock_lp [{name}]: ALM exit (inner, pObj, dObj) "
              f"{exits['alm']}, ADMM exit (iter, pObj, dObj, gap, rho) "
              f"{exits['admm']}, retries {exits['retries']}, "
              f"{out[name]['seconds']:.1f} s  [{card}]")
    same = all(torch.equal(a, b)
               for a, b in zip(states["kernels"], states["plain"]))
    out["same_bits"] = same
    print(f"U, V and dual at the ADMM exit bit for bit between the kernels "
          f"and their plain versions: {same}")
    print(f"card: {card}")
    print(json.dumps({"f32_parting": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
