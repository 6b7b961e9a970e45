"""Basic usage of the PyTorch/CUDA port: build an SDP, solve it, inspect
the result (the twin of examples/basic_usage.py).

Run:  python examples/torch/basic_usage.py [--device cuda|cpu]
(``cuda``, the default, needs an NVIDIA GPU; ``cpu`` runs anywhere.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from lorads_torch import LoradsParams, LoradsSolver, solve
from lorads_torch.core.problem import (SDPBlockData, SDPProblem,
                                       merge_problems, split_objectives)
from lorads_torch.io import generators


def from_generator(device):
    """Solve a G-set-style Max-Cut relaxation."""
    problem = generators.maxcut(n=500, avg_degree=6, seed=0)
    res = solve(problem, LoradsParams(verbose=False), device=device)
    print(f"maxcut n=500: {res.status.value}  pObj={res.pobj:.6e}  "
          f"gap={res.gap:.1e}  pinf={res.pinf_l1:.1e}")
    return res


def hand_built(device):
    """Build min <C,X> s.t. diag(X)=1, X PSD directly from triplets."""
    n = 8
    rng = np.random.default_rng(0)
    # random symmetric objective, lower triangle (row >= col)
    rows, cols = np.tril_indices(n)
    vals = rng.standard_normal(rows.size)
    blk = SDPBlockData(
        dim=n, m=n,
        obj_row=rows.astype(np.int32), obj_col=cols.astype(np.int32),
        obj_val=vals,
        a_con=np.arange(n, dtype=np.int32),     # constraint i ...
        a_row=np.arange(n, dtype=np.int32),     # ... touches X[i, i]
        a_col=np.arange(n, dtype=np.int32),
        a_val=np.ones(n),
    )
    problem = SDPProblem(m=n, rhs=np.ones(n), blocks=[blk])
    res = solve(problem, LoradsParams(verbose=False), device=device)
    X = res.R.cones[0][0].cpu().numpy()
    X = X @ X.T
    print(f"hand-built:   {res.status.value}  pObj={res.pobj:.6e}  "
          f"diag err={np.abs(np.diag(X) - 1).max():.1e}")
    return res


def batched(device):
    """Solve several same-shape instances as one batch."""
    probs = [generators.maxcut(n=120, avg_degree=5, seed=s)
             for s in range(4)]
    solver = LoradsSolver(merge_problems(probs), LoradsParams(verbose=False),
                          device=device)
    res = solver.solve()
    xs, lp_vals = solver.x_blocks(res.R)
    objs = split_objectives(probs, xs, lp_vals)
    print("batched maxcut objectives:",
          " ".join(f"{o:.4e}" for o in objs))
    return objs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    from_generator(device)
    hand_built(device)
    batched(device)
