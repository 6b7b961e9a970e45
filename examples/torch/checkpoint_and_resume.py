"""Checkpointing a solve of the PyTorch/CUDA port and resuming it in a
new solver, then a warm start from the exported solution (the twin of
examples/checkpoint_and_resume.py).  The checkpoint's layout is
lorads_tpu's: either package loads the other's files.

Run:  python examples/torch/checkpoint_and_resume.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from lorads_torch import LoradsParams, LoradsSolver
from lorads_torch.io import generators


def main(device, tmp):
    problem = generators.maxcut(n=300, avg_degree=6, seed=1)
    ckpt = os.path.join(tmp, "state.npz")
    sol = os.path.join(tmp, "solution.npz")

    # first session: solve with checkpoints at the phase boundaries
    params = LoradsParams(verbose=False, checkpoint_path=ckpt)
    s1 = LoradsSolver(problem, params, device=device)
    res1 = s1.solve()
    s1.save_solution(sol)
    print(f"first solve: {res1.status.value} gap={res1.gap:.1e} "
          f"-> checkpoint {ckpt}, solution {sol}")

    # second session: restore and continue (here: instant reconverge)
    s2 = LoradsSolver(problem, LoradsParams(verbose=False), device=device)
    meta = s2.load(ckpt)
    print(f"restored phase={meta['phase']} ranks={s2.ranks}")
    res2 = s2.solve()
    print(f"resumed solve: {res2.status.value} gap={res2.gap:.1e}")

    # third session: warm start from the exported factors and dual
    with np.load(sol) as z:
        fs = [z[f"f{i}"] for i in range(problem.n_sdp_blocks)]
        dual = z["y"]
    s3 = LoradsSolver(problem, LoradsParams(verbose=False), device=device)
    s3.set_initial_factors(fs, dual=dual)
    res3 = s3.solve()
    print(f"warm-started solve: {res3.status.value} "
          f"pObj={res3.pobj:.6e} (first {res1.pobj:.6e})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        main(ap.parse_args().device, tmp)
