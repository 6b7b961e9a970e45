"""CLI: the flags and DIMACS report of ``python -m lorads_tpu``.

Usage:  python -m lorads_torch <file.dat-s> [--device cuda|cpu] [...]

Flag names and defaults are lorads_tpu/__main__.py's (the reference
binary's getopt table, main.c:19-80) plus ``--device`` (default cuda), the
counterpart of JAX's platform choice.  Several input files merge
block-diagonally (``merge_problems``) into one batch solve, and each
instance's objective is reported at the end.  --checkpoint / --resume,
--warmStart / --solOut, --traceDir (a torch.profiler trace) and --dualUV
do what lorads_tpu's do (lorads_tpu/__main__.py:183-229).  --dtype f32
solves at float32 throughout; --dtype auto (the default) and f64 solve
at float64, on the CPU and on the card alike (the H100 runs f64
natively).  --shard auto|dp|sp|tp shards the solve over the ranks of a
torchrun launch (one process per card: ``python -m torch.distributed.run
--nproc_per_node=N -m lorads_torch FILE --shard sp``; NCCL on cards,
gloo with --device cpu), the group read from torchrun's environment;
only rank 0 prints the report and writes files.  Without a launch (one
rank) the solve runs unsharded and says so.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lorads_torch",
        description="PyTorch/CUDA low-rank SDP solver (LoRADS port)")
    p.add_argument("fname", nargs="+",
                   help="SDPA sparse-format .dat-s file(s); several "
                        "files merge block-diagonally into ONE batch "
                        "solve (per-instance objectives reported at "
                        "the end)")
    # reference getopt_long table (main.c:57-80)
    p.add_argument("--initRho", type=float, default=0.0)
    p.add_argument("--rhoMax", type=float, default=5000.0)
    p.add_argument("--rhoCellingALM", type=float, default=1e8)
    p.add_argument("--rhoCellingADMM", type=float, default=1e6)
    p.add_argument("--maxALMIter", type=int, default=200)
    p.add_argument("--maxADMMIter", type=int, default=10000)
    p.add_argument("--timesLogRank", type=float, default=None,
                   help="rank = ceil(timesLogRank * ln n) (reference"
                        " default 2.0; unset -> structure-based auto)")
    p.add_argument("--rhoFreq", type=int, default=5)
    p.add_argument("--rhoFactor", type=float, default=1.2)
    p.add_argument("--ALMRhoFactor", type=float, default=None,
                   help="ALM rho escalation factor (reference default"
                        " 2.0; unset -> structure-based auto)")
    p.add_argument("--phase1Tol", type=float, default=1e-3)
    p.add_argument("--phase2Tol", type=float, default=1e-5)
    p.add_argument("--timeSecLimit", type=float, default=3600.0)
    p.add_argument("--heuristicFactor", type=float, default=1.0)
    # reference default is 2; None -> structure-based auto (config.py)
    p.add_argument("--lbfgsListLength", type=int, default=None)
    p.add_argument("--endTauTol", type=float, default=1e-16)
    p.add_argument("--endALMSubTol", type=float, default=1e-10)
    p.add_argument("--l2Rescaling", type=int, default=0)
    p.add_argument("--reoptLevel", type=int, default=2)
    p.add_argument("--dyrankLevel", type=int, default=2)
    p.add_argument("--highAccMode", type=int, default=0)
    p.add_argument("--shard", choices=["off", "auto", "dp", "sp", "tp"],
                   default="off",
                   help="multi-device placement over the ranks of a "
                        "torchrun launch: dp (a bucket's blocks), sp (one "
                        "sparse cone's pattern), tp (one dense cone's "
                        "row slabs), auto (lorads_tpu's choice)")
    p.add_argument("--dualUV", type=int, default=0,
                   help="DUAL_U_V build variant: +/-S terms in the "
                        "ADMM subproblems")
    p.add_argument("--lpGaussSeidel", type=int, default=0,
                   help="update ADMM LP columns sequentially in the "
                        "exact reference order (lorads_admm.c:595-628; "
                        "kernel K8c) instead of the default vectorized "
                        "Jacobi sweep")
    # extensions of lorads_tpu
    p.add_argument("--dtype", choices=["auto", "f64", "f32"],
                   default="auto",
                   help="f32: a float32 solve; auto and f64: float64")
    p.add_argument("--seed", type=int, default=925)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="save solver state at phase boundaries")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="restore state from a checkpoint before solving")
    p.add_argument("--traceDir", default=None, metavar="DIR",
                   help="capture a torch.profiler trace (CPU and, on "
                        "the card, CUDA activity) into DIR")
    p.add_argument("--admmGapContinue", type=int, default=1,
                   help="after pinf converges, keep the initial ADMM "
                        "running with gap-inclusive convergence while "
                        "the gap improves, instead of conceding "
                        "gap > tol to a full reopt round (the "
                        "reference exits on pinf alone)")
    p.add_argument("--dualRepair", type=int, default=1,
                   help="exact dual shift along per-block identity "
                        "directions (theta trace, Max-Cut diag "
                        "family) to remove negative slack "
                        "eigenvalues; dinf re-measured post-shift")
    p.add_argument("--dualRefine", type=int, default=1,
                   help="when dinf still fails its band after the "
                        "repair, run the spectral dual repair, then, if "
                        "that is not accepted, fit the dual to "
                        "complementarity by CGNR and keep it only if the "
                        "re-measured dinf meets its band; 0 goes on to "
                        "level-2 reopt")
    p.add_argument("--warmStart", default=None, metavar="PATH",
                   help="seed the solve from a previous --solOut .npz "
                        "(per-block factors, LP values, dual); see "
                        "LoradsSolver.set_initial_factors")
    p.add_argument("--probInfo", action="store_true",
                   help="print the problem-information dump "
                        "(printfProbInfo equivalent) before solving")
    p.add_argument("--solOut", default=None, metavar="PATH",
                   help="write the solution to an .npz: per-block "
                        "factors f<i> (X_i = f_i f_i^T), LP values, "
                        "dual vector y")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; a missing GPU "
                        "raises) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.shard == "off" or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return _main(args)
    # a torchrun launch: one process a card, the group from its
    # environment; the ranks but 0 print nothing
    import torch.distributed as dist

    from lorads_torch.parallel import distributed
    distributed.init_multihost(device=args.device)
    out = sys.stdout
    if distributed.world()[0] != 0:
        sys.stdout = open(os.devnull, "w")
    try:
        return _main(args)
    finally:
        if sys.stdout is not out:
            sys.stdout.close()
            sys.stdout = out
        dist.destroy_process_group()


def _main(args) -> int:
    from lorads_torch.config import LoradsParams
    from lorads_torch.core.problem import (merge_problems,
                                           split_objectives_factors)
    from lorads_torch.io.sdpa import read_sdpa
    from lorads_torch.alg.solver import LoradsSolver
    from lorads_torch.utils.profiling import device_trace

    print("-" * 59)
    print(" LoRADS-torch  |  low-rank SDP solver on PyTorch/CUDA")
    print("-" * 59)

    t0 = time.time()
    problems = []
    for fname in args.fname:
        try:
            problems.append(read_sdpa(fname))
        except FileNotFoundError:
            print(f"error: input file not found: {fname}", file=sys.stderr)
            return 2
        except (OSError, ValueError, IndexError, StopIteration,
                UnicodeDecodeError) as e:
            print(f"error: could not parse SDPA file {fname}: {e}",
                  file=sys.stderr)
            return 2
    if len(problems) == 1:
        problem = problems[0]
    else:
        # one block-diagonal batch: same-shape blocks share a bucket,
        # whose disjoint constraint sets make ADMM sweep them at once
        problem = merge_problems(problems)
        print(f"merged {len(problems)} instances into one batch")
    print(f"Reading SDPA file in {time.time() - t0:.6f} seconds")
    print(f"nConstrs:{problem.m} nBlks:{problem.n_sdp_blocks} "
          f"nLpCols:{problem.n_lp_cols}")

    params = LoradsParams(
        fname=args.fname[0], init_rho=args.initRho, rho_max=args.rhoMax,
        rho_celling_alm=args.rhoCellingALM,
        max_alm_iter=args.maxALMIter, max_admm_iter=args.maxADMMIter,
        times_log_rank=args.timesLogRank, rho_freq=args.rhoFreq,
        rho_factor=args.rhoFactor, alm_rho_factor=args.ALMRhoFactor,
        phase1_tol=args.phase1Tol, phase2_tol=args.phase2Tol,
        time_sec_limit=args.timeSecLimit,
        heuristic_factor=args.heuristicFactor,
        lbfgs_list_length=args.lbfgsListLength,
        end_tau_tol=args.endTauTol, end_alm_sub_tol=args.endALMSubTol,
        l2_rescaling=bool(args.l2Rescaling), reopt_level=args.reoptLevel,
        dyrank_level=args.dyrankLevel, high_acc_mode=bool(args.highAccMode),
        dual_uv=bool(args.dualUV), dual_repair=bool(args.dualRepair),
        lp_gauss_seidel=bool(args.lpGaussSeidel),
        dual_refine=bool(args.dualRefine),
        admm_gap_continue=bool(args.admmGapContinue),
        shard=args.shard,
        dtype=args.dtype, seed=args.seed, verbose=not args.quiet,
        checkpoint_path=args.checkpoint, trace_dir=args.traceDir)

    solver = LoradsSolver(problem, params, device=args.device)
    if args.probInfo:
        print(solver.prob_info())
    if args.resume:
        meta = solver.load(args.resume)
        print(f"resumed from {args.resume} (phase {meta['phase']})")
    if args.warmStart:
        import zipfile

        import numpy as np
        try:
            with np.load(args.warmStart) as z:
                fs = [z[f"f{i}"] for i in range(problem.n_sdp_blocks)]
                lp_vals = z["lp"] if "lp" in z.files else None
                dual = z["y"] if "y" in z.files else None
            solver.set_initial_factors(fs, lp_vals, dual=dual)
        except (OSError, KeyError, ValueError,
                zipfile.BadZipFile) as e:
            # BadZipFile: np.load raises it (not OSError) for a
            # corrupt or truncated archive that still has the PK magic
            print(f"error: could not warm-start from "
                  f"{args.warmStart}: {e}", file=sys.stderr)
            return 2
        print(f"warm started from {args.warmStart}")
    with device_trace(args.traceDir, solver.device):
        res = solver.solve()

    print(f"final ranks: {res.ranks}")
    print("-" * 71)
    print(f"End Program with status `{res.status.value}`:")
    print("Objective function Value are:")
    print(f"\t 1.Primal Objective:            : {res.pobj:10.6e}")
    print(f"\t 2.Dual Objective:              : {res.dobj:10.6e}")
    print("Dimacs Error are:")
    print(f"\t 1.Constraint Violation(1)      : {res.pinf_l1:10.6e}")
    print(f"\t 2.Dual Infeasibility(1)        : {res.dinf_l1:10.6e}")
    print(f"\t 3.Primal Dual Gap              : {res.gap:10.6e}")
    print(f"\t 4.Primal Variable Semidefinite : {0.0:10.6e}")
    print(f"\t 5.Constraint Violation(Inf)    : {res.pinf_inf:10.6e}")
    print(f"\t 6.Dual Infeasibility(Inf)      : {res.dinf_inf:10.6e}")
    print("-" * 71)
    print(f"solve time (s): {res.solve_time:.6f}")
    print(f"dual infeasibility time (s): {res.dual_infeas_time:.6f}")
    if args.solOut:
        solver.save_solution(args.solOut)
        print(f"solution written to {args.solOut}")
    if len(problems) > 1:
        fs, lp_vals = solver.factor_blocks()
        objs = split_objectives_factors(problems, fs, lp_vals)
        print("per-instance objectives:")
        for fname, obj in zip(args.fname, objs):
            print(f"\t{fname}: {obj:10.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
