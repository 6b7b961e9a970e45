"""Smoke run of the PyTorch/CUDA port (lorads_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-of DIR   # phases 1-3 on DIR's port

Phases, each reported on its own lines:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. the build of the CUDA kernels from lorads_torch/csrc (one nvcc per
   source, in parallel, sm_90a);
3. each kernel against its plain PyTorch version on the card, with the
   tolerance stated, the kernel and plain times from CUDA events
   (dispatched: the host's launch included; the kernel's and the
   library's the median of 5 readings of 20 calls), the kernel's device
   time (20 calls in one CUDA graph, lorads_torch/timing.py), its bound (the
   larger of its bytes over 3.35 TB/s and its operations over the
   card's peak for the type) and, where one PyTorch call computes the
   same function, that call's time, dispatched and on the device:
   first the floors the small kernels are read against (an empty
   kernel's device time per call in a 20-call graph, one dependent
   shared-memory load, from lorads_torch/csrc/floor.cu);
   K1-K3 at the shapes of the Max-Cut path (maxcut n=20000, deg 8:
   Ks=160000, r = the solve's rank at f64; r=1 at f32 and f64 for the
   certificate; K3 with U != V and with U is V, the ALM's objective
   values, whose one dot an entry is first checked bit for bit against
   the two-dot path on a copy of U) plus the segment-sum edge cases; K2 at
   gset_torus10000's shapes (4 entries a row, r = 19 and 1) and on
   skewed rows (empty rows, one-entry rows, a hub row of 5000 entries,
   B = 1 and 2; beside torch.sparse.mm at B = 1); K3p, K3, K4, K5 and K6 at
   the shapes of the matrix-completion path (matcomp2000: n=4000,
   Ko=478843, Ks=957686, r = the solve's rank at f64, the f32 copies the
   mixed-precision CG and the f32 phase run, and K5 at r=1 in f32 and
   f64 for the
   certificate), K5 and K6 at f64 on maxcut n=20000's sparse pattern
   (Ko=80000, r=20: no tile worth staging), and K3, K3p, K5 and K6 on a
   skewed pattern (n=20000: a hub row, a 12 %-dense block, 4 random
   entries a row; r=17); K7a and K4 on the dense layouts at the shapes of the
   theta path (theta800: n=800, n^2=640000 slots, m=3201, nnz_a=4000)
   at f64 and in f32 as the mixed-precision CG runs them; K4 on skewed
   segment lengths (one-entry segments with segments of 800, 5000 and
   70000 entries among them, empty segments, B = 2, base and alpha),
   bit for bit on one-entry segments;
   the device loops (lorads_torch/alg/devloop.py), each replayed from
   its CUDA graph against the same run decided by host reads on the
   card from the same state, bit for bit: CG as a whole solve
   (matcomp2000 and theta800, the mixed-precision CG's f32 inner loop)
   with the graph's device ms and the eager solve's dispatched ms; three
   runs in a row of the ALM phase's outer loop (maxcut20000,
   matcomp2000, theta300) and of the ADMM chunk (theta800, multiblock22,
   multiblock_lp), launches equal, with the last replay's device ms;
   loop_cond (csrc/graph_cond.cu, the head and the tail of each
   conditional node) alone, a WHILE node of 1000 runs whose body is an
   add and the tail, µs a run beside the loop decided by host reads; at
   two real carried states (multiblock22's CG, maxcut20000's ALM inner
   loop): µs a run, the bytes the tail copies a run, their bound,
   torch._foreach_copy_ of the same leaves and the bodies' nodes; the
   kernel's eager launch against its plain version at the microbench's
   tail; its floor (a WHILE node whose body is the tail alone, and the
   same launches in a plain graph); every program site
   (lorads_torch.probes.loop_sites: each loop's exit test and each branch
   predicate) at f64 and f32 on seeded states with NaN, ±inf, ties and
   the caps, the kernel's decision, copies and counter against its plain
   version bit for bit; the certificate's restarted Lanczos
   (alg/lanczos.py)
   as one device loop, three certificates in a row at each instance's
   solved dual on maxcut20000 and gset_torus10000 (K2 at r = 1),
   matcomp2000 (K5 at r = 1) and maxcut20000x4 (B = 4), and the spectral
   repair's active sets (alg/spectral_repair.py) of theta_gtoy60's repair
   from the state in tests/fixtures/cert_states.npz, each replay against
   the same run made eagerly on the card, bit for bit, launches equal,
   one host read a replay (``cert`` and ``repair`` lines); then K9
   (sym_eig_small, csrc/sym_eig.cu) on the last Ritz problem and the last
   projected slack those runs solved ([1, 36, 36] and [4, 36, 36] at f32,
   [1, 48, 48] at f64) and on two shapes made from a seed (the repair's
   masked [1, 48, 48] at f64, its real width 24, built as
   alg/spectral_repair.py builds it; a [1, 36, 36] f32 matrix with
   exactly-zero rows in the middle and at the ends, as Lanczos breakdown
   slots leave them) against torch.linalg.eigh, its plain version and
   the library call (eigenvalues, residuals, orthogonality and the lowest
   vector within SYM_EIG_C n eps; a decoupled index's eigenpair exactly
   its diagonal and e_i), with the coupled count of each matrix, the
   sweeps and rounds each took, the microseconds a round, the bound and
   the dependent-step bound from the rounds run, and the step solve's
   torch.linalg.solve_ex captured into a CUDA graph, its replay bit for
   bit its eager call;
4. the main paths, each with the kernel launch counts reset just before
   it and read just after, through LoradsSolver(...).solve() on cuda at
   f64, each solve held to primal_dual_optimal and to lorads_tpu's CPU
   f64 objective within 1e-4 relative, its line giving the host syncs
   by label (device.HOST_SYNCS_BY: no ``alm_inner`` read, the ALM's
   ``alm`` reads one a run), the device-decided loops run by label, each
   run asserted to read the host once (a Lanczos certificate of a
   bucket one ``lanczos`` read, an active set one ``repair`` read), the
   loop graphs captured and replayed and the kernel launches the replays
   counted, and each path's conditional bodies' nodes by loop
   (devloop.BODY_NODES):
   - Max-Cut (split, diag-identity): maxcut(n=300, deg 4, seed 3) (ALM
     + closed-form ADMM, exact-eigh certificate), maxcut n=20000 (deg 8,
     seed 7) and tests/fixtures/gset_torus10000.rudy (Lanczos
     certificate on C @ X);
   - matrix completion (the general sparse path):
     tests/fixtures/matcomp500.dat-s (ALM, ADMM with mixed-precision CG,
     exact-eigh certificate) and bench.py's matcomp2000,
     matrix_completion(n1=2000, n2=2000, true_rank=3, frac_obs=0.12,
     seed=3) (ADMM with CG, Lanczos certificate on W @ X);
   - Lovász theta (dense buckets): tests/fixtures/theta_gtoy60.dat-s,
     tests/fixtures/theta300.dat-s and bench.py's theta800,
     lovasz_theta(n=800, avg_degree=8, seed=5) (ALM, ADMM with CG on the
     K7a operator, exact-eigh certificate, spectral dual repair);
   - the CGNR dual refinement: theta_gtoy60 with the spectral repair
     replaced by a reject in this process, so that the solve takes the
     CGNR refinement (K4 in every iteration; one graph replay and one
     host read a run), rejects its step and ends by the level-2 reopt,
     held to lorads_tpu's CPU run of the same forced path (status and
     objective);
   - multi-block and LP: tests/fixtures/hand_multiblock.dat-s (two dense
     one-block buckets on local slots, an LP block of 2 columns), solved
     with Jacobi and with Gauss-Seidel (K8c) LP sweeps;
     random_multiblock(22 blocks of dim 12, m=40, seed 21) (one dense
     bucket of 22 blocks sharing constraints: the bucket Gauss-Seidel
     scan); random_multiblock(8 blocks of dim 40, m=120, 400 LP
     columns, seed 5) with Gauss-Seidel LP sweeps;
   - a batch: merge_problems of four maxcut(n=20000, deg 8, seeds 7-10)
     (one split diag-identity bucket of 4 blocks on disjoint slots:
     ADMM would sweep them at once; K2, K3 and the Lanczos certificate
     at B = 4), the batch and each instance's objective held to
     lorads_tpu's solve of that instance alone.
   Phase 3 adds, at the shapes of that path: K8a / K8b (K4 on the LP's
   constraint- and column-sorted entries) and K8c (the Gauss-Seidel LP
   sweep, bit for bit, its time per dependent step beside the
   dependent-step bound: n x one dependent shared-memory load) at
   random_multiblock(8, 40, 120, 400 LP columns)'s LP block and at
   m=30000 (csum in global memory; the label names the instantiation),
   each without and with the DUAL_U_V term s (a random signed [n]); K8a,
   K8b and K8c (m=120) at f32 too, as the f32 phase runs them (K8c's f32
   chain within K8C_F32_TOL, its line saying whether it was bit for bit),
   K4's scatter of its 8 blocks' local constraint values, and K2 / K3 at
   the maxcut batch's B = 4 (K3 with U is V against
   torch.sparse.sampled_addmm, the same off values);
   - the probes (lorads_torch.probes, the counterparts of the Pallas
     kernels of tools/probes/): phase 3 holds P1 onehot_scatter and P2
     onehot_gather (tensor-core one-hot window products), P3 row_gather
     and P4 scatter_add to their plain versions at the probes' shapes
     (n=20000, K=80000-160000, r=20-24; P3's 1-D gather also at gE's
     [100000] table by 20000 ids; P4 on unsorted ids, on sorted ids and
     on sorted ids with a hub of 5000), P2 and P3's transposed layout
     at their edge shapes too (P3 under each of its schedules: R = 1, 3,
     24, 40, K = 1, n past a block's shared memory; its 1-D gather under
     each way at K = 1-7, ids not 16-byte aligned, [n] and [n, 1]; P2 at
     r = 3-40, K not a multiple of 16, spans past a 16-row chunk, X not
     16-byte aligned), bit for bit, P4 at its edges (r = 1, 2, 5, 24, K
     = 0-5000, values not 16-byte aligned, a hub; rows no id touches
     exactly 0 from memory that held NaN), and K3 at the fused uvT probe's
     shape (R=24, n=20000, K=100000, f32); the path is the probe driver,
     `python -m lorads_torch.probes --small`, run in this process;
5. the extras, with the launch counts reset just before and read just
   after (their launches add to the kernels line): maxcut20000 solved
   with checkpoints at both phase boundaries (their host reads
   counted), then resumed from the checkpoint and warm-started from
   ``save_solution``'s file, each certified within 1e-4 of the first
   solve, with walls and ALM inner counts; one solve inside
   ``utils.profiling.device_trace`` (its loops run eagerly under the
   trace, ROADMAP §3 F4; a later solve of the problem object, so its
   construction comes from the memo and the trace starts with the ALM's
   kernels), the trace holding at least an event a launch of its ALM
   phase's and its certificates' kernels (K2, K3, K9) and a kernel event
   for every launch it records, and a hand_multiblock solve traced
   through its ADMM phase, the trace holding its ADMM's kernels (and
   every launch's kernel event);
   ``fix_init_point`` on maxcut20000 (max_alm_iter=2: one nrm2U line
   per inner step, all finite) and its trace on the card against the
   CPU run in this process: maxcut300's first 2 values (after that step
   the all-ones factor sits where the gradient is rounding noise) and
   matcomp500's first 10, within 1e-9; ``dual_uv`` on multiblock_lp
   (the Gauss-Seidel LP sweep: K8c with s) and hand_multiblock (the LP
   Jacobi update), held to lorads_tpu's CPU status and pObj
   (REFERENCE_DUAL_UV); the CLI in this process on
   tests/fixtures/maxcut2000.dat-s: --dualUV 1 --checkpoint --solOut,
   --resume, --warmStart, a corrupt warm-start file (exit 2), --traceDir,
   with the SDPA reader that ran;
6. the f32 phase (lines "f32 ..."): three ALM runs of maxcut20000 at f32
   and three f64 ADMM chunks of matcomp2000 after its f32 ALM phase and
   the escalation its solve takes at ADMM entry, each replay against the
   same run made eagerly, bit for bit; then, with the launch counts reset
   just before and read just after, four solves through LoradsSolver at
   ``dtype="f32"``: maxcut20000 (pure f32: K2, K3 and K9 at f32 in the
   ALM and Lanczos graphs), matcomp2000 (auto: K3p-K6 at f32, the
   escalation to f64 at ADMM entry, the f64 graphs captured anew),
   theta300 (auto: K4 and K7a at f32) and multiblock_lp (pure f32: K8a-c
   at f32 in the ADMM graph), each held to lorads_tpu's CPU run from the
   same start (status, escalations, pObj within its band; multiblock_lp
   to lorads_tpu's run from the card's own state at the end of the f32
   ALM phase, FROM_CARD_ALM), its backend
   lines, one read a device-loop run, its f32 launches
   (kernels.F32_LAUNCHES), the escalation's seconds and the captures
   after it, its log without the per-iteration lines, and its f32 wall
   beside the main path's f64 wall of the same instance;
7. the shard phase (lines "shard ..."; the card is one, so no run has
   more than one rank): maxcut20000 and matcomp2000 as summed D = 4
   layouts and theta800 as a rowshard D = 4 layout swapped into the
   solver's ProblemData (unplaced), solved with the launch counts reset
   just before and read just after, held to REFERENCE_POBJ, each solve's
   wall beside the main path's (construction and the shard build apart);
   the kernels at those shapes against their
   plain versions, beside the library call on the four shards as one
   block-diagonal CSR matrix; on a one-rank NCCL group the building blocks against
   their oracles and shard="auto" against the unsharded solve, with the
   collectives counted by site; whether an NCCL all_reduce captures
   into a plain graph and a WHILE body (a child process; the phase fails
   unless both capture and replay bit for bit);
8. the memo phase (lines "memo ..."), with the launch counts reset just
   before and read just after: maxcut20000 and matcomp2000 constructed
   and solved twice on one problem object, the second construction
   from the memo (the same presolve and device tensors) and its solve
   bit for bit the first, with the construction seconds, walls and
   device memory of each; matcomp2000's escalated auto solve from an
   f32 start, then f32 solves of the same object (the evicted f32 data
   held by an earlier solver, and rebuilt by a later construction), each
   bit for bit a fresh object's; multiblock22 and multiblock_lp with
   group_buckets=False (one B = 1 bucket a block) held to lorads_tpu's
   ungrouped CPU f64 pObj (REFERENCE_UNGROUPED), beside the main path's
   grouped solves.

The line before the last is the JSON kernel summary; the last line is
{"ok": true, "device": {...}}.  Any failed phase raises and exits
nonzero without that line.  Needs no network and no JAX.

With --kernels-of DIR only phases 1-3 run, on the lorads_torch of the
checkout at DIR (built into DIR/build), timed by this checkout's
lorads_torch/timing.py, K9 on its two seeded shapes, and loop_cond's
microbench and real-state runs (no floor); the last line is
{"kernels_of": DIR, "cases": {kernel: [case, ...]}}.  Two checkouts
compare on one card by running both in one call, in turns.
--eig-inputs FILE: a whole run writes the K9 inputs the main paths gave
there (torch.save); a --kernels-of run reads them and times K9 on them
too, so that two checkouts' K9 meet the same main-path inputs.
"""

import contextlib
import functools
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
# the checkout whose kernels a --kernels-of run times (None: this one)
KERNELS_OF = None


def _gen():
    from lorads_torch.io import generators
    return generators


def _sdpa(name):
    from lorads_torch.io.sdpa import read_sdpa
    return read_sdpa(os.path.join(FIX, name))


# the main paths' instances, by name (profile_solve.py reads them too)
INSTANCES = {
    "maxcut300": lambda: _gen().maxcut(n=300, avg_degree=4, seed=3),
    "maxcut20000": lambda: _gen().maxcut(n=20000, avg_degree=8, seed=7),
    "gset_torus10000": lambda: _gen().maxcut_from_graph(
        os.path.join(FIX, "gset_torus10000.rudy")),
    "matcomp500": lambda: _sdpa("matcomp500.dat-s"),
    "matcomp2000": lambda: _gen().matrix_completion(
        n1=2000, n2=2000, true_rank=3, frac_obs=0.12, seed=3),
    "theta_gtoy60": lambda: _sdpa("theta_gtoy60.dat-s"),
    "theta300": lambda: _sdpa("theta300.dat-s"),
    "theta800": lambda: _gen().lovasz_theta(n=800, avg_degree=8, seed=5),
    "hand_multiblock": lambda: _sdpa("hand_multiblock.dat-s"),
    "hand_multiblock_gs": lambda: _sdpa("hand_multiblock.dat-s"),
    "multiblock22": lambda: _gen().random_multiblock(
        n_blocks=22, dim=12, m=40, density=0.3, seed=21),
    "multiblock_lp": lambda: _gen().random_multiblock(
        n_blocks=8, dim=40, m=120, density=0.05, n_lp=400, seed=5),
    "maxcut20000x4": lambda: _merged([_gen().maxcut(
        n=20000, avg_degree=8, seed=s) for s in (7, 8, 9, 10)]),
}
# solver options of an instance (default LoradsParams otherwise)
PARAMS = {"hand_multiblock_gs": dict(lp_gauss_seidel=True),
          "multiblock_lp": dict(lp_gauss_seidel=True)}


def _merged(problems):
    from lorads_torch.core.problem import merge_problems
    merged = merge_problems(problems)
    merged.parts = problems          # for the per-instance objectives
    return merged


# lorads_tpu on CPU at f64 (objective of each main-path instance)
REFERENCE_POBJ = {
    "maxcut300": -5.046605560e+02,
    "maxcut20000": -6.209725666e+04,
    "gset_torus10000": -7.762241872e+03,
    "matcomp500": 3.021053389e+03,
    "matcomp2000": 1.204995184e+04,
    "theta_gtoy60": -24.209496946891917,
    "theta300": -154.24257520621822,
    "theta800": -426.5939149561383,
    "hand_multiblock": 0.21774877836010853,
    "hand_multiblock_gs": 0.21774893891060546,
    "multiblock22": 106.14210206550646,
    "multiblock_lp": 191.50494359343332,
    # the batch's optimum is the sum of its instances': lorads_tpu's
    # single-instance solves below, summed
    "maxcut20000x4": -248319.05656104838,
}
# lorads_tpu on CPU at f64, each instance of the merged maxcut batch
# solved alone (seeds 7-10).  lorads_tpu's own merged solve of the batch
# stops 2.4e-4 lower (-248378.72611070029, after growing the rank from 20
# to 30): the two certified answers lie further apart than the 1e-4 band,
# so the batch is held to the instances, as a batch must equal them.
REFERENCE_SPLIT = {"maxcut20000x4": (-62097.25666, -62076.14471913608,
                                     -62080.6703693886, -62064.98481252369)}
# lorads_tpu on CPU at f64 with its spectral dual repair forced to reject:
# the CGNR refinement rejects its step (dinf 3.28e-04 before and after),
# two level-2 reopts leave dinf at 2.58e-04, outside its band
REFERENCE_CGNR = {"theta_gtoy60": ("primal_optimal", -24.214264131151737)}
# lorads_tpu on the CPU at f64 with group_buckets=False (one B = 1
# bucket a block; multiblock_lp with lp_gauss_seidel, as PARAMS):
# status and pObj
REFERENCE_UNGROUPED = {
    "multiblock22": ("primal_dual_optimal", 106.14212291906651),
    "multiblock_lp": ("primal_dual_optimal", 191.50495799143337),
}
# lorads_tpu on the CPU at f64 with dual_uv=True (multiblock_lp with
# lp_gauss_seidel, as PARAMS): status and pObj
REFERENCE_DUAL_UV = {
    "hand_multiblock": ("primal_dual_optimal", 0.2177524570925113),
    "multiblock_lp": ("primal_dual_optimal", 191.50494275108673),
}
# lorads_tpu on the CPU (x86-64) from the start the f32 phase gives each
# instance: LoradsParams(dtype="f32") with PARAMS, and where ``auto`` the
# solver's _auto_dtype set (an auto solve started at f32, as lorads_tpu's
# own tests reach its escalation): (auto, status, the escalation reasons
# in order, pObj)
REFERENCE_F32 = {
    "maxcut20000": (False, "primal_dual_optimal", [], -62097.38671875),
    "matcomp2000": (True, "primal_dual_optimal",
                    ["ADMM pinf target 2.4e-10 below the f32 floor"],
                    12049.951835553655),
    "theta300": (True, "primal_dual_optimal", [], -153.58482360839844),
    "multiblock_lp": (False, "primal_dual_optimal", [], 191.5049591064453),
}
# where the card's f32 trajectory parts from the CPU's before the hooks
# decide: lorads_tpu on the CPU resumed from the card's own state at the
# end of the f32 ALM phase (saved with LoradsSolver.save on an NVIDIA
# H100 80GB HBM3): (that state's ALM inner iterations, pObj and dObj,
# (status, escalation reasons, pObj) of lorads_tpu's run from it).
# multiblock_lp at pure f32: the card's ALM exit lies 3e-3 from the CPU's
# in dObj (summation order of torch's CUDA operations: every kernel of
# the path swapped for its plain version gives the same run bit for
# bit), ADMM's retry then ends inside the gap continuation's window
# (gap 3.0e-5 against the CPU's 1.2e-3), the continuation plateaus and
# the f32 reopts at rho 198-1122 take tau = 0: max_iter, as lorads_tpu's
# own run from that state
FROM_CARD_ALM = {
    "multiblock_lp": ((229, 191.88229370117188, 192.05914306640625),
                      ("max_iter", [], 191.52406311035156)),
}
# where lorads_tpu's f32 run lands outside POBJ_RTOL of the f64 optimum,
# or ends uncertified: the distance measured between the port's f32 pObj
# on the card (NVIDIA H100 80GB HBM3, 700 W) and lorads_tpu's f32 pObj on
# the CPU from the same start (theta300: -153.621826171875 against
# -153.58482360839844; multiblock_lp from the card's ALM exit, both
# max_iter: 191.5050048828125 against 191.52406311035156); f32_band holds
# pObj within twice it
F32_SPREAD = {"theta300": 2.41e-4, "multiblock_lp": 9.95e-5}
# the escalation the f32 phase's graph check takes on matcomp2000 after
# its f32 ALM phase: the reason its solve gives at ADMM entry
ESCALATE_CHECK = REFERENCE_F32["matcomp2000"][2][0]
# the kernels each main path must launch
PATH_KERNELS = {
    "maxcut": ("cmul_csr", "uvt_split", "sym_eig_small", "loop_cond"),
    "matcomp": ("uvt_split", "uvt_pair_split", "gather_segsum", "wmul_csr",
                "adj_a_offdiag", "sym_eig_small", "loop_cond"),
    "theta": ("gather_segsum", "adj_a_dense", "sym_eig_small", "loop_cond"),
    "cgnr": ("gather_segsum", "adj_a_dense"),
    "lp": ("gather_segsum", "lp_gs_sweep", "loop_cond"),
    "batch": ("cmul_csr", "uvt_split", "sym_eig_small"),
    "extras": ("cmul_csr", "uvt_split", "gather_segsum", "lp_gs_sweep"),
    # the f32 phase, by instance: the kernels launched at f32
    "f32 maxcut20000": ("cmul_csr", "uvt_split", "sym_eig_small"),
    "f32 matcomp2000": ("uvt_split", "uvt_pair_split", "gather_segsum",
                        "wmul_csr"),
    "f32 theta300": ("gather_segsum", "adj_a_dense"),
    "f32 multiblock_lp": ("gather_segsum", "lp_gs_sweep"),
    "probes": ("onehot_scatter", "onehot_gather", "row_gather",
               "scatter_add", "uvt_split"),
    # the shard phase, by instance: its solves on the shard layouts
    "shard maxcut20000": ("cmul_csr", "uvt_split", "sym_eig_small",
                          "loop_cond"),
    "shard matcomp2000": ("uvt_split", "uvt_pair_split", "gather_segsum",
                          "wmul_csr", "sym_eig_small", "loop_cond"),
    "shard theta800": ("gather_segsum", "sym_eig_small", "loop_cond"),
    "shard blocks": ("gather_segsum", "uvt_split", "wmul_csr"),
    # the memo phase: maxcut20000's and matcomp2000's repeat solves, the
    # escalation and the ungrouped multi-block solves
    "memo": ("cmul_csr", "uvt_split", "uvt_pair_split", "gather_segsum",
             "wmul_csr", "adj_a_offdiag", "sym_eig_small", "loop_cond",
             "lp_gs_sweep"),
    "ungrouped multiblock22": ("gather_segsum", "loop_cond"),
    "ungrouped multiblock_lp": ("gather_segsum", "lp_gs_sweep",
                                "loop_cond"),
}
# the memo phase's f32 solves of matcomp2000: ADMM iterations at most
# (its target lies below the f32 floor; the cap keeps the run short and
# the same for every solve compared)
F32_MEMO_ADMM = 300
# the shard phase's layouts at full width, unplaced: (instance, layout,
# shards)
SHARD_LAYOUTS = (("maxcut20000", "sp", 4), ("matcomp2000", "sp", 4),
                 ("theta800", "tp", 4))
POBJ_RTOL = 1e-4
# K8c at f32 against its plain version, of each output's largest
# magnitude: 64 eps32
K8C_F32_TOL = 64 * 2.0 ** -23
# the card's device-memory rate, its peak rates outside the tensor cores
# and its dense tensor-core peaks (NVIDIA H100 SXM data sheet: 67 TFLOP/s
# f32, 34 TFLOP/s f64; tensor cores 989 TFLOP/s bf16, 494 TFLOP/s TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"f32": 67e12, "f64": 34e12, "bf16": 989e12,
                   "tf32": 494e12}


@functools.lru_cache(maxsize=None)
def timing():
    """This checkout's lorads_torch/timing.py, loaded by its path, so that
    --kernels-of times another checkout's kernels with the same code."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "lorads_torch", "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(name, got, ref, bound):
    """max |got - ref| against an elementwise bound; returns the max
    absolute error."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    bound = bound if isinstance(bound, tuple) else (bound,)
    err = 0.0
    for g, r, b in zip(got, ref, bound):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: bad output {tuple(g.shape)}")
        diff = (g.double() - r.double()).abs()
        ok = bool((diff <= b).all())
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not ok:
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max err {err:.3e}, worst ratio "
                f"{float((diff / b.clamp(min=1e-300)).max()):.3e})")
    return err


def twice(spread):
    """Twice a measured spread, rounded up to 1, 2 or 5 times a power of
    ten."""
    e = 10.0 ** math.floor(math.log10(2 * spread))
    return next(m * e for m in (1, 2, 5, 10) if m * e >= 2 * spread)


def f32_band(name):
    """(reference pObj, band) an f32 solve's pObj is held to: the f64
    optimum (REFERENCE_POBJ) within POBJ_RTOL where lorads_tpu's f32 run
    lands inside that band; else lorads_tpu's f32 pObj (REFERENCE_F32;
    FROM_CARD_ALM's where the instance has one) within twice F32_SPREAD."""
    if name in FROM_CARD_ALM:
        return FROM_CARD_ALM[name][1][2], twice(F32_SPREAD[name])
    ref, got = REFERENCE_POBJ[name], REFERENCE_F32[name][3]
    if abs(got - ref) <= POBJ_RTOL * abs(ref):
        return ref, POBJ_RTOL
    return got, twice(F32_SPREAD[name])


def bound_of(nbytes, flops, sfx):
    """(least ms the card could take, what bounds it): the bytes the
    function must move over the memory rate, or its operations over the
    peak rate for its type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[sfx] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Measure:
    """Runs one kernel case: the kernel and its plain version on the same
    inputs, the check against the stated tolerance (and bit equality
    where asked), CUDA-event times of the kernel, the plain version and
    the one-call library counterpart (if any), dispatched (``ms``: the
    host's launch included) and on the device alone (``device_ms``: 20
    calls in one CUDA graph, or the profiler's kernel time for a call a
    graph cannot hold), and the bound."""

    def __init__(self, card):
        self.card = card
        self.results = {}

    def __call__(self, kname, label, sfx, fn, plain, l1, nbytes, flops,
                  library=None, exact=None, tol=None, steps=None,
                  step_ns=None):
        import numpy as np
        import torch

        cuda_time_ms, device_time_ms = (timing().cuda_time_ms,
                                        timing().device_time_ms)
        got = fn()
        ref = plain()
        torch.cuda.synchronize()
        if tol is None:
            # f64: both sides sum the same terms directly in another
            # order; f32: compensated kernel vs the plain version's f64
            # accumulation (K1, K2, K4, K5) or f32 row dots of r terms
            tol = (64 * float(np.finfo(np.float64).eps) if sfx == "f64"
                   else 4 * float(np.finfo(np.float32).eps))
        bound = tuple(tol * a.double() + 1e-300 for a in l1) \
            if isinstance(l1, tuple) else tol * l1.double() + 1e-300
        err = check(f"{kname} {label}", got, ref, bound)
        exact_note = ""
        if exact is not None:
            for g, e in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                sel = (slice(None),) if exact is True else (slice(None),
                                                            exact)
                if not torch.equal(g[sel], e[sel]):
                    raise AssertionError(f"{kname} {label}: not exact")
            exact_note = (", exact" if exact is True else
                          f", exact on {int(exact.sum())} single-entry "
                          "segments")
        # dispatched: the median of 5 readings (the host's share moves
        # between readings on a shared host)
        ms = statistics.median(cuda_time_ms(fn) for _ in range(5))
        pms = cuda_time_ms(plain)
        dev_ms, dev_by = device_time_ms(fn)
        lib_ms = lib_dev_ms = lib_dev_by = None
        if library is not None:
            lib_ms = statistics.median(cuda_time_ms(library)
                                       for _ in range(5))
            lib_dev_ms, lib_dev_by = device_time_ms(library)
        bms, by = bound_of(nbytes, flops, sfx)
        # a sequential kernel: its time per dependent step, beside the
        # least one step can take (step_ns, measured) and n such steps
        step_note = ""
        if steps is not None and dev_ms is not None:
            step_note = (f" ({dev_ms / steps * 1e3:.4f} us per dependent "
                         "step on the device; dependent-step bound ")
            step_note += ("not measured)" if step_ns is None else
                          f"{step_ns * 1e-3:.4f} us per step, "
                          f"{steps * step_ns * 1e-6:.6f} ms)")

        def fmt(t, how):
            return "none" if t is None else f"{t:.4f} ms ({how})"

        print(f"{kname} [{label}]: max_abs_err {err:.3e} (tol {tol:.1e} x "
              f"|terms|{exact_note}) kernel {ms:.4f} ms device "
              f"{fmt(dev_ms, dev_by)} plain {pms:.4f} ms library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} device "
              f"{fmt(lib_dev_ms, lib_dev_by)} bound {bms:.6f} ms{step_note} "
              f"({by}: {nbytes} B, {flops} flop)  [{self.card}]")
        self.results.setdefault(kname, []).append(dict(
            label=label, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms,
            us_per_step=(None if steps is None or dev_ms is None
                         else dev_ms / steps * 1e3),
            step_bound_us=None if step_ns is None else step_ns * 1e-3))


def _csr(rows, cols, vals, shape):
    """A torch CSR tensor of the entries (duplicates summed), for the
    library timings; shape (rows, cols), or n for n x n."""
    import torch
    if isinstance(shape, int):
        shape = (shape, shape)
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                  vals, shape).coalesce()
    return coo.to_sparse_csr()


def _blockdiag_csr(rows, cols, vals, n, extra=None):
    """The B blocks' [B, K] entry lists (padding: value 0) as one
    block-diagonal [B n, B n] CSR matrix, for the library timings at
    B > 1; ``extra``: (rows, cols, vals) of the same blocks added (a
    diagonal)."""
    import torch
    B = rows.shape[0]
    off = (torch.arange(B, device=rows.device) * n)[:, None]
    parts = [(rows, cols, vals)] + ([extra] if extra is not None else [])
    return _csr(torch.cat([(r.long() + off).reshape(-1) for r, _, _ in
                           parts]),
                torch.cat([(c.long() + off).reshape(-1) for _, c, _ in
                           parts]),
                torch.cat([v.reshape(-1) for _, _, v in parts]), B * n)


def _seg_csr(idx, val, bnd, ncols, alpha=1.0):
    """K4's entry lists of its B blocks as one block-diagonal [B S, B
    ncols] CSR matrix whose row b S + s holds alpha * val at the columns
    idx of block b's segment s, so that K4 is one sparse product of the
    flattened x: out = base + M @ x (library timings only)."""
    import torch
    B, S = bnd.shape[0], bnd.shape[1] - 1
    rows, cols, vals = [], [], []
    for b in range(B):
        bb = bnd[b].long()
        lo, hi = int(bb[0]), int(bb[-1])
        rows.append(b * S + torch.repeat_interleave(
            torch.arange(S, device=bb.device), bb.diff()))
        cols.append(b * ncols + idx[b, lo:hi].long())
        vals.append(alpha * val[b, lo:hi])
    return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                (B * S, B * ncols))


def _seg_library(M, x, base=None):
    """The one-call counterpart of K4 over its blocks: torch.sparse.mm
    of the flattened x, or torch.addmm with the flattened base."""
    import torch
    xc = x.reshape(-1, 1)
    if base is None:
        return lambda: torch.sparse.mm(M, xc)
    bc = base.reshape(-1, 1)
    return lambda: torch.addmm(bc, M, xc)


def launch_floors(card):
    """The floors the small kernels are read against, from the
    instruments of csrc/floor.cu (None where the checkout has none): an
    empty kernel's device time per call in a 20-call CUDA graph, and one
    dependent shared-memory load (ns and cycles, 100000 in a chain)."""
    import torch

    from lorads_torch.ops import build
    lib = build.load()
    if not hasattr(lib, "lt_smem_chase"):
        print("floors: not measured (no csrc/floor.cu in this checkout)")
        return {"empty_ms": None, "hop_ns": None}

    def empty():
        if lib.lt_empty(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("lt_empty: launch failed")

    empty_ms, how = timing().device_time_ms(empty)
    hops = 100000
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    for _ in range(2):               # the first call warms the clocks
        rc = lib.lt_smem_chase(hops, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lt_smem_chase: launch failed ({rc})")
    ns, cycles, _ = (int(v) for v in out.cpu())
    hop_ns = ns / hops
    print(f"floors: empty kernel {empty_ms:.5f} ms per call ({how}, 20 "
          f"calls); one dependent shared-memory load {hop_ns:.3f} ns "
          f"({cycles / hops:.2f} cycles, {cycles / ns:.3f} GHz)  [{card}]")
    return {"empty_ms": empty_ms, "hop_ns": hop_ns}


def kernel_checks(card):
    """Phase 3: every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    measure = Measure(card)
    measure.floors = launch_floors(card)

    problem = generators.maxcut(n=20000, avg_degree=8, seed=7)
    ps = presolve(problem, LoradsParams())
    bp = ps.buckets[0]
    r = bp.rank
    bk64 = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    bk32 = pat.cast_floats(bk64, torch.float32)
    n, Ks, Ko = bk64.n, bk64.Ks, bk64.Ko
    print(f"main-path shapes: n={n} Ks={Ks} Ko={Ko} rank={r}")

    # ---- K2 cmul_csr at maxcut n=20000's shapes
    cmul_cases(rng, measure, bk64, bk32, r, "")

    # ---- K3 uvt_split, U != V and U is V (the ALM's objective values)
    U = torch.as_tensor(rng.standard_normal((1, n, r)), device=dev)
    V = torch.as_tensor(rng.standard_normal((1, n, r)), device=dev)
    Poff = _csr(bk64.off_rows[0], bk64.off_cols[0],
                torch.ones(Ko, dtype=torch.float64, device=dev), n)
    kw = _tiles_kw(pat, bk64, "off", kernels.uvt_split)
    for VV in (V, None):
        uvt_cases(measure, kernels, "", "f64", U, VV, bk64.off_rows,
                  bk64.off_cols, kw, n, Ko, Poff)

    # ---- K1 segment_sum: the segment sum cmul fuses, unfused: [1, Ks, r]
    # products over the row pointers of the maxcut n=20000 entry list
    # (library: torch.segment_reduce)
    contrib = (bk64.c_sym_rs[:, :, None]
               * U[0].index_select(0, bk64.sym_cols_rs[0].long())[None])
    offs = bk64.bnd_sym_rows.long()
    for dt in (torch.float64, torch.float32):
        sfx = "f64" if dt == torch.float64 else "f32"
        s = 8 if dt == torch.float64 else 4
        data = contrib.to(dt).contiguous()
        bnd = bk64.bnd_sym_rows
        measure("segment_sum", f"main-path {sfx} r={r}", sfx,
                lambda: kernels.segment_sum(data, bnd),
                lambda: kernels.segment_sum_plain(data, bnd),
                kernels.segment_sum_plain(data.abs(), bnd),
                nbytes=Ks * r * s + (n + 1) * 4 + n * r * s,
                flops=Ks * r,
                library=lambda: torch.segment_reduce(
                    data, "sum", offsets=offs, axis=1))
    segment_sum_edges(rng, dev)
    # ---- K2 at gset_torus10000's shapes (4 entries a row) and on skewed
    # row lengths
    problem = INSTANCES["gset_torus10000"]()
    bp = presolve(problem, LoradsParams()).buckets[0]
    bkg = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    print(f"gset-path shapes: n={bkg.n} Ks={bkg.Ks} rank={bp.rank}")
    cmul_cases(rng, measure, bkg, None, bp.rank, " gset_torus10000")
    cmul_skewed(rng, dev)
    matcomp_kernel_checks(rng, measure)
    theta_kernel_checks(rng, measure)
    gather_segsum_skewed(rng, dev)
    multiblock_kernel_checks(rng, measure)
    probe_kernel_checks(rng, measure)
    return measure


def cmul_cases(rng, measure, bk64, bk32, r, where):
    """K2 on a Max-Cut bucket: f64 at the rank with the diagonal (C @ D,
    C @ V), r=1 without it (the Lanczos SpMV) at f64 and, given bk32, at
    f32 (library: torch.sparse.mm on C as a CSR tensor)."""
    import torch

    from lorads_torch.ops import kernels
    n, Ks = bk64.n, bk64.Ks
    dev = bk64.c_diag.device
    diag = torch.arange(n, device=dev)
    cases = [("f64 r=%d diag" % r, bk64, torch.float64, r, True),
             ("f64 r=1 no-diag", bk64, torch.float64, 1, False)]
    if bk32 is not None:
        cases.append(("f32 r=1 no-diag", bk32, torch.float32, 1, False))
    for label, bk, dt, rr, wd in cases:
        sfx = label[:3]
        s = 8 if dt == torch.float64 else 4
        X = torch.as_tensor(rng.standard_normal((1, n, rr)), device=dev,
                            dtype=dt)
        cd = bk.c_diag if wd else None
        args = (X, cd, bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
        rows = torch.cat([bk.sym_rows_rs[0]] + ([diag] if wd else []))
        cols = torch.cat([bk.sym_cols_rs[0]] + ([diag] if wd else []))
        vals = torch.cat([bk.c_sym_rs[0]] + ([bk.c_diag[0]] if wd else []))
        C = _csr(rows, cols, vals, n)
        X0 = X[0]
        l1 = kernels.cmul_csr_plain(
            X.abs(), bk.c_diag.abs() if wd else None, bk.sym_cols_rs,
            bk.c_sym_rs.abs(), bk.bnd_sym_rows)
        measure("cmul_csr", label + where, sfx,
                lambda: kernels.cmul_csr(*args),
                lambda: kernels.cmul_csr_plain(*args), l1,
                nbytes=2 * n * rr * s + Ks * (4 + s) + (n + 1) * 4
                + (n * s if wd else 0),
                flops=2 * Ks * rr + (2 * n * rr if wd else 0),
                library=lambda: torch.sparse.mm(C, X0))


def cmul_skewed(rng, dev):
    """K2 against its plain version on skewed row lengths (10 % empty
    rows, one-entry rows, rows of 2-8 entries and a hub row of 5000
    entries among n=20000; B = 2 with the second block's lengths
    permuted and its hub cut by 1000), f64 and f32, r = 1 without and
    r = 20 with the diagonal: within 64 eps64 / 4 eps32 x the sum of
    |terms| of each output.  At B = 1, r = 20 beside the library call:
    torch.sparse.mm of C (entries and diagonal) as a CSR tensor."""
    import numpy as np
    import torch

    from lorads_torch.ops import kernels
    device_time_ms = timing().device_time_ms
    n = 20000
    lengths = rng.integers(1, 9, n)
    lengths[rng.random(n) < 0.3] = 1
    lengths[rng.random(n) < 0.1] = 0
    lengths[n // 3] = 5000
    second = rng.permutation(lengths)
    second[np.argmax(second)] -= 1000
    for B in (1, 2):
        lens = np.stack([lengths, second][:B])
        Ks = int(lens.sum(axis=1).max())
        bnd = np.zeros((B, n + 1), np.int32)
        bnd[:, 1:] = np.cumsum(lens, axis=1)
        bnd = torch.as_tensor(bnd, device=dev)
        cols = torch.as_tensor(rng.integers(0, n, (B, Ks)).astype(np.int32),
                               device=dev)
        for dt in (torch.float64, torch.float32):
            tol = (64 if dt == torch.float64 else 4) * torch.finfo(dt).eps

            def rand(*shape):
                return torch.as_tensor(rng.standard_normal(shape),
                                       device=dev, dtype=dt)

            vals = rand(B, Ks)
            for r, cd in ((1, None), (20, rand(B, n))):
                X = rand(B, n, r)
                args = (X, cd, cols, vals, bnd)
                got = kernels.cmul_csr(*args)
                ref = kernels.cmul_csr_plain(*args)
                l1 = kernels.cmul_csr_plain(
                    X.abs(), None if cd is None else cd.abs(), cols,
                    vals.abs(), bnd)
                torch.cuda.synchronize()
                label = (f"skewed B={B} n={n} Ks={Ks} hub 5000 "
                         f"{str(dt)[6:]} r={r} "
                         f"{'diag' if cd is not None else 'no-diag'}")
                err = check(f"cmul_csr {label}", got, ref,
                            tol * l1.double() + 1e-300)
                dev_ms, how = device_time_ms(lambda: kernels.cmul_csr(*args))
                lib = ""
                if B == 1 and cd is not None:
                    diag = torch.arange(n, device=dev)
                    rows = torch.repeat_interleave(
                        diag, torch.as_tensor(lens[0], device=dev))
                    C = _csr(torch.cat([rows, diag]),
                             torch.cat([cols[0], diag]),
                             torch.cat([vals[0], cd[0]]), n)
                    X0 = X[0]
                    check(f"torch.sparse.mm {label}", torch.sparse.mm(C, X0),
                          ref[0], tol * l1[0].double() + 1e-300)
                    lib_ms, lib_how = device_time_ms(
                        lambda: torch.sparse.mm(C, X0))
                    lib = (f" library torch.sparse.mm (CSR) device "
                           f"{lib_ms:.4f} ms ({lib_how})")
                print(f"cmul_csr [{label}]: max_abs_err {err:.3e} (tol "
                      f"{tol:.1e} x |terms|) device {dev_ms:.4f} ms "
                      f"({how}){lib}")


def segment_sum_edges(rng, dev):
    """K1 edge cases: empty segments, padded blocks (B=2, second block's
    entries end early), 2-D and 3-D data (r = 3, 20, 40: 16-byte copies
    with and without a tail), a segment of 70000 entries (longer than a
    run's staging buffer) beside short ones in data one element past an
    aligned address, single-entry segments."""
    import numpy as np
    import torch

    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    def one(label, d, bnd):
        got = kernels.segment_sum(d, bnd)
        ref = kernels.segment_sum_plain(d, bnd)
        l1 = kernels.segment_sum_plain(d.abs(), bnd).double()
        torch.cuda.synchronize()
        tol = ((64 if d.dtype == torch.float64 else 4)
               * torch.finfo(d.dtype).eps)
        err = check(f"segment_sum {label}", got, ref, tol * l1 + 1e-300)
        print(f"segment_sum [{label}]: max_abs_err {err:.3e} (tol "
              f"{tol:.1e} x segment |terms|)")

    B, N, S = 2, 3 * 512 + 7, 97
    ids = np.sort(rng.integers(0, S, (B, N)), axis=1)
    ids[:, :5] = 0                      # a long first segment
    ids[1, N // 2:] = S                 # padded tail past the last bound
    ids = np.clip(ids, 0, S)
    bnd = torch.as_tensor(pat._bounds_np(ids, S), device=dev)
    for shape in ((B, N), (B, N, 3), (B, N, 20), (B, N, 40)):
        for dt in (torch.float64, torch.float32):
            d = torch.as_tensor(rng.standard_normal(shape), device=dev,
                                dtype=dt)
            one(f"edges {str(dt)[6:]} {shape}", d, bnd)
    ids = np.sort(np.concatenate([rng.integers(0, S, 2000),
                                  np.full(70000, S // 2)]))[None]
    bnd = torch.as_tensor(pat._bounds_np(ids, S), device=dev)
    for r, dt in ((20, torch.float32), (20, torch.float64),
                  (1, torch.float32)):
        flat = torch.as_tensor(rng.standard_normal(1 + ids.size * r),
                               device=dev, dtype=dt)
        d = flat[1:].view((1, ids.size) + ((r,) if r > 1 else ()))
        one(f"70000-entry segment, offset data {str(dt)[6:]} r={r}", d, bnd)
    single = np.sort(rng.choice(S, size=40, replace=False))[None]
    sb = torch.as_tensor(pat._bounds_np(single, S), device=dev)
    d = torch.as_tensor(rng.standard_normal((1, 40)), device=dev)
    if not torch.equal(kernels.segment_sum(d, sb),
                       kernels.segment_sum_plain(d, sb)):
        raise AssertionError("segment_sum single-entry: not exact")
    print("segment_sum [single-entry segments]: exact")


def skewed_layouts(rng):
    """K4 layouts with skewed segment lengths, as [B, S] length arrays
    (B = 2; the second row a permutation of the first with its longest
    segment cut by 1000 entries, so its bounds end before N): 80000
    segments of one entry or none (10 %) with one of 800, one of 5000 and
    one of 70000 entries among them (mean under 2: one lane per segment,
    the long ones taken by whole warps); 2000 segments of 0-6 entries
    with one of 800 and thirty of 33-40 (mean 3.5: four lanes per
    segment, the long ones taken by whole warps); 400 segments of 0-120
    entries (a warp per segment)."""
    import numpy as np
    out = []
    one = (rng.random(80000) >= 0.1).astype(np.int64)
    one[[100, 40000, 79999]] = (800, 5000, 70000)
    mid = rng.integers(0, 7, 2000)
    mid[rng.choice(2000, 30, replace=False)] = rng.integers(33, 41, 30)
    mid[1000] = 800
    for lengths in (one, mid, rng.integers(0, 121, 400)):
        second = rng.permutation(lengths)
        second[np.argmax(second)] -= min(1000, int(second.max()))
        out.append(np.stack([lengths, second]))
    return out


def gather_segsum_skewed(rng, dev):
    """K4 against its plain version on skewed_layouts, f64 and f32, with
    and without base and alpha: within 64 eps64 / 4 eps32 x the sum of
    |terms| of each output, bit for bit on one-entry segments."""
    import numpy as np
    import torch

    from lorads_torch.ops import kernels
    device_time_ms = timing().device_time_ms
    for lengths in skewed_layouts(rng):
        B, S = lengths.shape
        N, Nx = int(lengths.sum(axis=1).max()), 20000
        bnd = np.zeros((B, S + 1), np.int32)
        bnd[:, 1:] = np.cumsum(lengths, axis=1)
        bnd = torch.as_tensor(bnd, device=dev)
        idx = torch.as_tensor(rng.integers(0, Nx, (B, N)).astype(np.int32),
                              device=dev)
        single = torch.as_tensor(lengths == 1, device=dev)
        for dt in (torch.float64, torch.float32):
            tol = (64 if dt == torch.float64 else 4) * torch.finfo(dt).eps

            def rand(*shape):
                return torch.as_tensor(rng.standard_normal(shape),
                                       device=dev, dtype=dt)

            x, val = rand(B, Nx), rand(B, N)
            for base, alpha in ((None, 1.0), (rand(B, S), -0.75)):
                args = (x, idx, val, bnd, base, alpha)
                got = kernels.gather_segsum(*args)
                ref = kernels.gather_segsum_plain(*args)
                l1 = kernels.gather_segsum_plain(
                    x.abs(), idx, val.abs(), bnd,
                    None if base is None else base.abs(), abs(alpha))
                torch.cuda.synchronize()
                label = (f"skewed B={B} S={S} N={N} longest "
                         f"{int(lengths.max())} {str(dt)[6:]} "
                         f"{'base, alpha' if base is not None else 'no base'}")
                err = check(f"gather_segsum {label}", got, ref,
                            tol * l1.double() + 1e-300)
                if not torch.equal(got[single], ref[single]):
                    raise AssertionError(f"gather_segsum {label}: one-entry "
                                         "segments not exact")
                dev_ms, how = device_time_ms(
                    lambda: kernels.gather_segsum(*args))
                print(f"gather_segsum [{label}]: max_abs_err {err:.3e} (tol "
                      f"{tol:.1e} x |terms|, exact on {int(single.sum())} "
                      f"one-entry segments) device {dev_ms:.4f} ms ({how})")


def matcomp_kernel_checks(rng, measure):
    """Phase 3, matrix-completion path: K3p, K4, K5 and K6 against their
    plain versions at matcomp2000's shapes."""
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    problem = generators.matrix_completion(n1=2000, n2=2000, true_rank=3,
                                           frac_obs=0.12, seed=3)
    bp = presolve(problem, LoradsParams()).buckets[0]
    r = bp.rank
    bk64 = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    bk32 = pat.cast_floats(bk64, torch.float32)
    n, Ko, Ks, m = bk64.n, bk64.Ko, bk64.Ks, problem.m
    print(f"matcomp-path shapes: n={n} m={m} Ko={Ko} Ks={Ks} "
          f"rank={r} a_off_unique={bk64.a_off_unique}")

    def rand(shape, dt):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=dt)

    slot = bk64.sym_slot_rs[0].long()
    for dt, bk in ((torch.float64, bk64), (torch.float32, bk32)):
        sfx = "f64" if dt == torch.float64 else "f32"
        s = 8 if dt == torch.float64 else 4
        # ---- K3p uvt_pair_split (the ALM line search: f64, and f32 in
        # the f32 phase's ALM)
        a = (bk.off_rows, bk.off_cols)
        R, D = rand((1, n, r), dt), rand((1, n, r), dt)
        kw = _tiles_kw(pat, bk, "off", kernels.uvt_pair_split)
        measure("uvt_pair_split", f"{sfx} r={r}", sfx,
                lambda: kernels.uvt_pair_split(R, D, *a, **kw),
                lambda: kernels.uvt_pair_split_plain(R, D, *a),
                kernels.uvt_pair_split_plain(R.abs(), D.abs(), *a),
                nbytes=2 * n * r * s + 2 * Ko * 4 + 2 * (n + Ko) * s,
                flops=4 * n * r + 6 * Ko * r)
        # ---- K3 uvt_split: ADMM's sym(x F^T) (U != V) at both types, the
        # ALM's objective values (U is V) at f64
        U, V = rand((1, n, r), dt), rand((1, n, r), dt)
        kw = _tiles_kw(pat, bk, "off", kernels.uvt_split)
        Poff = _csr(bk.off_rows[0], bk.off_cols[0],
                    torch.ones(Ko, dtype=dt, device=dev), n)
        for VV in ((V, None) if dt == torch.float64 else (V,)):
            uvt_cases(measure, kernels, "matcomp2000 ", sfx, U, VV, *a, kw,
                      n, Ko, Poff)
        # ---- K4 gather_segsum: A(.) (one entry per constraint: exact)
        # (library, here and below: K4's entry list as a CSR matrix,
        # built once, times x by torch.sparse.mm, or torch.addmm with C)
        o = rand((1, Ko), dt)
        a4 = (o, bk.a_pos_o_cs, bk.a_val_o_cs, bk.bnd_a_con_o_cs)
        N = bk.a_pos_o_cs.shape[1]
        measure("gather_segsum", f"{sfx} A(.) m={m}", sfx,
                lambda: kernels.gather_segsum(*a4, alpha=2.0),
                lambda: kernels.gather_segsum_plain(*a4, None, 2.0),
                kernels.gather_segsum_plain(o.abs(), a4[1], a4[2].abs(),
                                            a4[3], None, 2.0),
                nbytes=N * (2 * s + 4) + (m + 1) * 4 + m * s,
                flops=3 * N, exact=True,
                library=_seg_library(_seg_csr(*a4[1:], Ko, alpha=2.0), o))
        # ---- K4: C + A^*(w) onto the Ko slots
        w = rand((1, m), dt)
        a4w = (w, bk.a_con_o_s, bk.a_val_o_s, bk.bnd_a_pos_o_s)
        measure("gather_segsum", f"{sfx} A^*(w)+C Ko={Ko}", sfx,
                lambda: kernels.gather_segsum(*a4w, base=bk.c_off),
                lambda: kernels.gather_segsum_plain(*a4w, bk.c_off),
                kernels.gather_segsum_plain(w.abs(), a4w[1], a4w[2].abs(),
                                            a4w[3], bk.c_off.abs()),
                nbytes=m * s + N * (4 + s) + (Ko + 1) * 4 + 2 * Ko * s,
                flops=2 * N + Ko,
                library=_seg_library(_seg_csr(*a4w[1:], m), w, bk.c_off))
        # ---- K5 wmul_csr at r = rank (gradient, CG) and r = 1 (Lanczos)
        # (library: torch.sparse.mm on W as a CSR tensor)
        W_d, W_o = rand((1, n), dt), rand((1, Ko), dt)
        a5 = (bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows)
        diag = torch.arange(n, device=dev)
        Wc = _csr(torch.cat([bk.sym_rows_rs[0], diag]),
                  torch.cat([bk.sym_cols_rs[0], diag]),
                  torch.cat([W_o[0][slot], W_d[0]]), n)
        for rr in (r, 1):
            X = rand((1, n, rr), dt)
            X0 = X[0]
            measure("wmul_csr", f"{sfx} r={rr}", sfx,
                    lambda: kernels.wmul_csr(X, W_d, W_o, *a5,
                                             **_tiles_kw(pat, bk, "sym")),
                    lambda: kernels.wmul_csr_plain(X, W_d, W_o, *a5),
                    kernels.wmul_csr_plain(X.abs(), W_d.abs(), W_o.abs(),
                                           *a5),
                    nbytes=2 * n * rr * s + (n + Ko) * s + Ks * 8
                    + (n + 1) * 4,
                    flops=2 * (Ks + n) * rr,
                    library=lambda: torch.sparse.mm(Wc, X0))
        # ---- K6 adj_a_offdiag (every CG matvec)
        X, F = rand((1, n, r), dt), rand((1, n, r), dt)
        a6 = (bk.off_rows, bk.off_cols, bk.a2_off)
        measure("adj_a_offdiag", f"{sfx} r={r}", sfx,
                lambda: kernels.adj_a_offdiag(
                    X, F, *a6, **_tiles_kw(pat, bk, "off"))[1],
                lambda: kernels.adj_a_offdiag_plain(X, F, *a6, False)[1],
                kernels.adj_a_offdiag_plain(X.abs(), F.abs(), *a6,
                                            False)[1],
                nbytes=2 * n * r * s + 2 * Ko * 4 + 2 * Ko * s,
                flops=4 * Ko * r + Ko)
    k5_k6_other_patterns(rng, measure)


def _tiles_kw(pat, bk, kind, fn=None):
    """The tile schedule K5 ("sym") or K3, K3p, K6 ("off") run on, as a
    keyword of the wrapper fn; nothing for a checkout whose bucket holds
    none or whose fn takes none (--kernels-of an earlier one)."""
    return _kw_tiles(fn, getattr(bk, f"{kind}_tiles", None))


def _kw_tiles(fn, t):
    """{"tiles": t} where the wrapper fn takes a schedule (fn None: K5,
    K6, which take one wherever a bucket holds one), else {}."""
    import inspect
    if t is None or (fn is not None
                     and "tiles" not in inspect.signature(fn).parameters):
        return {}
    return {"tiles": t}


def one_dot_exact(kernels, label, U, rows, cols, kw):
    """K3 with U is V (one dot an entry) against its two-dot path on a
    copy of U: equal bit for bit, diagonal and off values."""
    import torch
    one = kernels.uvt_split(U, U, rows, cols, **kw)
    two = kernels.uvt_split(U, U.clone(), rows, cols, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError(f"uvt_split [{label}]: U is V differs from "
                             "the two-dot path")
    print(f"uvt_split [{label}]: U is V equals the two-dot path on a copy "
          "of U bit for bit")


def uvt_cases(measure, kernels, where, sfx, U, V, rows, cols, kw, n, Ko,
              Poff=None, B=1):
    """K3 on one pattern: U != V (library: torch.sparse.sampled_addmm on
    the off pattern gives U V^T there, without the symmetrisation
    (U V^T + V U^T) / 2 and the diagonal rowsum) and, where V is given
    as None, only U is V: one dot an entry, checked bit for bit against
    the two-dot path (library: sampled_addmm gives U U^T there, the same
    off values; the diagonal rowsum is outside it)."""
    import torch
    s = 8 if sfx == "f64" else 4
    r = U.shape[2]
    Uf = U.reshape(B * n, r)
    if V is not None:
        a = (U, V, rows, cols)
        Vt = V.reshape(B * n, r).T.contiguous()
        measure("uvt_split", f"{where}{sfx} r={r}", sfx,
                lambda: kernels.uvt_split(*a, **kw),
                lambda: kernels.uvt_split_plain(*a),
                kernels.uvt_split_plain(U.abs(), V.abs(), rows, cols),
                nbytes=2 * B * n * r * s + 2 * B * Ko * 4 + B * (n + Ko) * s,
                flops=B * (2 * n * r + 4 * Ko * r),
                library=None if Poff is None else (
                    lambda: torch.sparse.sampled_addmm(Poff, Uf, Vt,
                                                       beta=0.0)))
        return
    a = (U, U, rows, cols)
    Ut = Uf.T.contiguous()
    one_dot_exact(kernels, f"{where}{sfx} r={r} U is V", U, rows, cols, kw)
    note = "" if Poff is None else (" (library: the off values alone, "
                                     "no diagonal rowsum)")
    measure("uvt_split", f"{where}{sfx} r={r} U is V{note}", sfx,
            lambda: kernels.uvt_split(*a, **kw),
            lambda: kernels.uvt_split_plain(*a),
            kernels.uvt_split_plain(U.abs(), U.abs(), rows, cols),
            nbytes=B * n * r * s + 2 * B * Ko * 4 + B * (n + Ko) * s,
            flops=B * (2 * n * r + 2 * Ko * r),
            library=None if Poff is None else (
                lambda: torch.sparse.sampled_addmm(Poff, Uf, Ut, beta=0.0)))


def _skewed_split_bucket(rng, dev):
    """A split bucket on n = 20000 whose off pattern mixes every kind of
    tile: a hub row (row n-1 against every column), a 12 %-dense block
    (rows 10000..10999 x columns 0..999, well-filled tiles) and 4 random
    lower entries a row elsewhere (sparse tiles, their strips' L2 units).
    Its port-only fields are built as the solver builds a bucket's
    (pattern.port_fields, and pattern.tile_fields on the card where the
    checkout has them)."""
    import types

    import numpy as np
    import torch

    from lorads_torch.ops import pattern as pat

    n = 20000
    hub = np.stack([np.full(n - 1, n - 1), np.arange(n - 1)])
    dense = np.nonzero(rng.random((1000, 1000)) < 0.12)
    dense = np.stack([dense[0] + 10000, dense[1]])
    rows = np.repeat(np.arange(1, n - 1), 4)
    rand = np.stack([rows, (rng.random(rows.size) * rows).astype(np.int64)])
    pairs = np.unique(np.concatenate([hub, dense, rand], 1), axis=1)
    key = pairs[0] * n + pairs[1]
    rows, cols = pairs[:, np.argsort(key)]
    Ko = rows.size
    z = np.zeros((1, 1))
    port = pat.port_fields(n, 1, rows[None], cols[None],
                           rng.standard_normal((1, Ko)),
                           z.astype(np.int64), z.astype(np.int64), z)
    Ks = port.pop("Ks")
    t = {k: torch.as_tensor(np.asarray(v, np.int32), device=dev)
         for k, v in port.items() if np.asarray(v).dtype.kind in "iu"}
    t["off_rows"] = torch.as_tensor(rows[None].astype(np.int32), device=dev)
    t["off_cols"] = torch.as_tensor(cols[None].astype(np.int32), device=dev)
    bk = types.SimpleNamespace(n=n, Ko=Ko, Ks=Ks, **t)
    if hasattr(pat, "tile_fields"):
        vars(bk).update(pat.tile_fields(n, bk.off_rows, bk.off_cols,
                                        bk.sym_slot_rs, bk.sym_cols_rs,
                                        bk.bnd_sym_rows))
        bk.off_tiles = pat.bucket_tiles(bk, "off")
        bk.sym_tiles = pat.bucket_tiles(bk, "sym")
    return bk


def k5_k6_other_patterns(rng, measure):
    """Phase 3: K5 and K6 beside matcomp2000's pattern, at f64: on the
    sparse pattern of the Max-Cut path (maxcut n=20000 deg 8: Ko=80000,
    r=20), where nearly every tile holds a few entries and reads its
    columns from L2, and on a skewed pattern (_skewed_split_bucket,
    r=17); W, a2 and the factors random (K6 library: none --
    torch.sparse.sampled_addmm gives <X_i, F_j> alone, not the
    symmetrised, scaled value)."""
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    problem = generators.maxcut(n=20000, avg_degree=8, seed=7)
    bp = presolve(problem, LoradsParams()).buckets[0]
    cases = [("sparse maxcut20000", bp.rank, pat.build_bucket_data(
        bp, problem.m, torch.float64, dev)),
        ("skewed", 17, _skewed_split_bucket(rng, dev))]
    for where, r, bk in cases:
        n, Ko, Ks = bk.n, bk.Ko, bk.Ks
        print(f"K5/K6 {where} shapes: n={n} Ko={Ko} Ks={Ks} rank={r}")

        def rand(*shape):
            return torch.as_tensor(rng.standard_normal(shape), device=dev)

        W_d, W_o = rand(1, n), rand(1, Ko)
        W_o[bk.off_rows == bk.off_cols] = 0.0
        a5 = (bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows)
        slot = bk.sym_slot_rs[0].long()
        diag = torch.arange(n, device=dev)
        Wc = _csr(torch.cat([bk.sym_rows_rs[0], diag]),
                  torch.cat([bk.sym_cols_rs[0], diag]),
                  torch.cat([torch.where(slot >= 0, W_o[0][slot.clamp(
                      min=0)], 0.0), W_d[0]]), n)
        X = rand(1, n, r)
        X0 = X[0]
        measure("wmul_csr", f"{where} f64 r={r}", "f64",
                lambda: kernels.wmul_csr(X, W_d, W_o, *a5,
                                         **_tiles_kw(pat, bk, "sym")),
                lambda: kernels.wmul_csr_plain(X, W_d, W_o, *a5),
                kernels.wmul_csr_plain(X.abs(), W_d.abs(), W_o.abs(), *a5),
                nbytes=2 * n * r * 8 + (n + Ko) * 8 + Ks * 8 + (n + 1) * 4,
                flops=2 * (Ks + n) * r,
                library=lambda: torch.sparse.mm(Wc, X0))
        F = rand(1, n, r)
        a2 = rand(1, Ko).abs()
        a2[bk.off_rows == bk.off_cols] = 0.0
        a6 = (bk.off_rows, bk.off_cols, a2)
        measure("adj_a_offdiag", f"{where} f64 r={r}", "f64",
                lambda: kernels.adj_a_offdiag(
                    X, F, *a6, **_tiles_kw(pat, bk, "off"))[1],
                lambda: kernels.adj_a_offdiag_plain(X, F, *a6, False)[1],
                kernels.adj_a_offdiag_plain(X.abs(), F.abs(), *a6,
                                            False)[1],
                nbytes=2 * n * r * 8 + 2 * Ko * 4 + 2 * Ko * 8,
                flops=4 * Ko * r + Ko)
        if where != "skewed":
            continue
        # ---- K3 (U != V, U is V) and K3p on the skewed pattern
        a = (bk.off_rows, bk.off_cols)
        Poff = _csr(bk.off_rows[0], bk.off_cols[0],
                    torch.ones(Ko, dtype=torch.float64, device=dev), n)
        for VV in (F, None):
            uvt_cases(measure, kernels, f"{where} ", "f64", X, VV, *a,
                      _tiles_kw(pat, bk, "off", kernels.uvt_split), n, Ko,
                      Poff)
        kw = _tiles_kw(pat, bk, "off", kernels.uvt_pair_split)
        measure("uvt_pair_split", f"{where} f64 r={r}", "f64",
                lambda: kernels.uvt_pair_split(X, F, *a, **kw),
                lambda: kernels.uvt_pair_split_plain(X, F, *a),
                kernels.uvt_pair_split_plain(X.abs(), F.abs(), *a),
                nbytes=2 * n * r * 8 + 2 * Ko * 4 + 2 * (n + Ko) * 8,
                flops=4 * n * r + 6 * Ko * r)


def theta_kernel_checks(rng, measure):
    """Phase 3, theta path: K7a and K4 on the dense layouts at theta800's
    shapes (bench.py's lovasz_theta(n=800, avg_degree=8, seed=5)), at f64
    and in f32 as the mixed-precision CG runs them."""
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.io import generators
    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    problem = generators.lovasz_theta(n=800, avg_degree=8, seed=5)
    bp = presolve(problem, LoradsParams()).buckets[0]
    r = bp.rank
    bk64 = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    bk32 = pat.cast_floats(bk64, torch.float32)
    n, m = bk64.n, problem.m
    N1, N2 = bk64.a_lin_cs.shape[1], bk64.a_con2_s.shape[1]
    Ndd = bk64.dd_row_cs.shape[1]
    print(f"theta-path shapes: n={n} n^2={n * n} m={m} nnz_a={bk64.nnz_a} "
          f"rank={r} a_single_dense={bk64.a_single_dense} "
          f"nnz_dd={bk64.nnz_dd} A(.) entries {N1}, A^*(w) entries {N2}")
    if not (bk64.dense and bk64.a_single_dense):
        raise AssertionError("theta800 did not build a single-entry "
                             "dense bucket")
    seg = bk64.bnd_a_con_cs[0, 1:] - bk64.bnd_a_con_cs[0, :-1]
    single = seg == 1

    def rand(shape, dt):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=dt)

    for dt, bk in ((torch.float64, bk64), (torch.float32, bk32)):
        sfx = "f64" if dt == torch.float64 else "f32"
        s = 8 if dt == torch.float64 else 4
        # ---- K7a adj_a_dense: the CG operator's A^*(A(X)) plane on
        # X = sym(x F^T); product and diagonal sum rounded separately,
        # so kernel and plain version agree bit for bit
        X = pat._sym_product(rand((1, n, r), dt), rand((1, n, r), dt))
        W_d = rand((1, n), dt)
        measure("adj_a_dense", f"{sfx} n={n}", sfx,
                lambda: kernels.adj_a_dense(X, bk.a2_full, W_d),
                lambda: kernels.adj_a_dense_plain(X, bk.a2_full, W_d),
                kernels.adj_a_dense_plain(X.abs(), bk.a2_full.abs(),
                                          W_d.abs()),
                nbytes=3 * n * n * s + n * s, flops=n * n + n, exact=True)
        # its case with no diagonal term, the single-entry plane, beside
        # the one PyTorch call that computes it
        measure("adj_a_dense", f"{sfx} n={n}, no diagonal", sfx,
                lambda: kernels.adj_a_dense(X, bk.a2_full),
                lambda: kernels.adj_a_dense_plain(X, bk.a2_full, None),
                kernels.adj_a_dense_plain(X.abs(), bk.a2_full.abs(), None),
                nbytes=3 * n * n * s, flops=n * n, exact=True,
                library=lambda: torch.mul(bk.a2_full, X))
        # ---- K4: dense A(.) over the flat [1, n^2] view (layout (i)):
        # bit for bit on the single-entry constraints, the trace one
        # segment of n entries walked by a whole warp
        flat = rand((1, n * n), dt)
        a4 = (flat, bk.a_lin_cs, bk.a_val_inner_cs, bk.bnd_a_con_cs)
        measure("gather_segsum", f"{sfx} dense A(.) m={m}", sfx,
                lambda: kernels.gather_segsum(*a4),
                lambda: kernels.gather_segsum_plain(*a4),
                kernels.gather_segsum_plain(flat.abs(), a4[1], a4[2].abs(),
                                            a4[3]),
                nbytes=N1 * (2 * s + 4) + (m + 1) * 4 + m * s,
                flops=2 * N1, exact=single,
                library=_seg_library(_seg_csr(*a4[1:], n * n), flat))
        # ---- K4: C + A^*(w) onto the n^2 slots (layout (ii))
        w = rand((1, m), dt)
        base = bk.c_full.reshape(1, n * n)
        a4w = (w, bk.a_con2_s, bk.a_val2_s, bk.bnd_a_lin2)
        measure("gather_segsum", f"{sfx} dense C+A^*(w) S={n * n}", sfx,
                lambda: kernels.gather_segsum(*a4w, base=base),
                lambda: kernels.gather_segsum_plain(*a4w, base),
                kernels.gather_segsum_plain(w.abs(), a4w[1], a4w[2].abs(),
                                            a4w[3], base.abs()),
                nbytes=m * s + N2 * (4 + s) + (n * n + 1) * 4
                + 2 * n * n * s,
                flops=2 * N2 + n * n,
                library=_seg_library(_seg_csr(*a4w[1:], m), w, base))
        # ---- K4: the two dd sums of the CG operator (layout (iii))
        d = rand((1, n), dt)
        add = (d, bk.dd_row_cs, bk.dd_val_cs, bk.bnd_dd_con)
        measure("gather_segsum", f"{sfx} dense dd A(.) m={m}", sfx,
                lambda: kernels.gather_segsum(*add),
                lambda: kernels.gather_segsum_plain(*add),
                kernels.gather_segsum_plain(d.abs(), add[1], add[2].abs(),
                                            add[3]),
                nbytes=n * s + Ndd * (4 + s) + (m + 1) * 4 + m * s,
                flops=2 * Ndd,
                library=_seg_library(_seg_csr(*add[1:], n), d))
        v = rand((1, m), dt)
        adr = (v, bk.dd_con_rs, bk.dd_val_rs, bk.bnd_dd_row)
        measure("gather_segsum", f"{sfx} dense dd A^*(v) n={n}", sfx,
                lambda: kernels.gather_segsum(*adr),
                lambda: kernels.gather_segsum_plain(*adr),
                kernels.gather_segsum_plain(v.abs(), adr[1], adr[2].abs(),
                                            adr[3]),
                nbytes=Ndd * (2 * s + 4) + (n + 1) * 4 + n * s,
                flops=2 * Ndd,
                library=_seg_library(_seg_csr(*adr[1:], m), v))


def multiblock_kernel_checks(rng, measure):
    """Phase 3, multi-block / LP and batch paths: K8a and K8b (K4 on the
    LP's sorted entries) and K8c at multiblock_lp's LP block (400
    columns, m=120), K4's scatter of its 8 blocks' local constraint
    values, and K2 / K3 at the maxcut batch's B = 4."""
    import numpy as np
    import torch

    from lorads_torch.config import LoradsParams
    from lorads_torch.core.presolve import presolve
    from lorads_torch.ops import kernels
    from lorads_torch.ops import lp as lp_ops
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")
    s = 8

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=torch.float64)

    problem = INSTANCES["multiblock_lp"]()
    lpd = lp_ops.build_lp_data(problem.lp, torch.float64, dev)
    n, m, N, L = lpd.n_cols, lpd.m_glob, lpd.nnz, lpd.max_nnz_col
    bp = presolve(problem, LoradsParams()).buckets[0]
    bk = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    print(f"lp-path shapes: LP columns {n} m={m} entries {N} (at most {L} "
          f"per column); bucket B={bk.B} n={bk.n} m_loc={bk.m_loc} "
          f"scatter entries {bk.scat_idx.shape[1]}")
    lp32 = lp_ops.build_lp_data(problem.lp, torch.float32, dev)
    for sfx, lp, sz in (("f64", lpd, 8), ("f32", lp32, 4)):
        dt = lp.obj.dtype
        # ---- K8a: A_lp(uv) over the constraint-sorted entries
        uv = rand(n).to(dt)
        a8 = (lp.a_col_cs[None], lp.a_val_cs[None], lp.bnd_con[None])
        measure("gather_segsum", f"{sfx} K8a LP A_lp(uv) m={m}", sfx,
                lambda: lp_ops.constr_vals(lp, uv),
                lambda: kernels.gather_segsum_plain(uv[None], *a8)[0],
                kernels.gather_segsum_plain(uv.abs()[None], a8[0],
                                            a8[1].abs(), a8[2])[0],
                nbytes=N * (4 + sz) + n * sz + (m + 1) * 4 + m * sz,
                flops=2 * N,
                library=_seg_library(_seg_csr(*a8, n), uv[None]))
        # ---- K8b: c - A_lp^T lambda (certificate) over the column-sorted
        # entries; the ALM gradient's c + A_lp^T w is the same launch
        w = rand(m).to(dt)
        b8 = (lp.a_con_ls[None], lp.a_val_ls[None], lp.bnd_col[None])
        measure("gather_segsum", f"{sfx} K8b LP c - A_lp^T w n={n}", sfx,
                lambda: lp_ops.adjoint_cols(lp, w, base=lp.obj, alpha=-1.0),
                lambda: kernels.gather_segsum_plain(w[None], *b8,
                                                    lp.obj[None], -1.0)[0],
                kernels.gather_segsum_plain(w.abs()[None], b8[0],
                                            b8[1].abs(), b8[2],
                                            lp.obj.abs()[None])[0],
                nbytes=N * (4 + sz) + m * sz + (n + 1) * 4 + 2 * n * sz,
                flops=2 * N + n,
                library=_seg_library(_seg_csr(*b8, m, alpha=-1.0), w[None],
                                     lp.obj[None]))
    # ---- K8c: the Gauss-Seidel LP sweep, bit for bit, at the LP block's
    # shapes, then at m past the shared-memory limit (400 synthetic
    # columns of 43-74 increasing ids, as the LP block's)
    u, v = rand(n), rand(n)
    csum, dual = rand(m), rand(m)
    a8c = (lpd.pc_con, lpd.pc_val, lpd.obj, lpd.col_nrm2sq, u, v, csum,
           rand(m), dual, 5.0)
    lp_gs_case(measure, a8c, N)
    lp_gs_case(measure, a8c, N, s=rand(n))
    # at f32, as the f32 phase's multiblock_lp sweeps (no s)
    lp_gs_case(measure, (lp32.pc_con, lp32.pc_val, lp32.obj,
                         lp32.col_nrm2sq) + tuple(
                             t.float() for t in a8c[4:9]) + (5.0,), N)
    mb = 30000
    gen = np.random.default_rng(5)
    pc = np.full((n, L), mb, np.int32)
    for j in range(n):
        k = int(gen.integers(43, L + 1))
        pc[j, :k] = np.sort(gen.choice(mb, k, replace=False))
    pv = np.where(pc < mb, gen.standard_normal((n, L)) / np.sqrt(L), 0.0)
    nrm2 = torch.as_tensor((pv ** 2).sum(axis=1), device=dev)
    a8c = (torch.as_tensor(pc, device=dev), torch.as_tensor(pv, device=dev),
           rand(n), nrm2, rand(n), 0.5 * rand(n).abs(), rand(mb), rand(mb),
           rand(mb), 5.0)
    lp_gs_case(measure, a8c, int((pc < mb).sum()))
    lp_gs_case(measure, a8c, int((pc < mb).sum()), s=rand(n))
    # ---- K4: scatter_constr of the bucket's local values into [m]
    vals = rand(bk.B, bk.m_loc)
    sc = (bk.scat_idx, bk.scat_val, bk.bnd_scat)
    S = sc[0].shape[1]
    measure("gather_segsum", f"f64 scatter_constr B={bk.B} m={m}", "f64",
            lambda: pat.scatter_constr(bk, vals),
            lambda: kernels.gather_segsum_plain(vals.reshape(1, -1),
                                                *sc)[0],
            kernels.gather_segsum_plain(vals.abs().reshape(1, -1), *sc)[0],
            nbytes=S * (4 + s) + bk.B * bk.m_loc * s + (m + 1) * 4 + m * s,
            flops=2 * S,
            library=_seg_library(_seg_csr(*sc, bk.B * bk.m_loc),
                                 vals.reshape(1, -1)))

    # ---- K2 / K3 at the maxcut batch's B = 4 (library: the four blocks
    # as one block-diagonal CSR matrix, one call)
    problem = INSTANCES["maxcut20000x4"]()
    bp = presolve(problem, LoradsParams()).buckets[0]
    bk = pat.build_bucket_data(bp, problem.m, torch.float64, dev)
    B, nb, r, Ks, Ko = bk.B, bk.n, bp.rank, bk.Ks, bk.Ko
    print(f"batch-path shapes: B={B} n={nb} Ks={Ks} Ko={Ko} rank={r} "
          f"diag_ident={bk.diag_ident} glob_ident={bk.glob_ident}")
    diag = torch.arange(nb, device=dev).expand(B, nb)
    X = rand(B, nb, r)
    args = (X, bk.c_diag, bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
    C = _blockdiag_csr(bk.sym_rows_rs, bk.sym_cols_rs, bk.c_sym_rs, nb,
                       (diag, diag, bk.c_diag))
    Xf = X.reshape(B * nb, r)
    measure("cmul_csr", f"f64 B={B} r={r} diag", "f64",
            lambda: kernels.cmul_csr(*args),
            lambda: kernels.cmul_csr_plain(*args),
            kernels.cmul_csr_plain(X.abs(), bk.c_diag.abs(), bk.sym_cols_rs,
                                   bk.c_sym_rs.abs(), bk.bnd_sym_rows),
            nbytes=2 * B * nb * r * s + B * Ks * (4 + s)
            + B * (nb + 1) * 4 + B * nb * s,
            flops=2 * B * (Ks + nb) * r,
            library=lambda: torch.sparse.mm(C, Xf))
    U, V = rand(B, nb, r), rand(B, nb, r)
    Poff = _blockdiag_csr(bk.off_rows, bk.off_cols, torch.ones(
        (B, Ko), dtype=torch.float64, device=dev), nb)
    kw = _tiles_kw(pat, bk, "off", kernels.uvt_split)
    for VV in (V, None):
        uvt_cases(measure, kernels, f"B={B} ", "f64", U, VV, bk.off_rows,
                  bk.off_cols, kw, nb, Ko, Poff, B)


def lp_gs_case(measure, a8c, N, s=None):
    """K8c on the card against its plain version (inputs a8c = (pc_con,
    pc_val, obj, nrm2, u, v, csum, rhs, dual, rho), N entries, f64: bit
    for bit; f32: within K8C_F32_TOL; ``s`` the DUAL_U_V term [n] or
    None), its time per dependent
    step beside the dependent-step bound (n x one dependent shared-memory
    load, measured by launch_floors); the label names the instantiation
    lt_lp_gs_sweep picks.  A checkout whose K8c takes no s skips the s
    case (--kernels-of on an older checkout)."""
    import inspect

    import torch

    from lorads_torch.ops import build, kernels
    if s is not None and "s" not in inspect.signature(
            kernels.lp_gs_sweep).parameters:
        print("lp_gs_sweep [with s]: this checkout's K8c takes no s")
        return
    n, L = a8c[0].shape
    m = a8c[6].shape[0]
    f64 = a8c[6].dtype == torch.float64
    lib = build.load()
    where = ("" if not hasattr(lib, "lt_lp_gs_smem_max_m") else
             ", csum in shared memory"
             if m <= lib.lt_lp_gs_smem_max_m(int(f64), int(s is not None))
             else ", csum in global memory")
    dev = a8c[6].device
    b = 8 if f64 else 4
    sfx = "f64" if f64 else "f32"
    kw = {} if s is None else {"s": s}
    with_s = "" if s is None else " with s"
    # f64: bit for bit.  f32: both sides take the same rounded steps in
    # the same order, but a difference of one rounding in a column's
    # update reaches every later column through csum, so the check is
    # K8C_F32_TOL of each output's largest magnitude, and the line says
    # whether the two agreed bit for bit
    got, ref = kernels.lp_gs_sweep(*a8c, **kw), \
        kernels.lp_gs_sweep_plain(*a8c, **kw)
    bits = all(torch.equal(g, r) for g, r in zip(got, ref))
    scale = tuple(torch.full_like(r, float(r.abs().max())) for r in ref)
    measure("lp_gs_sweep",
            f"{sfx} K8c{with_s} n_lp={n} L={L} m={m}{where} (dependent "
            f"steps: {n})" + ("" if f64 else
                              f"; bit for bit with the plain version: "
                              f"{'yes' if bits else 'no'}"),
            sfx, lambda: kernels.lp_gs_sweep(*a8c, **kw),
            lambda: kernels.lp_gs_sweep_plain(*a8c, **kw),
            (torch.ones(n, dtype=torch.float64, device=dev),
             torch.ones(m, dtype=torch.float64, device=dev)) if f64
            else scale,
            nbytes=n * L * (4 + b) + (5 + (s is not None)) * n * b
            + 4 * m * b,
            flops=9 * N + (12 + (s is not None)) * n,
            exact=True if f64 else None, tol=0.0 if f64 else K8C_F32_TOL,
            steps=n, step_ns=measure.floors["hop_ns"])


def _p1_flops(oh, plan, r, mode, layout):
    """P1's one-hot flops in this layout (a checkout whose count takes no
    layout: its [K, r] count)."""
    import inspect
    if "layout" in inspect.signature(oh.scatter_mma_flops).parameters:
        return oh.scatter_mma_flops(plan, r, mode, layout)
    return oh.scatter_mma_flops(plan, r, mode)


def probe_kernel_checks(rng, measure):
    """Phase 3, the probes: P1-P4 against their plain versions at the
    probes' shapes (f32 values, int32 ids) and K3 at the fused uvT
    probe's [R, n] shape, transposed once."""
    import numpy as np
    import torch

    from lorads_torch.ops import kernels
    from lorads_torch.probes import gather
    from lorads_torch.probes import onehot as oh
    from lorads_torch.probes.__main__ import gather_bytes

    dev = torch.device("cuda")
    eps32 = float(np.finfo(np.float32).eps)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    # ---- P1 onehot_scatter: gather7 / onehot_nn's sorted segment sum
    # (library: torch.segment_reduce on the same lengths)
    n, K, r = 20000, 80000, 24
    ids_np = np.sort(rng.integers(0, n, K)).astype(np.int32)
    plan = oh.plan_sorted_scatter(ids_np, n, CT=256, WT=2048, device=dev)
    lengths = torch.as_tensor(np.bincount(ids_np, minlength=n), device=dev)
    vals = f32(K, r)
    l1 = oh.sorted_scatter_plain(vals.abs(), plan, "f32")
    print(f"probe shapes: n={n} K={K} r={r} CT={plan.CT} WT={plan.WT} "
          f"n_pad={plan.n_pad} K_pad={plan.K_pad}")
    for mode, layout in (("bf16x3", "kr"), ("f32", "rk"), ("bf16x2", "kr")):
        v = vals if layout == "kr" else vals.T.contiguous()
        measure("onehot_scatter",
                f"{mode} {'[K,r]' if layout == 'kr' else '[r,K]'} CT=256",
                "bf16", lambda: oh.sorted_scatter(v, plan, mode, layout),
                lambda: oh.sorted_scatter_plain(v, plan, mode, layout),
                l1 if layout == "kr" else l1.T,
                nbytes=K * r * 4 + K * 4 + n * r * 4,
                flops=_p1_flops(oh, plan, r, mode, layout), tol=4 * eps32,
                library=lambda: torch.segment_reduce(vals, "sum",
                                                     lengths=lengths))
    # ---- P2 onehot_gather: bit for bit (each output is one row's planes)
    X = f32(n, r)
    ids = i32(ids_np)
    gplan = oh.plan_sorted_gather(ids_np, n, KT=256, device=dev)
    for mode in ("bf16x3", "bf16x2"):
        ref = oh.sorted_gather_plain(X, gplan, mode)
        measure("onehot_gather", f"{mode} KT=256 WT={gplan.WT}", "bf16",
                lambda: oh.sorted_gather(X, gplan, mode),
                lambda: oh.sorted_gather_plain(X, gplan, mode), ref.abs(),
                nbytes=gather_bytes(ids, r),
                flops=oh.gather_mma_flops(gplan, r, mode), exact=True,
                tol=0.0, library=lambda: X.index_select(0, ids))
    # ---- P3 row_gather: pallas_gather's rows, gT's transposed table, gE's
    # 1-D gather at chip_smoke's shape and at gE / gE2's ([5 n3] by n3
    # ids, past a block's shared memory) (exact)
    n3, K3, r3, R = 20000, 100000, 20, 24
    ids3 = i32(rng.integers(0, n3, K3))
    ids3l = ids3.long()
    idsE = i32(rng.integers(0, 5 * n3, n3))
    idsEl = idsE.long()
    for label, T, ids, layout, width, lib in (
            (f"rows [{n3},{r3}] K={K3}", f32(n3, r3), ids3, "kr", r3,
             lambda T: T.index_select(0, ids3)),
            (f"transposed [{R},{n3}] K={K3}", f32(R, n3), ids3, "rk", R,
             lambda T: T.index_select(1, ids3)),
            (f"1-D [{n3}] K={K3}", f32(n3), ids3, "kr", 1,
             lambda T: torch.take(T, ids3l)),
            (f"1-D [{5 * n3}] K={n3}", f32(5 * n3), idsE, "kr", 1,
             lambda T: torch.take(T, idsEl))):
        ref = gather.row_gather_plain(T, ids, layout)
        measure("row_gather", label, "f32",
                lambda: gather.row_gather(T, ids, layout, check=False),
                lambda: gather.row_gather_plain(T, ids, layout), ref.abs(),
                nbytes=gather_bytes(ids, width), flops=0, exact=True,
                tol=0.0, library=lambda: lib(T))
    probe_edge_checks(dev)
    # ---- P4 scatter_add: gather9 fC's unsorted segment sum (f32
    # reductions in no fixed order; library: index_add_), then the same
    # values at sorted ids and at sorted ids with a hub of 5000 equal ids
    n4, K4, r4 = 20000, 160000, 24
    i4 = rng.integers(0, n4, K4)
    v4 = f32(K4, r4)
    hub4 = np.concatenate([rng.integers(0, n4, K4 - 5000),
                           np.full(5000, n4 // 3)])
    for label, ids4 in (("unsorted", i32(i4)), ("sorted", i32(np.sort(i4))),
                        ("sorted, a hub of 5000", i32(np.sort(hub4)))):
        measure("scatter_add", f"{label} n={n4} K={K4} r={r4}", "f32",
                lambda: gather.scatter_add(v4, ids4, n4, check=False),
                lambda: gather.scatter_add_plain(v4, ids4, n4),
                gather.scatter_add_plain(v4.abs(), ids4, n4),
                nbytes=K4 * r4 * 4 + K4 * 4 + n4 * r4 * 4, flops=K4 * r4,
                tol=4 * eps32,
                library=lambda: torch.zeros((n4, r4),
                                            device=dev).index_add_(
                    0, ids4, v4))
    # ---- K3 at the uvT probe's shape: X, D [R, n] transposed once to the
    # [1, n, R] factors K3 takes (library: the probe's unfused form, four
    # index_selects, a product and a sum over R)
    Xt = f32(R, n3)
    Dt = Xt * 0.5 + 1.0
    ic = ids3
    ir = i32(np.sort(rng.integers(0, n3, K3)))
    U, V = Xt.T.contiguous()[None], Dt.T.contiguous()[None]
    rows, cols = ir[None], ic[None]
    kw = _kw_tiles(kernels.uvt_split,
                   getattr(kernels, "adj_tiles", lambda *a: None)(
                       rows, cols, n3))
    measure("uvt_split", f"f32 uvT probe R={R} n={n3} K={K3}", "f32",
            lambda: kernels.uvt_split(U, V, rows, cols, **kw)[1],
            lambda: kernels.uvt_split_plain(U, V, rows, cols)[1],
            kernels.uvt_split_plain(U.abs(), V.abs(), rows, cols)[1],
            nbytes=2 * n3 * R * 4 + 2 * K3 * 4 + (n3 + K3) * 4,
            flops=2 * n3 * R + 4 * K3 * R,
            library=lambda: 0.5 * (
                torch.sum(Xt.index_select(1, ir) * Dt.index_select(1, ic), 0)
                + torch.sum(Xt.index_select(1, ic) * Dt.index_select(1, ir),
                            0)))


def probe_edge_checks(dev):
    """P3's transposed layout and P2 at their edge shapes, bit for bit
    against their plain versions on the card: P3 under every schedule
    whose rows fit a block (the L2 schedule, 1 and 2 staged rows; a
    checkout without them: its one), at R = 1, 3, 24, 40, K = 1 and K
    not a multiple of 4 or of a slice, repeated ids, ids at 0 and n - 1,
    and n = 60000 (past a block's shared memory); P2 at r = 3, 24, 40,
    2 and 3 planes, K not a multiple of 16, 16-id spans of ~60 rows
    (past a 16-row chunk) and X 4 bytes into its storage."""
    import inspect

    import numpy as np
    import torch

    from lorads_torch.probes import gather
    from lorads_torch.probes import onehot as oh

    rng = np.random.default_rng(12)
    staged = "rb" in inspect.signature(gather.row_gather).parameters
    cases = 0
    for R, n, K in ((1, 20000, 100000), (3, 20000, 1), (24, 20000, 99997),
                    (40, 20000, 100000), (3, 60000, 50000)):
        X = torch.as_tensor(rng.standard_normal((R, n)).astype(np.float32),
                            device=dev)
        ids_np = rng.integers(0, n, K).astype(np.int32)
        ids_np[:3] = [0, n - 1, n - 1][:K]
        ids = torch.as_tensor(ids_np, device=dev)
        ref = gather.row_gather_plain(X, ids, "rk")
        fit = (gather._smem_optin(torch.cuda.current_device())
               // (-(-n // 4) * 16)) if staged else 0
        for rb in (0, 1, 2)[:fit + 1] if staged else (None,):
            kw = {} if rb is None else {"rb": rb}
            got = gather.row_gather(X, ids, "rk", check=False, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"row_gather transposed [{R},{n}] K={K} "
                                     f"rb={rb}: not exact")
            cases += 1
    for n, K, r in ((5000, 1237, 3), (5000, 1237, 24), (5000, 1237, 40),
                    (20000, 80003, 40)):
        ids_np = np.sort(np.concatenate([rng.integers(0, n, K - 40),
                                         np.full(40, 700)])).astype(np.int32)
        plan = oh.plan_sorted_gather(ids_np, n, KT=256, device=dev)
        for offset in (0, 1):
            store = torch.zeros(n * r + offset, device=dev)
            X = store[offset:].view(n, r)
            X.copy_(torch.as_tensor(
                rng.standard_normal((n, r)).astype(np.float32)))
            for mode in ("bf16x3", "bf16x2"):
                got = oh.sorted_gather(X, plan, mode)
                ref = oh.sorted_gather_plain(X, plan, mode)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"onehot_gather n={n} K={K} r={r} "
                                         f"offset {offset} {mode}: not "
                                         "exact")
                cases += 1
    # P3's 1-D gather: K = 1-7 (no 4-id vector), ids 4 bytes into their
    # storage, the [n, 1] form, under each way that fits (the direct
    # kernel, the table staged as one row)
    fit = (gather._smem_optin(torch.cuda.current_device())
           // (-(-20000 // 4) * 16)) if staged else 0
    for n, K in ((20000, 1), (20000, 3), (20000, 7), (20000, 100001),
                 (100000, 20000)):
        X = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                            device=dev)
        store = torch.as_tensor(rng.integers(0, n, K + 1).astype(np.int32),
                                device=dev)
        for ids in (store[:K], store[1:]):
            ref = torch.take(X, ids.long())
            for rb in (0, 1)[:(fit if n == 20000 else 0) + 1] \
                    if staged else (None,):
                kw = {} if rb is None else {"rb": rb}
                for T, want in ((X, ref), (X[:, None], ref[:, None])):
                    got = gather.row_gather(T, ids, check=False, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"row_gather 1-D n={n} K={K} rb={rb} "
                            f"{tuple(T.shape)}: not exact")
                    cases += 1
    print(f"probe edges: row_gather transposed and 1-D, onehot_gather, "
          f"{cases} cases, each bit for bit its plain version")
    scatter_edge_checks(dev, rng)


def scatter_edge_checks(dev, rng):
    """P4 at its edge shapes against its plain version on the card, each
    output within 4 eps32 x sum |values| and every row no id touches
    exactly 0 from an output whose memory held NaN: r = 1 (1-D values),
    2, 5 and 24 (the float2, scalar and float4 forms), K = 0, 1, 7 and
    5000, values 4 bytes into their storage (scalar reductions), and
    sorted ids with a hub of 5000 equal ids."""
    import numpy as np
    import torch

    from lorads_torch.probes import gather

    eps32 = float(np.finfo(np.float32).eps)
    n, cases = 1000, 0

    def one(vals, ids, label):
        # the output takes this block: freed, it is the caching
        # allocator's fit for the next request of its size, and nothing
        # asks in between
        width = math.prod(vals.shape[1:])
        garbage = torch.full((n * width,), float("nan"), device=dev)
        at = garbage.data_ptr()
        del garbage
        got = gather.scatter_add(vals, ids, n, check=False)
        if got.data_ptr() != at:
            raise AssertionError(f"scatter_add {label}: the output did not "
                                 "take the NaN block")
        ref = gather.scatter_add_plain(vals, ids, n)
        l1 = gather.scatter_add_plain(vals.abs(), ids, n)
        torch.cuda.synchronize()
        err = check(f"scatter_add {label}", got, ref, 4 * eps32
                    * l1.double() + 1e-300)
        idle = torch.ones(n, dtype=torch.bool, device=dev)
        idle[ids.long()] = False
        if not torch.equal(got[idle], ref[idle]) or bool(got[idle].any()):
            raise AssertionError(f"scatter_add {label}: a row no id "
                                 "touches is not 0")
        return err

    for r in (1, 2, 5, 24):
        for K in (0, 1, 7, 5000):
            shape = (K,) if r == 1 else (K, r)
            for offset in (0, 1):
                store = torch.as_tensor(rng.standard_normal(
                    math.prod(shape) + offset).astype(np.float32),
                    device=dev)
                vals = store[offset:].view(shape)
                ids = torch.as_tensor(rng.integers(0, n // 2, K).astype(
                    np.int32), device=dev)
                one(vals, ids, f"r={r} K={K} offset {offset}")
                cases += 1
    K = 20000
    vals = torch.as_tensor(rng.standard_normal((K, 24)).astype(np.float32),
                           device=dev)
    hub = np.sort(np.concatenate([rng.integers(0, n // 2, K - 5000),
                                  np.full(5000, 7)])).astype(np.int32)
    err = one(vals, torch.as_tensor(hub, device=dev), "hub of 5000")
    cases += 1
    print(f"probe edges: scatter_add, {cases} cases, each within 4 eps32 x "
          f"sum |values| (hub max err {err:.3e}), rows no id touches "
          "exactly 0")


def _devloop_cg(name):
    """The CG loop (device-decided) of the first ADMM-like solve of
    ``name``'s first bucket: the mixed-precision CG's f32 inner loop as
    the solve runs it (the bucket's f32 cast, the solver's initial factor
    as F, a seeded right-hand side, from zero, inner_tol 1e-5)."""
    import numpy as np
    import torch

    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.alg import admm, cg, devloop
    from lorads_torch.ops import pattern as pat

    s = LoradsSolver(INSTANCES[name](), LoradsParams(verbose=False),
                     device="cuda")
    bk = pat.cast_floats(s.pd.buckets[0], torch.float32)
    F = s.R.cones[0].to(torch.float32)
    b = torch.as_tensor(np.random.default_rng(11).standard_normal(
        tuple(F.shape)), dtype=torch.float32, device="cuda")
    op = cg.Bound(admm._cg_operator(bk), (F,), devloop.ident(bk))
    return cg.cg_loop(op, torch.zeros_like(b), b, 1e-5, admm.CG_MAX_ITER)


def _alm_solver(name, max_outers=2, dtype="auto"):
    """(solver, carry, inputs but the budget) of ``name`` on the card at
    its first ALM phase's start (rho0, the solver's initial factor, dual
    and history), ``max_outers`` outer iterations a run, at ``dtype``."""
    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.alg import alm

    s = LoradsSolver(INSTANCES[name](),
                     LoradsParams(verbose=False, dtype=dtype,
                                  **PARAMS.get(name, {})),
                     device="cuda")
    p = s.params
    carry, fixed = alm.alm_start(
        s.pd, p, s.R, s.dual, s.hist, alm.ALMStats(rho=s.ps.rho0),
        s.scale_obj_his, s.is_rank_max(), p.alm_rho_factor,
        s.max_alm_sub_iter, max_outers, p.max_alm_iter)
    return s, carry, fixed


def _admm_chunk_solver(name, escalate=None):
    """(solver, ADMM stats) of ``name`` on the card right after its ALM
    phase: the state its ADMM phase starts from.  ``escalate``: a reason;
    the solver then starts at f32 as auto (``_auto_dtype``), runs its ALM
    phase at f32 and escalates to f64 for that reason before its ADMM
    phase, its f32 graphs dropped."""
    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.alg.admm import ADMMStats
    from lorads_torch.alg.alm import ALMStats

    s = LoradsSolver(INSTANCES[name](),
                     LoradsParams(verbose=False, **PARAMS.get(name, {}),
                                  dtype="f32" if escalate else "auto"),
                     device="cuda")
    s._auto_dtype = True      # an auto solve, at f32 where escalate
    alm_stats = ALMStats(rho=s.ps.rho0)
    s.alm_phase(alm_stats, time.time())
    stats = ADMMStats(rho=s.ps.rho0)
    s.alm_to_admm(alm_stats, stats)
    if escalate and not s.maybe_escalate_f64(escalate):
        raise AssertionError(f"{name}: no escalation")
    return s, stats


def admm_chunk_runs(card, name, steps, escalate=None):
    """admm_chunk_checks' three chunks of ``name`` (``steps`` ADMM
    iterations each) from its post-ALM state (``_admm_chunk_solver``;
    ``escalate``: after its ALM phase at f32 and an escalation to f64),
    each replay against the same chunk run eagerly, bit for bit."""
    import torch

    from lorads_torch import device as tdev
    from lorads_torch.alg import admm, devloop
    from lorads_torch.ops import kernels

    s, stats = _admm_chunk_solver(name, escalate)
    where = "" if escalate is None else " (escalated from f32)"
    e_ms, e_reads, lines = 0.0, {}, []
    with devloop.phase():
        locals_, total, vals = admm.admm_init_eval(
            s.pd, s.U, s.V, s.dual, s.scale_obj_his)
        s._set_admm_stats(stats, vals)
        c = s._admm_start(stats, locals_, total)
        for j, n in enumerate(steps):
            c, loop = admm.prepare_chunk(
                s.params, s.pd, c, s.scale_obj_his,
                s.params.max_admm_iter, n, jacobi=s._bucket_jacobi,
                S=s.S)
            kernels.reset_launches()
            reads0 = dict(tdev.HOST_SYNCS_BY)
            torch.cuda.synchronize()
            t0 = time.time()
            eager = devloop.eager_chunk(loop)
            want = loop.pack(loop.inputs, eager).tolist()
            e_ms += (time.time() - t0) * 1e3
            e_launch = dict(kernels.LAUNCHES)
            for k, v in tdev.HOST_SYNCS_BY.items():
                if v > reads0[k]:
                    e_reads[k] = e_reads.get(k, 0) + v - reads0[k]
            kernels.reset_launches()
            got_state, got = devloop.run(loop)
            g_launch = dict(kernels.LAUNCHES)
            same = [torch.equal(g, e) for g, e in zip(
                devloop.flatten(got_state)[0],
                devloop.flatten(eager)[0])]
            if got != want or not all(same):
                raise AssertionError(
                    f"admm chunk {name} #{j}: the graph differs from "
                    f"the eager chunk (pack {got} vs {want}; tensors "
                    f"{[i for i, ok in enumerate(same) if not ok]})")
            nodes = g_launch.pop("loop_cond")
            e_launch.pop("loop_cond")
            if j and (g_launch != e_launch or nodes <= 0):
                raise AssertionError(
                    f"admm chunk {name} #{j}: launches {g_launch} in "
                    f"the replay vs {e_launch} eagerly")
            lines.append(f"#{j} {int(got[6]) - stats.iter} iterations "
                         f"to {int(got[6])}, {int(got[7])} CG, status "
                         f"{int(got[8])}, {nodes} node kernels")
            stats.iter = int(got[6])
            c["carry"] = got_state
        # the last chunk's replay alone, on the device (its key's
        # graph, captured at the first chunk)
        graph, load, _ = devloop.graph_chunk(loop)
        load()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        graph.read("admm")
        g_ms = t0.elapsed_time(t1)
    print(f"admm chunk {name}{where}: 3 chunks ({'; '.join(lines)}): "
          f"graph == eager, bit for bit ({len(same)} tensors, pack {len(got)} "
          f"values); last chunk {g_ms:.3f} ms on the device "
          f"({len(graph.bodies)} distinct bodies), the eager chunks "
          f"{e_ms:.1f} ms wall with host reads {e_reads}; kernel "
          f"launches of the last replay "
          f"{ {k: n for k, n in g_launch.items() if n} }  [{card}]")
    del s


def admm_chunk_checks(card):
    """The ADMM chunk (alg/admm.py) on a theta, a multi-block and an
    LP-block instance from their post-ALM states, three chunks in a row
    as the solver runs them (``admm.admm_chunk``'s loop through
    ``devloop.run``: the first a warm-up and the capture of the graph, a
    WHILE node of ADMM iterations with the CG and refinement loops WHILE
    nodes inside it and the CG restart an IF node; then replays), each
    against the same chunk run eagerly on the card from the same carry
    (the host reading every exit test): pack and state bit for bit, and
    the replays' launches, counted from their packs, equal to the eager
    runs' but for the nodes' own kernel; with the last replay's device
    ms and the eager runs' wall ms."""
    for name, steps in (("theta800", (10, 20, 40)), ("multiblock22", (1, 1, 2)),
                        ("multiblock_lp", (1, 2, 2))):
        admm_chunk_runs(card, name, steps)


def _loop_name(loop):
    k = loop.key
    if isinstance(k, tuple) and k and isinstance(k[0], str):
        return k[0]
    return "repeat" if k is None else loop.label


@contextlib.contextmanager
def body_nodes():
    """{loop name: [the node count of each conditional body captured]}
    while the block runs, for the devloop of any checkout: libcuda's
    count of the body graph's nodes (cuStreamGetCaptureInfo on the body's
    stream before its closing call, cuGraphGetNodes after it).
    A WHILE node is named by its loop's key (``repeat``: devloop.repeat),
    an IF node by the loop whose step it is in, with ``/if``."""
    import ctypes

    import torch

    from lorads_torch.alg import devloop
    from lorads_torch.ops import kernels

    cu = ctypes.CDLL("libcuda.so.1")
    info = cu.cuStreamGetCaptureInfo_v2
    info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_ulonglong),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    out, names = {}, []
    saved = (devloop._while_node, devloop.branch, kernels.cond_end)

    def while_node(loop, *a, **k):
        names.append(_loop_name(loop))
        try:
            return saved[0](loop, *a, **k)
        finally:
            names.pop()

    def branch(*a, **k):
        names.append((names[-1] if names else "") + "/if")
        try:
            return saved[1](*a, **k)
        finally:
            names.pop()

    def cond_end(*a, **k):
        child = next(x for x in list(a) + list(k.values())
                     if isinstance(x, torch.cuda.Stream))
        st, gid = ctypes.c_int(), ctypes.c_ulonglong()
        graph, deps, nd = ctypes.c_void_p(), ctypes.c_void_p(), \
            ctypes.c_size_t()
        rc = info(child.cuda_stream, ctypes.byref(st), ctypes.byref(gid),
                  ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(nd))
        r = saved[2](*a, **k)
        n = ctypes.c_size_t()
        if rc == 0 and graph.value and cu.cuGraphGetNodes(
                graph, None, ctypes.byref(n)) == 0:
            out.setdefault(names[-1] if names else "?", []).append(n.value)
        return r

    devloop._while_node, devloop.branch, kernels.cond_end = (
        while_node, branch, cond_end)
    try:
        yield out
    finally:
        devloop._while_node, devloop.branch, kernels.cond_end = saved


def _nodes_line(nodes):
    return {k: sorted(set(v)) for k, v in sorted(nodes.items())}


def _state_bytes(leaves):
    return sum(t.numel() * t.element_size() for t in leaves)


def _foreach_copy_ms(leaves):
    """torch._foreach_copy_ of the leaves into buffers of their shapes: one
    PyTorch call for the same copies (the port never calls it), device ms
    a call (20 calls in a CUDA graph)."""
    import torch
    dst = [torch.empty_like(t) for t in leaves]
    return timing().device_time_ms(lambda: torch._foreach_copy_(dst, leaves))


def _while_run(card, label, loop, what, label_read, runs_at, parts=None):
    """A real device loop replayed alone: µs a run of its body (three
    replays between CUDA events, the median, over the runs the pack
    reports at ``runs_at``), its state's bytes (the tail copies each leaf
    the step makes anew: all of them here) and their bound, the library
    copy of the same leaves and the body's nodes."""
    import statistics

    import torch

    from lorads_torch.alg import devloop

    leaves = devloop.flatten(loop.state)[0]
    nbytes = _state_bytes(leaves)
    with devloop.phase(), body_nodes() as nodes:
        graph, load, _ = devloop.graph_chunk(loop)
        ms, runs = [], None
        for _ in range(3):
            load()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            graph.replay()
            t1.record()
            torch.cuda.synchronize()
            runs = int(graph.read(label_read)[runs_at])
            ms.append(t0.elapsed_time(t1))
    us = statistics.median(ms) / max(runs, 1) * 1e3
    bound_ms, _ = bound_of(2 * nbytes, 0, "f64")
    lib = _foreach_copy_ms(leaves)
    lib_ms = None if lib[0] is None else lib[0]
    by = "" if parts is None else f" by part {parts(loop.state)}"
    print(f"loop_cond {label}: {what}, {runs} runs a replay: "
          f"{us:.3f} us a run on the device; {nbytes} bytes of state "
          f"copied a run{by}, bound {bound_ms * 1e3:.4f} us (read and "
          f"written over 3.35 TB/s); torch._foreach_copy_ of the same "
          f"leaves {'none' if lib_ms is None else f'{lib_ms * 1e3:.3f} us'}"
          f" a call; body nodes {_nodes_line(nodes)}  [{card}]")
    return {"us_a_run": us, "runs": runs, "bytes": nbytes,
            "bound_us": bound_ms * 1e3,
            "library_us": None if lib_ms is None else lib_ms * 1e3,
            "nodes": _nodes_line(nodes)}


def _alm_inner_state_parts(st):
    from lorads_torch.alg import devloop
    names = ("R", "grad", "hist", "caches", "constr_sum", "cert", "pinf",
             "it", "tau", "num_err", "tau_small")
    out = {}
    for name, part in zip(names, st):
        if name == "hist":
            for f in ("s", "y"):
                out[f"hist.{f}"] = _state_bytes(devloop.flatten(
                    getattr(part, f))[0])
            out["hist (beta, head, n_valid)"] = _state_bytes(
                [part.beta, part.head, part.n_valid])
        else:
            out[name] = _state_bytes(devloop.flatten(part)[0])
    return out


def loop_cond_checks(card, floor=True):
    """loop_cond (csrc/graph_cond.cu) alone and at two real carried
    states, on the devloop of the checkout imported (--kernels-of times a
    parent's alike): a WHILE node of N runs whose step adds one (its body
    the add and the node's closing work) against the same loop decided by
    host reads, µs a run; multiblock22's CG (the mixed-precision CG's f32
    inner loop on its bucket, as _devloop_cg builds it) and maxcut20000's
    ALM inner loop from its first ALM phase's start (200 steps: no
    tolerance stops it), each µs a run, the bytes of state its tail copies
    a run and their bound, torch._foreach_copy_ of the same leaves, and
    each body's nodes.  With ``floor`` (this checkout only): the kernel's
    eager launch and its plain version at the microbench's tail, and the
    floor (loop_cond_floor).  Returns loop_cond's kernel entry."""
    import torch

    from lorads_torch.alg import alm, devloop
    from lorads_torch.ops import kernels

    n = 1000
    dev = torch.device("cuda")
    loop = devloop.Loop(
        key=("loop_cond",), step=lambda inp, st, kind: (st[0] + 1,),
        pack=lambda inp, st: st[0].to(torch.float64).reshape(1),
        inputs=(torch.full((), n, dtype=torch.int64, device=dev),),
        state=(torch.zeros((), dtype=torch.int64, device=dev),),
        K=None, label="other", running=lambda inp, st: st[0] < inp[0])
    with devloop.phase(), body_nodes() as nodes:
        graph, load, bufs = devloop.graph_chunk(loop)
        load()
        kernels.reset_launches()
        graph.replay()
        got = graph.read("other")
        launches = kernels.LAUNCHES["loop_cond"]
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        ms = []
        for _ in range(5):
            load()
            t0.record()
            graph.replay()
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1) / n)
        g_ms = sorted(ms)[2]
        torch.cuda.synchronize()
        t = time.time()
        plain = devloop.eager_chunk(loop)
        host_ms = (time.time() - t) * 1e3 / n
    err = abs(float(got[0]) - float(plain[0]))
    if got != [float(n)] or err != 0.0 or launches != n + 1:
        raise AssertionError(f"loop_cond: {got} after {launches} launches "
                             f"(host loop {int(plain[0])})")
    # a run: the tail reads the new 8-byte count and the 8-byte cap, writes
    # the count, reads and writes the 8-byte run counter
    bound_ms, bound_by = bound_of(40, 0, "f64")
    body = _nodes_line(nodes)
    print(f"loop_cond: a WHILE node of {n} runs (body: the add and the "
          f"node's closing work, {body} nodes) == the host-decided loop; "
          f"{g_ms * 1e3:.3f} us a run on the device, host-decided "
          f"{host_ms * 1e3:.3f} us a run (a read each); bound "
          f"{bound_ms:.3e} ms ({bound_by})  [{card}]")
    out = {"max_abs_err": err, "ms": g_ms, "host_decided_ms": host_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "nodes": body}
    # two real carried states
    out["multiblock22 CG"] = _while_run(
        card, "multiblock22 CG", _devloop_cg("multiblock22"),
        "the f32 CG of its bucket", "cg", 0)
    s, carry, fixed = _alm_solver("maxcut20000")
    inner = alm.inner_loop(
        s.pd, carry.R, carry.grad, carry.hist, carry.dual, carry.constr_sum,
        carry.cert_val, carry.rho, 0.0, -1e30, 0.0, s.params.phase1_tol,
        False, 200, check_pinf_conv=False)
    out["maxcut20000 ALM inner"] = _while_run(
        card, "maxcut20000 ALM inner", inner,
        "its first phase's inner L-BFGS loop", "alm_inner", 3,
        _alm_inner_state_parts)
    del s
    if not floor:
        return out
    # the kernel's eager launch against its plain version and the
    # library's copy, at the microbench's tail
    from lorads_torch.alg import looptest
    cap = torch.full((), n, dtype=torch.int64, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    new, buf = cnt + 1, torch.empty_like(cnt)
    ctr = torch.zeros(1, dtype=torch.int64, device=dev)
    prog = looptest.record(loop.running, "loop_cond", ((cap,), (new,)), 1)
    args = (prog, prog.leaves([new]), [(new, buf)], ctr[0])
    d_k = kernels.loop_cond(*args)
    d_p = kernels.loop_cond_plain(*args)
    if not torch.equal(d_k, d_p) or int(ctr[0]) != 2:
        raise AssertionError(f"loop_cond: eager {d_k} vs plain {d_p}")
    cuda_time_ms, device_time_ms = (timing().cuda_time_ms,
                                    timing().device_time_ms)
    k_ms = cuda_time_ms(lambda: kernels.loop_cond(*args))
    k_dev = device_time_ms(lambda: kernels.loop_cond(*args))[0]
    p_ms = cuda_time_ms(lambda: kernels.loop_cond_plain(*args))
    p_dev = device_time_ms(lambda: kernels.loop_cond_plain(*args))[0]
    lib_dev = _foreach_copy_ms([new])[0]
    print(f"loop_cond [the microbench's tail, eager]: decision, copy and "
          f"count == plain; kernel {k_ms:.4f} ms dispatched, {k_dev:.4f} ms "
          f"on the device; plain {p_ms:.4f} ms, {p_dev:.4f} ms; "
          f"torch._foreach_copy_ of the leaf {lib_dev:.4f} ms on the "
          f"device  [{card}]")
    out.update(plain_ms=p_dev, library_ms=lib_dev, kernel_eager_ms=k_dev)
    out.update(loop_cond_floor(card, n, g_ms))
    return out


def loop_cond_floor(card, n, body_ms):
    """The floor under loop_cond's row, timed in this process beside the
    microbench's body (``body_ms``, ms a run): a WHILE node whose body is
    only the node's tail launch (its test the second byte of its own run
    counter, started at 65537 - n, so that the node runs n times), and
    the same count of that launch in a plain CUDA graph; each replayed
    between CUDA events, the median of 5 over n.  The WHILE run is the
    least a loop_cond run can take; its excess over the plain launch is
    the conditional relaunch."""
    import torch

    from lorads_torch.alg import looptest
    from lorads_torch.ops import kernels

    dev = torch.device("cuda")
    ctr = torch.zeros(1, dtype=torch.int64, device=dev)
    pred = ctr.view(torch.uint8)[1:2].view(torch.bool)   # bits 8-15
    ctr2 = torch.zeros(1, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    prog = looptest.record(lambda p: p, "loop_cond floor", (pred,))
    prog1 = looptest.record(lambda p: p, "loop_cond floor", (one,))
    child, side = torch.cuda.Stream(), torch.cuda.Stream()

    def capture(fill):
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                fill()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return graph

    def while_only():
        handle = kernels.cond_begin(True, child, prog, [pred], [])
        kernels.cond_end(handle, child, prog, [pred], [], ctr[0])

    def plain():
        for _ in range(n):
            kernels.loop_cond(prog1, [one], [], ctr2[0])

    def timed(graph, reset):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        ms = []
        for _ in range(5):
            reset()
            t0.record()
            graph.replay()
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1) / n)
        return sorted(ms)[2]

    start = 65537 - n
    g_while, g_plain = capture(while_only), capture(plain)
    w_ms = timed(g_while, lambda: ctr.fill_(start))
    if int(ctr) != 65537:
        raise AssertionError(f"loop_cond floor: the WHILE node ran "
                             f"{int(ctr) - start} times, not {n}")
    p_ms = timed(g_plain, lambda: ctr2.zero_())
    if int(ctr2) != n:
        raise AssertionError(f"loop_cond floor: {int(ctr2)} of {n} plain "
                             f"launches ran")
    print(f"loop_cond floor: a WHILE node of {n} runs, its body only the "
          f"node's tail launch: {w_ms * 1e3:.3f} us a run; that launch "
          f"{n} times in a plain graph: {p_ms * 1e3:.3f} us a launch; the "
          f"conditional relaunch {(w_ms - p_ms) * 1e3:.3f} us a run; the "
          f"microbench's body (the add and the tail) "
          f"{body_ms * 1e3:.3f} us a run, {w_ms / body_ms:.2f} of it the "
          f"floor  [{card}]")
    return {"floor_ms": w_ms, "plain_launch_ms": p_ms,
            "relaunch_ms": w_ms - p_ms}


def loop_cond_site_checks(card):
    """Every program site (lorads_torch.probes.loop_sites: each loop's
    exit test and each branch predicate, built as the solver builds them)
    at f64 and f32 on seeded states with NaN, ±inf, ties at each
    tolerance and the caps: the kernel's decision, its copies of the
    state's leaves and its counter against loop_cond_plain on the same
    tensors on the card, bit for bit."""
    import numpy as np
    import torch

    from lorads_torch.probes import loop_sites

    rng = np.random.default_rng(22)
    lines = []
    for dtype in (torch.float64, torch.float32):
        for site in loop_sites.sites("cuda", dtype):
            r = loop_sites.check(site, 32, rng)
            lines.append(f"{site.name} {str(dtype)[6:]} ({r['ops']} ops, "
                         f"{r['true']}/32 true, launch "
                         f"{r['launch_ms']:.3f} ms)")
    print(f"loop_cond sites: kernel == plain, bit for bit (decision, "
          f"copies, counter): {'; '.join(lines)}  [{card}]")


def alm_outer_checks(card, names=("maxcut20000", "matcomp2000", "theta300"),
                     dtype="auto"):
    """The ALM phase as one device loop (alg/alm.py) on maxcut20000 (K2,
    K3), matcomp2000 (K3, K3p, K4, K5) and theta300 (K4, K7a, the dense
    layouts) from their phases' start, three runs of the outer loop in a
    row as alm_optimize makes them (two outers a run; ``devloop.run``:
    the first a warm-up and the capture of the graph, WHILE nodes for
    the outer, middle, inner and rho loops and an IF node for the cache
    refresh; then replays), each against the same run made eagerly on
    the card from the same carry (the host reading every exit test):
    pack and state bit for bit, and the replays' launches, counted from
    their packs, equal to the eager runs' but for the nodes' own kernel;
    with the last replay's device ms and the eager runs' wall ms.
    ``dtype``: the solvers' (the f32 phase runs maxcut20000 at f32)."""
    import dataclasses

    import torch

    from lorads_torch import device as tdev
    from lorads_torch.alg import alm, devloop
    from lorads_torch.ops import kernels

    for name in names:
        s, carry, fixed = _alm_solver(name, dtype=dtype)
        label = name if dtype == "auto" else f"{name} {dtype}"
        e_ms, e_reads, lines = 0.0, {}, []
        dev = s.pd.rhs.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        with devloop.phase():
            for j in range(3):
                loop = alm.outer_loop(
                    s.pd, alm.ALMInputs(
                        budget=torch.full((), 2 ** 30, device=dev),
                        grind_armed=torch.zeros((), dtype=torch.bool,
                                                device=dev), **fixed),
                    carry, high_acc_mode=s.params.high_acc_mode)
                kernels.reset_launches()
                reads0 = dict(tdev.HOST_SYNCS_BY)
                torch.cuda.synchronize()
                t0 = time.time()
                eager = devloop.eager_chunk(loop)
                want = loop.pack(loop.inputs, eager).tolist()
                e_ms += (time.time() - t0) * 1e3
                e_launch = dict(kernels.LAUNCHES)
                for k, v in tdev.HOST_SYNCS_BY.items():
                    if v > reads0[k]:
                        e_reads[k] = e_reads.get(k, 0) + v - reads0[k]
                kernels.reset_launches()
                reads0 = dict(tdev.HOST_SYNCS_BY)
                got_state, got = devloop.run(loop)
                g_launch = dict(kernels.LAUNCHES)
                g_reads = {k: v - reads0[k] for k, v in
                           tdev.HOST_SYNCS_BY.items() if v > reads0[k]}
                same = [torch.equal(g, e) for g, e in zip(
                    devloop.flatten(got_state)[0],
                    devloop.flatten(eager)[0])]
                if got != want or not all(same):
                    raise AssertionError(
                        f"alm outer {label} #{j}: the graph differs from "
                        f"the eager run (pack {got[:18]} vs {want[:18]}; "
                        f"tensors "
                        f"{[i for i, ok in enumerate(same) if not ok]})")
                if g_reads != {"alm": 1}:
                    raise AssertionError(f"alm outer {label} #{j}: host "
                                         f"reads {g_reads}")
                nodes = g_launch.pop("loop_cond")
                e_launch.pop("loop_cond")
                if j and (g_launch != e_launch or nodes <= 0):
                    raise AssertionError(
                        f"alm outer {label} #{j}: launches {g_launch} in "
                        f"the replay vs {e_launch} eagerly")
                sc = dict(zip(alm.PACK_F + alm.PACK_I, got))
                lines.append(f"#{j} {int(sc['n_done'])} outers to k "
                             f"{int(sc['k'])}, {int(sc['total_inner'])} "
                             f"inner steps, oexit {int(sc['oexit'])}, "
                             f"{nodes} node kernels")
                carry = dataclasses.replace(got_state, total_inner=zero,
                                            n_done=zero, last_inner=zero)
            # the last run's replay alone, on the device (its key's
            # graph, captured at the first run)
            graph, load, _ = devloop.graph_chunk(loop)
            load()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            graph.replay()
            t1.record()
            torch.cuda.synchronize()
            graph.read("alm")
            g_ms = t0.elapsed_time(t1)
        print(f"alm outer {label}: 3 runs ({'; '.join(lines)}): graph == "
              f"eager, bit for bit ({len(same)} tensors, pack {len(got)} "
              f"values), one read a replay; last run {g_ms:.3f} ms on the "
              f"device ({len(graph.bodies)} distinct bodies), the eager "
              f"runs {e_ms:.1f} ms wall with host reads {e_reads}; kernel "
              f"launches of the last replay "
              f"{ {k: n for k, n in g_launch.items() if n} }  [{card}]")
        del s


def _devloop_solve(label, loop, card, cuda_time_ms):
    """A device-decided solve (the CG) replayed from its graph, one WHILE
    node, against the same solve decided by host reads on the card from
    the same state: the state bit for bit, with the replay's device ms
    (between CUDA events) and the eager solve's dispatched ms."""
    import torch

    from lorads_torch.alg import devloop

    eager = devloop.flatten(devloop.eager_chunk(loop))[0]
    graph, load, bufs = devloop.graph_chunk(loop)
    load()
    graph.replay()
    out = graph.read(loop.label)
    got = devloop.flatten(bufs.tree("state"))[0]
    same = [torch.equal(g, e) for g, e in zip(got, eager)]
    if not all(same):
        raise AssertionError(
            f"devloop {label}: the graph replay differs from the eager "
            f"solve in tensors {[i for i, ok in enumerate(same) if not ok]}")
    load()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    graph.read(loop.label)
    g_ms = t0.elapsed_time(t1)
    e_ms = cuda_time_ms(lambda: devloop.eager_chunk(loop), reps=3, warmup=1)
    print(f"devloop {label}: the whole solve ({int(out[0])} iterations) "
          f"one WHILE node: graph replay == eager (a host read an "
          f"iteration), bit for bit ({len(got)} tensors); graph "
          f"{g_ms:.4f} ms on the device, eager {e_ms:.4f} ms dispatched  "
          f"[{card}]")


def devloop_checks(card):
    """The CG (alg/cg.py), a device-decided loop called alone, replayed
    from its CUDA graph as a whole solve against the same solve run
    eagerly on the card from the same state, bit for bit, with the
    graph's device ms (replays between CUDA events) and the eager run's
    dispatched ms (``_devloop_solve``)."""
    from lorads_torch.alg import devloop

    cuda_time_ms = timing().cuda_time_ms
    cases = (("matcomp2000 CG, f32 (K6, K5)", "matcomp2000"),
             ("theta800 CG, f32 (K7a, K4, matmuls)", "theta800"))
    for label, name in cases:
        with devloop.phase():
            _devloop_solve(label, _devloop_cg(name), card, cuda_time_ms)


# K9's tolerances against torch.linalg.eigh on the same matrix, in units
# of n eps (the matrix's type): eigenvalues within SYM_EIG_C n eps ||A||_2,
# each residual column ||A v - lambda v|| within SYM_EIG_C n eps ||A||_2,
# V^T V within SYM_EIG_C n eps of I, and the angle of the lowest
# eigenvectors within their backward errors over the lowest gap
# (Davis-Kahan): sin(angle) * gap within SYM_EIG_C n eps ||A||_2 (a
# cluster's basis and a vector's sign are free)
SYM_EIG_C = 8


def sym_eig_errors(A, got, ref):
    """(eigenvalue error, residual, orthogonality error, the lowest
    vectors' sin(angle) * gap or None) of K9's eigenpairs ``got`` of A
    [B, n, n] against the plain ``ref``, each the worst over the batch and
    scaled by n eps (and ||A||_2 where it carries A's units); raises
    beyond SYM_EIG_C."""
    import torch
    B, n, _ = A.shape
    ne = n * torch.finfo(A.dtype).eps
    (w, V), (wp, Vp) = ((x.double() for x in pair) for pair in (got, ref))
    scale = wp.abs().amax(dim=1).clamp(min=1e-300)           # ||A||_2
    Ad = A.double().tril() + A.double().tril(-1).transpose(1, 2)
    ev = float(((w - wp).abs().amax(dim=1) / scale).max()) / ne
    res = torch.linalg.vector_norm(Ad @ V - V * w[:, None, :], dim=1)
    res = float((res.amax(dim=1) / scale).max()) / ne
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    orth = float((V.transpose(1, 2) @ V - eye).abs().max()) / ne
    align = None
    if n > 1:
        # the lowest vectors' angle against the lowest gap (Davis-Kahan:
        # sin <= backward error / gap), where the gap is not 0
        gap = wp[:, 1] - wp[:, 0]
        gapped = gap > 0
        if bool(gapped.any()):
            v, u = V[:, :, 0], Vp[:, :, 0]
            dots = (v * u).sum(dim=1, keepdim=True)
            sin = torch.linalg.vector_norm(v - dots * u, dim=1)
            align = float((sin * gap / scale)[gapped].max()) / ne
    out = (ev, res, orth, align)
    if max(x for x in out if x is not None) > SYM_EIG_C:
        raise AssertionError(f"sym_eig_small: errors {out} (in n eps) "
                             f"beyond {SYM_EIG_C} against torch.linalg.eigh")
    return out


def _jacobi_flops(sweeps, M):
    """K9's operations for a matrix whose coupled indices, padded to even,
    number M, that took ``sweeps`` sweeps: each of the M - 1 rounds a
    sweep rotates the A blocks of the M/2 pairs (24 flops an off-diagonal
    2 x 2 block, 4 a diagonal one) and V's column pairs (6 an element
    pair), and each sweep's test sums the squares (2 an element)."""
    h = M // 2
    rnd = 12 * h * (h - 1) + 4 * h + 6 * M * h
    return sweeps * ((M - 1) * rnd + 2 * M * M)


def _decoupled(A):
    """[B, n] bool: the indices of each matrix of A [B, n, n] (its lower
    triangle read) whose off-diagonal row is exactly zero, eigenpairs
    already; K9 rotates the others (the coupled ones)."""
    off = A.tril(-1) != 0
    return ~(off.any(dim=1) | off.any(dim=2))


def _coupled(A):
    """[B] the count of each matrix's coupled indices (_decoupled)."""
    return (~_decoupled(A)).sum(dim=1)


def _decoupled_exact(A, got):
    """Each decoupled index of A: K9 gives its diagonal as an eigenvalue
    and e_i as that eigenvalue's column, exactly; raises otherwise."""
    import torch
    w, V = got
    for b, i in _decoupled(A).nonzero().tolist():
        cols = (V[b, i] == 1).nonzero().flatten().tolist()
        e = torch.zeros_like(V[b, :, 0])
        e[i] = 1
        if len(cols) != 1 or not bool(w[b, cols[0]] == A[b, i, i]) \
                or not torch.equal(V[b, :, cols[0]], e):
            raise AssertionError(f"sym_eig_small: decoupled index {i} of "
                                 f"matrix {b} is not its exact eigenpair")


def sym_eig_case(measure, label, A):
    """K9 (kernels.sym_eig_small) on A against its plain version
    (torch.linalg.eigh, also the one library call that computes the same
    function) on the card: the checks of sym_eig_errors and
    _decoupled_exact, then K9's dispatched ms (CUDA events) and device ms
    (20 calls in one CUDA graph), eigh's dispatched ms and device ms (the
    profiler: a graph cannot hold it), the bound (bytes over the memory
    rate or operations over the peak, the operations from the rounds
    this input took) and the dependent-step bound: the largest count of
    rounds run x two dependent shared-memory loads.  The rounds: a matrix
    whose coupled indices (_coupled) pad to M runs M - 1 a sweep;
    microseconds a round: the device time over the largest count of
    rounds of the batch (a CTA a matrix)."""
    import torch

    from lorads_torch.ops import kernels

    B, n, _ = A.shape
    sfx = "f64" if A.dtype == torch.float64 else "f32"
    sweeps = torch.zeros(B, dtype=torch.int32, device=A.device)
    got = kernels.sym_eig_small(A, sweeps)
    ref = kernels.sym_eig_small_plain(A)
    torch.cuda.synchronize()
    errs = sym_eig_errors(A, got, ref)
    _decoupled_exact(A, got)
    err = float((got[0].double() - ref[0].double()).abs().max())
    sw = sweeps.tolist()
    pw = _coupled(A).tolist()
    Ms = [k + (k & 1) for k in pw]
    rounds = [k * max(M - 1, 0) for k, M in zip(sw, Ms)]
    s = A.element_size()
    nbytes = B * (2 * n * n + n) * s
    flops = sum(_jacobi_flops(k, M) for k, M in zip(sw, Ms))
    ms = statistics.median(timing().cuda_time_ms(
        lambda: kernels.sym_eig_small(A)) for _ in range(5))
    dev_ms, dev_by = timing().device_time_ms(lambda: kernels.sym_eig_small(A))
    eigh = lambda: torch.linalg.eigh(A)          # noqa: E731
    pms = statistics.median(timing().cuda_time_ms(eigh) for _ in range(5))
    lib_dev_ms = timing().profiler_time_ms(eigh)
    bms, by = bound_of(nbytes, flops, sfx)
    steps = 2 * max(rounds)
    hop = measure.floors.get("hop_ns")
    step_ms = None if hop is None else steps * hop * 1e-6
    us_round = (None if dev_ms is None or not max(rounds)
                else dev_ms * 1e3 / max(rounds))
    fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa
    whose = "" if KERNELS_OF is None else f" (kernels of {KERNELS_OF})"
    print(f"sym_eig_small [{label}]{whose}: {B} x {n} x {n} {sfx}, coupled "
          f"{pw}, sweeps {sw}, rounds {rounds}, "
          f"{'-' if us_round is None else f'{us_round:.3f}'} us a round: "
          f"eigenvalues {errs[0]:.2f}, residual {errs[1]:.2f}, V^T V "
          f"{errs[2]:.2f}, lowest vectors' angle x gap "
          f"{'no gap' if errs[3] is None else f'{errs[3]:.2f}'} (n eps, "
          f"tol {SYM_EIG_C}); max_abs_err {err:.3e}; kernel {ms:.4f} ms "
          f"device {fmt(dev_ms)} ({dev_by}); plain = library "
          f"torch.linalg.eigh {pms:.4f} ms device {fmt(lib_dev_ms)} "
          f"(profiler); bound {bms:.6f} ms ({by}: {nbytes} B, {flops} "
          f"flop); dependent-step bound {fmt(step_ms)} ({steps} dependent "
          f"shared-memory loads)  [{measure.card}]")
    measure.results.setdefault("sym_eig_small", []).append(dict(
        label=label, max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=pms,
        bound_ms=bms, bound_by=by, library_ms=pms,
        library_device_ms=lib_dev_ms, step_bound_ms=step_ms, sweeps=sw,
        coupled=pw, rounds=rounds, us_a_round=us_round,
        errors_n_eps=errs))


def solve_ex_capture(card):
    """The active set's f32 step solve, torch.linalg.solve_ex on a
    [144, 144] system (lorads_tpu's jnp.linalg.solve, spectral_repair.py:
    160), captured into a CUDA graph: the capture must succeed and the
    replay equal the eager call bit for bit."""
    import numpy as np
    import torch

    rng = np.random.default_rng(17)
    G = torch.as_tensor(rng.standard_normal((144, 600)), device="cuda")
    M = G @ G.T
    M = (M + 1e-2 * torch.trace(M) / 144 * torch.eye(144, device="cuda"))
    M = (M / M.abs().max()).float()
    t = torch.as_tensor(rng.standard_normal(144), dtype=torch.float32,
                        device="cuda")
    want = torch.linalg.solve_ex(M, t)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.linalg.solve_ex(M, t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = torch.linalg.solve_ex(M, t)[0]
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("solve_ex: the graph replay differs from the "
                             "eager call")
    plain = torch.linalg.solve(M.double(), t.double())
    err = float((want.double() - plain).abs().max())
    print(f"solve_ex: [144, 144] f32 captured in a CUDA graph, replay == "
          f"eager bit for bit; against an f64 solve max err {err:.3e}  "
          f"[{card}]")


def _loop_runs(label, loops, card, check_reads=True):
    """Each device-decided loop of ``loops`` (made in turn by calling it
    with the last run's final state, None at first) run eagerly on the
    card (the host reading every exit test) and by devloop.run (the
    first run a warm-up and the capture of the graph, then replays):
    pack and state bit for bit, a replay's launches equal to the eager
    run's but for loop_cond (after the first), one read a replay.
    Returns (the lines, the last replay's device ms from devloop.timed,
    the eager runs' wall ms)."""
    import torch

    from lorads_torch import device as tdev
    from lorads_torch.alg import devloop
    from lorads_torch.ops import kernels

    lines, e_ms, g_ms, state = [], 0.0, None, None
    for j, make in enumerate(loops):
        loop = make(state)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        eager = devloop.eager_chunk(loop)
        want = loop.pack(loop.inputs, eager).tolist()
        torch.cuda.synchronize()
        e_ms += (time.time() - t0) * 1e3
        e_launch = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        reads0 = dict(tdev.HOST_SYNCS_BY)
        with devloop.timed() as times:
            got_state, got = devloop.run(loop)
        torch.cuda.synchronize()
        g_ms = times[-1][0].elapsed_time(times[-1][1])
        g_launch = dict(kernels.LAUNCHES)
        g_reads = {k: v - reads0[k] for k, v in tdev.HOST_SYNCS_BY.items()
                   if v > reads0[k]}
        same = [torch.equal(g, e) for g, e in zip(
            devloop.flatten(got_state)[0], devloop.flatten(eager)[0])]
        if got != want or not all(same):
            raise AssertionError(
                f"{label} #{j}: the graph differs from the eager run (pack "
                f"{got[-4:]} vs {want[-4:]}; tensors "
                f"{[i for i, ok in enumerate(same) if not ok]})")
        if check_reads and g_reads != {loop.label: 1}:
            raise AssertionError(f"{label} #{j}: host reads {g_reads}")
        nodes = g_launch.pop("loop_cond")
        e_launch.pop("loop_cond")
        if j and (g_launch != e_launch or nodes <= 0):
            raise AssertionError(f"{label} #{j}: launches {g_launch} in the "
                                 f"replay vs {e_launch} eagerly")
        lines.append((got, {k: n for k, n in g_launch.items() if n},
                      nodes))
        state = got_state
    return lines, g_ms, e_ms


def _recording_eig(record, name):
    """kernels.sym_eig_small wrapped to keep its last input outside a
    capture under ``name`` in ``record`` (the K9 timings' main-path
    inputs: the last Ritz problem, the last projected slack)."""
    import torch

    from lorads_torch.ops import kernels

    @contextlib.contextmanager
    def ctx():
        fn = kernels.sym_eig_small

        def rec(A, *a, **k):
            if not torch.cuda.is_current_stream_capturing():
                record[name] = A.clone()
            return fn(A, *a, **k)
        kernels.sym_eig_small = rec
        try:
            yield
        finally:
            kernels.sym_eig_small = fn
    return ctx()


def cert_checks(card, record):
    """The certificate's restarted Lanczos (alg/lanczos.py) as one device
    loop on maxcut20000 and gset_torus10000 (K2 r = 1), matcomp2000 (K5
    r = 1) and maxcut20000x4 (K2 at B = 4), each at its solved dual on
    the card: three certificates in a row as the solver's passes make
    them (a random start, then the last Ritz vector plus 1e-3 noise),
    each the loop of solver._certificate (f32 sweeps, K9 on the k x k
    tridiagonal, the f64 Rayleigh refinement in the pack) against the
    same loop run eagerly on the card (_loop_runs): bit for bit,
    launches equal, one ``lanczos`` read a replay, with the last
    replay's device ms.  The first T each takes is kept in ``record``."""
    import numpy as np
    import torch

    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.alg import devloop
    from lorads_torch.alg import solver as solver_mod
    from lorads_torch.ops import pattern as pat

    for name in ("maxcut20000", "gset_torus10000", "matcomp2000",
                 "maxcut20000x4"):
        s = LoradsSolver(INSTANCES[name](), LoradsParams(
            verbose=False, **PARAMS.get(name, {})), device="cuda")
        res = s.solve()
        bk = s.pd.buckets[0]
        w_loc = pat.gather_w(bk, -s.dual)
        rng = np.random.default_rng(3)

        def make(state, bk=bk, w_loc=w_loc, rng=rng):
            if state is None:
                v0 = rng.standard_normal((bk.B, bk.n))
                v0 = torch.as_tensor(v0, device="cuda")
            else:
                v0 = (state.v.double() + 1e-3 * torch.as_tensor(
                    rng.standard_normal((bk.B, bk.n)), device="cuda"))
            return solver_mod._certificate(bk, w_loc, v0, torch.float64)[1]

        with devloop.phase(), _recording_eig(record, name):
            lines, g_ms, e_ms = _loop_runs(f"cert {name}", [make] * 3, card)
        B = bk.B
        desc = "; ".join(
            f"#{j} {int(got[B])} restarts, lam {got[:B]}, {nodes} node "
            f"kernels" for j, (got, _, nodes) in enumerate(lines))
        print(f"cert {name}: {res.status.value}, 3 certificates ({desc}): "
              f"graph == eager, bit for bit, one lanczos read a replay; "
              f"last {g_ms:.3f} ms on the device, the eager runs "
              f"{e_ms:.1f} ms wall; kernel launches of the last replay "
              f"{lines[-1][1]}  [{card}]")
        del s


def repair_checks(card, record):
    """The spectral repair's active set (alg/spectral_repair.py) as one
    device loop: theta_gtoy60 on the card from the state its CPU solve
    reached just before the dual refinement (tests/fixtures/
    cert_states.npz), the repair run with its active-set calls' arguments
    kept; each call's loop then replayed against the same loop run
    eagerly on the card (_loop_runs): bit for bit, launches equal, one
    ``repair`` read a replay, with the last replay's device ms.  The
    first projected slack K9 takes is kept in ``record``."""
    import numpy as np
    import torch

    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.alg import aop, devloop
    from lorads_torch.alg import spectral_repair as rep
    from lorads_torch.alg.admm import ADMMStats

    z = np.load(os.path.join(FIX, "cert_states.npz"))
    st = {k: z["theta_gtoy60_" + k] for k in ("dual", "scale", "pobj",
                                               "dobj", "gap", "dinf")}
    s = LoradsSolver(INSTANCES["theta_gtoy60"](), LoradsParams(verbose=False),
                     device="cuda")
    s.pd = aop.scale_objective(s.pd, float(st["scale"]))
    s.scale_obj_his = float(st["scale"])
    s.dual = torch.as_tensor(st["dual"], device="cuda")
    s.pobj, s.dobj, s.gap = (float(st[k]) for k in ("pobj", "dobj", "gap"))
    calls, run = [], rep._active_set

    def kept(*a, **k):
        calls.append((a, k))
        return run(*a, **k)

    rep._active_set = kept
    try:
        stats = ADMMStats(rho=1.0, dobj=float(st["dobj"]),
                          gap=float(st["gap"]), dinf_l1=float(st["dinf"]))
        accepted = rep.try_spectral_repair(s, stats)
    finally:
        rep._active_set = run
    info = s.spectral_repair_info
    if not calls:
        raise AssertionError("theta_gtoy60's repair ran no active set")
    makers = [lambda _, c=c: rep.active_set_loop(*c[0], **c[1])
              for c in calls]
    with devloop.phase(), _recording_eig(record, "theta_gtoy60"):
        lines, g_ms, e_ms = _loop_runs("repair theta_gtoy60", makers, card)
    m = s.pd.m
    desc = "; ".join(f"#{j} {int(got[m + 1])} iterations, "
                     f"{int(got[m])} constraints, {nodes} node kernels"
                     for j, (got, _, nodes) in enumerate(lines))
    print(f"repair theta_gtoy60: {info['rounds']} rounds, dinf "
          f"{info['dinf_before']:.3e} -> {info['dinf_after']:.3e}, "
          f"{'accepted' if accepted else 'not accepted'}; its "
          f"{len(calls)} active sets ({desc}): graph == eager, bit for "
          f"bit, one repair read a replay; last {g_ms:.3f} ms on the "
          f"device, the eager runs {e_ms:.1f} ms wall; kernel launches of "
          f"the last replay {lines[-1][1]}  [{card}]")
    if not accepted:
        raise AssertionError("theta_gtoy60's repair was not accepted")


def sym_eig_shapes(device="cuda"):
    """K9's two shapes made from a seed: the repair's masked projected
    slack, [1, 48, 48] f64 at real width 24, built as
    alg/spectral_repair.py:179-188 builds it (P masked to the real basis
    width, big = delta + |delta| + 1 on the padded diagonal, delta = 0.5);
    a [1, 36, 36] f32 symmetric matrix with exactly-zero off-diagonal rows
    at 0, 17 and 35, each such row's diagonal that of row 1 (Lanczos
    breakdown slots are re-pointed at alpha_0 with zero coupling)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(18)
    X = rng.standard_normal((1, 48, 48))
    P = torch.as_tensor(X @ np.swapaxes(X, 1, 2) / 48 - 1.0, device=device)
    P = 0.5 * (P + P.transpose(1, 2))
    mask = torch.zeros(1, 48, dtype=torch.float64, device=device)
    mask[:, :24] = 1.0
    m2 = mask[:, :, None] * mask[:, None, :]
    big = 0.5 + abs(0.5) + 1.0
    eye = torch.eye(48, dtype=torch.float64, device=device)[None]
    masked = P * m2 + big * (1.0 - m2) * eye
    X = rng.standard_normal((1, 36, 36))
    D = X + np.swapaxes(X, 1, 2)
    for i in (0, 17, 35):
        D[:, i, :] = 0.0
        D[:, :, i] = 0.0
        D[:, i, i] = D[:, 1, 1]
    free = torch.as_tensor(D, dtype=torch.float32, device=device)
    return {"masked width 24": masked.contiguous(),
            "decoupled rows 0, 17, 35": free}


def sym_eig_checks(measure, record):
    """K9 at the main paths' shapes (the inputs kept by cert_checks and
    repair_checks, or read back by --eig-inputs) and on its two seeded
    shapes (sym_eig_shapes)."""
    for name, A in {**record, **sym_eig_shapes()}.items():
        sym_eig_case(measure, name, A)


def probes_path(card):
    """The probes' main path: the probe driver at --small, with the
    launch counts reset just before and read just after."""
    import torch

    from lorads_torch.ops import kernels
    from lorads_torch.probes.__main__ import main as probes_main

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    if probes_main(["--small"]) != 0:
        raise AssertionError("the probe driver failed")
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    print(f"main path probes: driver {time.time() - t0:.2f} s, kernel "
          f"launches {counts}  [{card}]")
    for k in PATH_KERNELS["probes"]:
        if counts[k] <= 0:
            raise AssertionError(f"the probes path never launched {k}")
    return counts


@contextlib.contextmanager
def _run_reads():
    """{label: runs} of the device-decided loops run from the top
    (devloop.run) inside, each asserted to read the host once, under
    its loop's label (a certificate's Lanczos loop ``lanczos``, an active
    set or a CGNR ``repair``, an ALM run ``alm``, an ADMM chunk
    ``admm``)."""
    from lorads_torch import device as tdev
    from lorads_torch.alg import devloop

    runs, run = {}, devloop.run

    def counted(loop):
        before = dict(tdev.HOST_SYNCS_BY)
        out = run(loop)
        reads = {k: n - before[k] for k, n in tdev.HOST_SYNCS_BY.items()
                 if n > before[k]}
        if reads != {loop.label: 1}:
            raise AssertionError(f"a {loop.label} loop's run read the host "
                                 f"{reads}")
        runs[loop.label] = runs.get(loop.label, 0) + 1
        return out

    devloop.run = counted
    try:
        yield runs
    finally:
        devloop.run = run


# the main paths' walls by instance (solve_path), for the f32 phase's
# lines, the walls of their solve() calls alone, for the shard phase's,
# and their results, for the memo phase's grouped solves
WALLS = {}
SOLVE_WALLS = {}
RESULTS = {}


def _bucket_shapes(solver):
    return [f"{bk.B}x{bk.n}{'d' if bk.dense else 's'}"
            for bk in solver.pd.buckets]


def solve_path(card, path, instances):
    """One main path: its solves through the public entry points, with
    the launch counts reset just before and read just after."""
    import numpy as np
    import torch

    from lorads_torch import LoradsParams, LoradsSolver, SolverStatus
    from lorads_torch import device as tdev
    from lorads_torch.core.problem import split_objectives_factors
    from lorads_torch.ops import kernels

    from lorads_torch.alg import devloop

    problems = [(name, make()) for name, make in instances]
    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()
    devloop.BODY_NODES.clear()
    for name, problem in problems:
        before = dict(kernels.LAUNCHES)
        syncs0 = tdev.HOST_SYNCS
        by0 = dict(tdev.HOST_SYNCS_BY)
        graphs0 = dict(kernels.GRAPHS)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with _run_reads() as runs:
            solver = LoradsSolver(problem, LoradsParams(
                verbose=False, **PARAMS.get(name, {})), device="cuda")
            torch.cuda.synchronize()
            t1 = time.time()
            res = solver.solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
        WALLS[name] = wall
        SOLVE_WALLS[name] = time.time() - t1
        # each problem keeps its device data (the memo) while the path's
        # list holds it
        mem = (torch.cuda.memory_allocated() / 2 ** 20,
               torch.cuda.max_memory_allocated() / 2 ** 20)
        launches = {k: kernels.LAUNCHES[k] - before[k]
                    for k in kernels.LAUNCHES}
        by = {k: tdev.HOST_SYNCS_BY[k] - by0[k] for k in by0
              if tdev.HOST_SYNCS_BY[k] > by0[k]}
        admm_reads = {k: n for k, n in solver.admm_reads_by.items() if n}
        graphs = {k: kernels.GRAPHS[k] - graphs0[k] for k in graphs0}
        RESULTS[name] = dict(res=res, launches=launches, reads=by,
                             wall=wall, cg=solver.admm_cg_total,
                             buckets=_bucket_shapes(solver))
        ref = REFERENCE_POBJ[name]
        rel = abs(res.pobj - ref) / abs(ref)
        rep = getattr(solver, "spectral_repair_info", None)
        repair = ("not run" if rep is None else
                  f"{rep['rounds']} rounds, dinf {rep['dinf_before']:.3e} "
                  f"-> {rep['dinf_after']:.3e}, "
                  + ("accepted" if rep["accepted"] else "not accepted"))
        shapes = _bucket_shapes(solver)
        print(f"solve {name}: status {res.status.value} pObj "
              f"{res.pobj!r} (lorads_tpu CPU f64 {ref!r}, rel "
              f"{rel:.2e}) pinf {res.pinf_l1:.3e} gap {res.gap:.3e} "
              f"dinf {res.dinf_l1:.3e} wall {wall:.3f} s (certificate "
              f"{res.dual_infeas_time:.3f} s) buckets {shapes} LP columns "
              f"{problem.n_lp_cols} ALM outer "
              f"{res.alm_stats.outer_iter} inner {res.alm_stats.inner_iter}"
              f" ADMM {res.admm_stats.iter} CG {solver.admm_cg_total} "
              f"divergence retries {solver.admm_retries} "
              f"rank {res.ranks} cert restarts {solver.last_cert_restarts} "
              f"spectral repair: {repair}; host syncs "
              f"{tdev.HOST_SYNCS - syncs0} {by}, in ADMM {admm_reads}, "
              f"device-loop runs {runs} (one read each) "
              f"graphs captured "
              f"{graphs['captured']} replayed {graphs['replayed']} "
              f"(launches in replays {graphs['launches']}) launches "
              f"{launches}; device memory allocated {mem[0]:.1f} MiB "
              f"after, peak {mem[1]:.1f} MiB  [{card}]")
        if res.status is not SolverStatus.PRIMAL_DUAL_OPTIMAL:
            raise AssertionError(f"{name}: status {res.status.value}")
        # the ADMM chunks' CG runs inside their graphs, the ALM's inner
        # loop inside the ALM phase's graph (one read a run, label alm)
        if admm_reads.get("cg", 0) or admm_reads.get("cg_ir", 0):
            raise AssertionError(f"{name}: CG reads in ADMM {admm_reads}")
        if by.get("alm_inner", 0) or not by.get("alm", 0):
            raise AssertionError(f"{name}: ALM reads {by}")
        # each Lanczos certificate of a bucket and each active set one run
        # and one read (_run_reads asserts the read)
        cert = [r for r in solver.last_cert_restarts if r >= 0]
        if cert and not runs.get("lanczos"):
            raise AssertionError(f"{name}: no Lanczos loop ran ({runs})")
        if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
            raise AssertionError(f"{name}: pObj {res.pobj} vs {ref}")
        fs, lp_vals = solver.factor_blocks()
        for blk, F in zip(problem.blocks, fs):
            if F.shape[0] != blk.dim or not np.all(np.isfinite(F)):
                raise AssertionError(f"{name}: bad factor {F.shape}")
        if lp_vals is not None and not (
                lp_vals.shape == (problem.n_lp_cols,)
                and np.all(np.isfinite(lp_vals)) and np.all(lp_vals >= 0)):
            raise AssertionError(f"{name}: bad LP values")
        if name in REFERENCE_SPLIT:
            objs = split_objectives_factors(problem.parts, fs, lp_vals)
            rels = [abs(a - b) / abs(b)
                    for a, b in zip(objs, REFERENCE_SPLIT[name])]
            print(f"solve {name}: per-instance objectives {objs} (rel to "
                  f"lorads_tpu's single-instance solves "
                  f"{['%.2e' % r for r in rels]})")
            if max(rels) > POBJ_RTOL:
                raise AssertionError(f"{name}: per-instance objectives")
        if name in ("maxcut300", "matcomp500") and res.admm_stats.iter == 0:
            raise AssertionError(f"{name} did not reach ADMM")
        if path in ("matcomp", "theta", "lp") and solver.admm_cg_total <= 0:
            raise AssertionError(f"{name}: ADMM ran no CG iteration")
    counts = dict(kernels.LAUNCHES)
    print(f"main path {path}: kernel launches {counts} (uvt_split with U "
          f"is V: {kernels.ONE_DOT_LAUNCHES['uvt_split']}), host syncs "
          f"{tdev.HOST_SYNCS}; conditional bodies' nodes by loop (each "
          f"body ends in one loop_cond launch) "
          f"{_nodes_line(devloop.BODY_NODES)}")
    for k in PATH_KERNELS[path]:
        if counts[k] <= 0:
            raise AssertionError(f"the {path} path never launched {k}")
    return counts


def cgnr_path(card):
    """The CGNR dual refinement's path: theta_gtoy60 with the spectral
    dual repair replaced, in this process only, by a reject, so that the
    solve goes on to the CGNR refinement (K4's dense A(.) and build_w in
    every CGNR iteration) and, as in lorads_tpu's CPU run of the same
    forced path, rejects its step and takes the level-2 reopt.  Held to
    that run's status and objective (REFERENCE_CGNR); the launch counts
    reset just before and read just after."""
    import torch

    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch import device as tdev
    from lorads_torch.alg import solver as solver_mod
    from lorads_torch.ops import kernels

    name = "theta_gtoy60"
    problem = INSTANCES[name]()
    status_ref, pobj_ref = REFERENCE_CGNR[name]
    repair, refine = solver_mod.try_spectral_repair, solver_mod.dual_ls_refine
    k4 = []

    def counted_refine(*a, **k):
        before = kernels.LAUNCHES["gather_segsum"]
        reads = tdev.HOST_SYNCS_BY["repair"]
        out = refine(*a, **k)
        k4.append(kernels.LAUNCHES["gather_segsum"] - before)
        cgnr_reads.append(tdev.HOST_SYNCS_BY["repair"] - reads)
        return out

    lines, cgnr_reads = [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()
    t0 = time.time()
    solver_mod.try_spectral_repair = lambda solver, stats: False
    solver_mod.dual_ls_refine = counted_refine
    try:
        solver = LoradsSolver(problem, LoradsParams(verbose=False),
                              device="cuda")
        solver.log = lambda *a, **k: lines.append(" ".join(map(str, a)))
        res = solver.solve()
        torch.cuda.synchronize()
    finally:
        solver_mod.try_spectral_repair = repair
        solver_mod.dual_ls_refine = refine
    wall = time.time() - t0
    counts = dict(kernels.LAUNCHES)
    rel = abs(res.pobj - pobj_ref) / abs(pobj_ref)
    info = solver.dual_refine_info
    refine_lines = [ln for ln in lines if ln.startswith("dual refine:")]
    print(f"solve {name} (spectral repair forced to reject): status "
          f"{res.status.value} pObj {res.pobj!r} (lorads_tpu CPU f64 on "
          f"the same forced path: {status_ref}, {pobj_ref!r}; rel "
          f"{rel:.2e}) pinf {res.pinf_l1:.3e} gap {res.gap:.3e} dinf "
          f"{res.dinf_l1:.3e} wall {wall:.3f} s host syncs "
          f"{tdev.HOST_SYNCS}  [{card}]")
    print(f"  {refine_lines}")
    print(f"  CGNR: {info['iters']} iterations (cap {info['n_iter']}), "
          f"{info['seconds']:.3f} s, {info['host_syncs']} host reads "
          f"(certificates included; the CGNR runs' own {cgnr_reads}), "
          f"{k4} K4 launches; main path cgnr: kernel launches {counts}")
    if len(refine_lines) != 1:
        raise AssertionError(f"{name}: no 'dual refine:' line in the log")
    if res.status.value != status_ref:
        raise AssertionError(f"{name}: status {res.status.value}, "
                             f"lorads_tpu {status_ref}")
    if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
        raise AssertionError(f"{name}: pObj {res.pobj} vs {pobj_ref}")
    if not (k4 and k4[0] > 0 and info["iters"] > 0):
        raise AssertionError("the CGNR refinement launched no K4")
    if cgnr_reads != [1] * len(k4):
        raise AssertionError(f"CGNR host reads {cgnr_reads}: one a run")
    for k in PATH_KERNELS["cgnr"]:
        if counts[k] <= 0:
            raise AssertionError(f"the cgnr path never launched {k}")
    return counts


def f32_path(card):
    """The f32 phase: first the graphs at f32 and after an escalation,
    each replay against the same run made eagerly on the card, bit for bit
    (three ALM runs of maxcut20000 at f32; matcomp2000's ALM phase at f32,
    the escalation to f64 its solve takes at ADMM entry, then three ADMM
    chunks at f64 on the f64 data).  Then, with the launch counts reset
    just before and read just after, four solves through LoradsSolver at
    ``dtype="f32"`` (REFERENCE_F32: maxcut20000 and multiblock_lp pure
    f32; matcomp2000 and theta300 started at f32 as auto), each held to
    lorads_tpu's CPU run from the same start (FROM_CARD_ALM: from the
    card's state at the end of the f32 ALM phase, that state held bit
    for bit): its status, its escalation reasons in order, and pObj
    within f32_band; the
    backend line at f32, and at f64 after each escalation; one host read
    a device-loop run; the kernels each instance must launch at f32
    (PATH_KERNELS["f32 ..."], kernels.F32_LAUNCHES); the escalation's
    seconds and the captures after it.  Each solve's f32 wall beside the
    f64 wall of the main path's solve of the same instance in this
    process.  Returns the launch counts."""
    import torch

    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch import device as tdev
    from lorads_torch.alg import devloop
    from lorads_torch.ops import kernels

    alm_outer_checks(card, ("maxcut20000",), "f32")
    admm_chunk_runs(card, "matcomp2000", (1, 1, 1), escalate=ESCALATE_CHECK)

    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()
    for name, (auto, st_ref, esc_ref, p_ref) in REFERENCE_F32.items():
        problem = INSTANCES[name]()
        before = dict(kernels.LAUNCHES)
        before32 = dict(kernels.F32_LAUNCHES)
        graphs0 = dict(kernels.GRAPHS)
        by0 = dict(tdev.HOST_SYNCS_BY)
        lines, esc_at = [], []
        torch.cuda.synchronize()
        t0 = time.time()
        with _run_reads() as runs, devloop.captures() as caps:
            solver = LoradsSolver(problem, LoradsParams(
                dtype="f32", **PARAMS.get(name, {})), device="cuda")
            solver._auto_dtype = auto
            solver.log = lambda *a, **k: lines.append(" ".join(map(str, a)))
            alm_phase, alm_exit = solver.alm_phase, []

            def first_alm(stats, *a, _alm=alm_phase, **k):
                out = _alm(stats, *a, **k)
                if not alm_exit:
                    alm_exit.append((stats.inner_iter, stats.pobj,
                                     stats.dobj))
                return out
            solver.alm_phase = first_alm
            escalate = solver.maybe_escalate_f64

            def timed_escalate(reason, _esc=escalate):
                ok = _esc(reason)
                if ok:
                    torch.cuda.synchronize()
                    esc_at.append(time.time())
                return ok
            solver.maybe_escalate_f64 = timed_escalate
            res = solver.solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: kernels.LAUNCHES[k] - before[k]
                    for k in kernels.LAUNCHES if kernels.LAUNCHES[k]
                    > before[k]}
        at32 = {k: kernels.F32_LAUNCHES[k] - before32[k]
                for k in kernels.F32_LAUNCHES
                if kernels.F32_LAUNCHES[k] > before32[k]}
        by = {k: tdev.HOST_SYNCS_BY[k] - by0[k] for k in by0
              if tdev.HOST_SYNCS_BY[k] > by0[k]}
        graphs = {k: kernels.GRAPHS[k] - graphs0[k] for k in graphs0}
        esc = [r for r, _ in solver.escalations]
        backend = [ln.split("dtype=")[1].split()[0] for ln in lines
                   if ln.startswith("lorads_torch backend:")]
        after = [(k, t) for k, t0_, t in caps if esc_at and t0_ > esc_at[0]]
        ref64 = REFERENCE_POBJ[name]
        held, rtol = f32_band(name)
        rel = abs(res.pobj - ref64) / abs(ref64)
        rel32 = abs(res.pobj - p_ref) / abs(p_ref)
        f64_wall = WALLS.get(name)
        print(f"f32 {name}: {'auto, ' if auto else ''}status "
              f"{res.status.value} escalations {esc} (lorads_tpu CPU from "
              f"the same start: {st_ref}, {esc_ref}) pObj {res.pobj!r} "
              f"(rel {rel:.2e} to the f64 reference {ref64!r}; rel "
              f"{rel32:.2e} to lorads_tpu's f32 {p_ref!r}; held within "
              f"{rtol:.0e} of {held!r}) pinf {res.pinf_l1:.3e} gap {res.gap:.3e} dinf "
              f"{res.dinf_l1:.3e} backend dtypes {backend}; f32 wall "
              f"{wall:.3f} s against the main path's f64 wall "
              + ("not run" if f64_wall is None else f"{f64_wall:.3f} s")
              + f" (certificate {res.dual_infeas_time:.3f} s) ALM inner "
              f"{res.alm_stats.inner_iter} ADMM {res.admm_stats.iter} CG "
              f"{solver.admm_cg_total}; escalation seconds "
              f"{[round(t, 4) for _, t in solver.escalations]}, then "
              f"{sum(1 for k, _ in after if k == 'capture')} captures in "
              f"{sum(t for k, t in after if k == 'capture'):.3f} s and "
              f"{sum(1 for k, _ in after if k == 'warm_up')} warm-ups in "
              f"{sum(t for k, t in after if k == 'warm_up'):.3f} s; host "
              f"syncs {by}, device-loop runs {runs} (one read each), graphs "
              f"captured {graphs['captured']} replayed {graphs['replayed']}"
              f"; launches {launches}, at f32 {at32}  [{card}]")
        # the solve's log, but the per-iteration lines
        for ln in lines:
            if not ln.startswith(("ALM Outer", "ADMM Iter")):
                print(f"  {ln}")
        if name in FROM_CARD_ALM:
            state, (st_ref, esc_ref, _) = FROM_CARD_ALM[name]
            print(f"  held to lorads_tpu's CPU run from the card's state at "
                  f"the ALM exit {state}: {st_ref}, {esc_ref}, pObj "
                  f"{held!r} (rel {abs(res.pobj - held) / abs(held):.2e}"
                  f"); this run's ALM exit {alm_exit[0]}")
            if alm_exit[0] != state:
                raise AssertionError(f"f32 {name}: ALM exit {alm_exit[0]}, "
                                     f"not the state {state} lorads_tpu "
                                     "was resumed from")
        if res.status.value != st_ref or esc != esc_ref:
            raise AssertionError(f"f32 {name}: {res.status.value} {esc}, "
                                 f"lorads_tpu {st_ref} {esc_ref}")
        if not (math.isfinite(res.pobj)
                and abs(res.pobj - held) <= rtol * abs(held)):
            raise AssertionError(f"f32 {name}: pObj {res.pobj!r}")
        if backend != ["float32"] + ["float64"] * len(esc):
            raise AssertionError(f"f32 {name}: backend lines {backend}")
        if by.get("alm_inner", 0) or not by.get("alm", 0):
            raise AssertionError(f"f32 {name}: ALM reads {by}")
        if esc and not any(k == "capture" for k, _ in after):
            raise AssertionError(f"f32 {name}: no capture after the "
                                 "escalation")
        for k in PATH_KERNELS[f"f32 {name}"]:
            if at32.get(k, 0) <= 0:
                raise AssertionError(f"f32 {name}: {k} never launched at "
                                     "f32")
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    print(f"main path f32: kernel launches {counts}, at f32 "
          f"{ {k: n for k, n in kernels.F32_LAUNCHES.items() if n} }, host "
          f"syncs {tdev.HOST_SYNCS}")
    return counts


def _data_tensors(tree, out=None):
    """Every tensor of a ProblemData (its buckets, their tile schedules,
    the LP block), in order."""
    import torch
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _data_tensors(t, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            _data_tensors(getattr(tree, f), out)
    return out


def _same_solve(a, sa, b, sb):
    """Two solves (results a, b of solvers sa, sb) bit for bit: status,
    ALM, ADMM and CG counts, pObj, R -> (equal, what differs)."""
    import torch
    diff = []
    if a.status is not b.status:
        diff.append("status")
    if (a.alm_stats.outer_iter, a.alm_stats.inner_iter) != (
            b.alm_stats.outer_iter, b.alm_stats.inner_iter):
        diff.append("ALM")
    if a.admm_stats.iter != b.admm_stats.iter:
        diff.append("ADMM")
    if sa.admm_cg_total != sb.admm_cg_total:
        diff.append("CG")
    if a.pobj != b.pobj:
        diff.append(f"pObj {a.pobj!r} {b.pobj!r}")
    if not all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(a.R.cones + (a.R.lp,),
                               b.R.cones + (b.R.lp,))):
        diff.append("R")
    return not diff, diff


def memo_path(card):
    """The memo phase (lines "memo ..."), with the launch counts reset
    just before and read just after.  (a) maxcut20000 and matcomp2000:
    a construction and solve on a fresh problem object (cold), then a
    second on the same object, which takes the presolve and the device
    data from the memo (``s2.ps is s1.ps``, every tensor of its
    ProblemData the first's); the construction seconds, solve walls and
    ``torch.cuda.max_memory_allocated`` of each; the second solve held
    bit for bit to the first, a solve on a fresh object (status, ALM,
    ADMM and CG counts, pObj, R).  (b) matcomp2000 from an f32 start as
    the f32 phase runs it (auto): an f32 solver built first holds the
    f32 data; the auto solve escalates at ADMM entry (REFERENCE_F32) and
    evicts them; then the holder and an f32 construction after the
    escalation (which builds the f32 data again) solve, each bit for bit
    a fresh object's f32 solve (ADMM capped at F32_MEMO_ADMM iterations:
    at pure f32 its target lies below the f32 floor).  (c)
    group_buckets=False on multiblock22 and multiblock_lp: one B = 1
    bucket a block, primal_dual_optimal, pObj within POBJ_RTOL of
    lorads_tpu's ungrouped CPU f64 pObj (REFERENCE_UNGROUPED), beside
    the main path's grouped solve of the instance, with the bucket
    shapes, launches by kernel, host reads by label and walls.  Returns
    the launch counts."""
    import torch

    from lorads_torch import LoradsParams, LoradsSolver, SolverStatus
    from lorads_torch import device as tdev
    from lorads_torch.ops import kernels

    MiB = 2 ** 20
    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()

    # ---- (a) the second construction of one problem object
    for name in ("maxcut20000", "matcomp2000"):
        problem = INSTANCES[name]()
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            at0 = torch.cuda.memory_allocated() / MiB
            t0 = time.time()
            s = LoradsSolver(problem, LoradsParams(
                verbose=False, **PARAMS.get(name, {})), device="cuda")
            torch.cuda.synchronize()
            t1 = time.time()
            pd = s.pd
            res = s.solve()
            torch.cuda.synchronize()
            runs.append((s, pd, res, t1 - t0, time.time() - t1,
                         (at0, torch.cuda.max_memory_allocated() / MiB)))
        (s1, pd1, r1, c1, w1, m1), (s2, pd2, r2, c2, w2, m2) = runs
        same_data = pd2 is pd1 and all(
            a is b for a, b in zip(_data_tensors(pd2), _data_tensors(pd1)))
        same, diff = _same_solve(r2, s2, r1, s1)
        print(f"memo {name}: construction cold {c1:.4f} s, from the memo "
              f"{c2:.4f} s; solve walls {w1:.4f} s, {w2:.4f} s; "
              f"device memory allocated at the start / max_memory_allocated "
              f"{m1[0]:.1f} / {m1[1]:.1f} MiB, {m2[0]:.1f} / {m2[1]:.1f} MiB "
              f"(the second run's start holds the memo's data and the "
              f"first solver's state); presolve "
              f"reused {s2.ps is s1.ps}, device data reused {same_data}; "
              f"the second solve bit for bit the first (a fresh object's) "
              f"{same}{'' if same else f' {diff}'}: {r2.status.value} "
              f"ALM {r2.alm_stats.outer_iter}/{r2.alm_stats.inner_iter} "
              f"ADMM {r2.admm_stats.iter} CG {s2.admm_cg_total} pObj "
              f"{r2.pobj!r}  [{card}]")
        if s2.ps is not s1.ps or not same_data:
            raise AssertionError(f"memo {name}: the second construction "
                                 "did not reuse the memo")
        if not same:
            raise AssertionError(f"memo {name}: the second solve differs "
                                 f"from the first in {diff}")
        if r1.status is not SolverStatus.PRIMAL_DUAL_OPTIMAL:
            raise AssertionError(f"memo {name}: {r1.status.value}")

    # ---- (b) an escalated auto solve, then f32 solves of the object
    name = "matcomp2000"
    auto, st_ref, esc_ref, _ = REFERENCE_F32[name]
    problem = INSTANCES[name]()
    f32 = dict(verbose=False, dtype="f32", max_admm_iter=F32_MEMO_ADMM)
    hold = LoradsSolver(problem, LoradsParams(**f32), device="cuda")
    pd32 = hold.pd
    t0 = time.time()
    s = LoradsSolver(problem, LoradsParams(verbose=False, dtype="f32"),
                     device="cuda")
    s._auto_dtype = auto
    res = s.solve()
    torch.cuda.synchronize()
    wall = time.time() - t0
    esc = [r for r, _ in s.escalations]
    held, rtol = f32_band(name)
    left = [str(k[0]) for k in s.ps._pd_cache]
    t0 = time.time()
    again = LoradsSolver(problem, LoradsParams(**f32), device="cuda")
    torch.cuda.synchronize()
    rebuild = time.time() - t0
    rebuilt = again.ps is s.ps and again.pd is not pd32
    fresh_s = LoradsSolver(INSTANCES[name](), LoradsParams(**f32),
                           device="cuda")
    fresh = fresh_s.solve()
    got = {}
    for label, sv in (("holder of the evicted data", hold),
                      ("constructed after", again)):
        r = sv.solve()
        got[label] = _same_solve(r, sv, fresh, fresh_s)
    torch.cuda.synchronize()
    print(f"memo {name} escalation: auto from an f32 start: "
          f"{res.status.value} escalations {esc} (lorads_tpu CPU: "
          f"{st_ref}, {esc_ref}) pObj {res.pobj!r} (held within {rtol:.0e} "
          f"of {held!r}) wall {wall:.3f} s; memo after it {left}; an f32 "
          f"construction after it rebuilt the f32 data {rebuilt} in "
          f"{rebuild:.3f} s; f32 solves (max_admm_iter {F32_MEMO_ADMM}) "
          f"bit for bit a fresh object's ({fresh.status.value} ALM "
          f"{fresh.alm_stats.inner_iter} ADMM {fresh.admm_stats.iter} pObj "
          f"{fresh.pobj!r}): {got}  [{card}]")
    if res.status.value != st_ref or esc != esc_ref:
        raise AssertionError(f"memo {name}: {res.status.value} {esc}")
    if not (math.isfinite(res.pobj)
            and abs(res.pobj - held) <= rtol * abs(held)):
        raise AssertionError(f"memo {name}: pObj {res.pobj!r}")
    if left != ["torch.float64"] or not rebuilt:
        raise AssertionError(f"memo {name}: memo {left}, rebuilt {rebuilt}")
    for label, (same, diff) in got.items():
        if not same:
            raise AssertionError(f"memo {name}: the f32 solve of the "
                                 f"{label} differs from a fresh one: {diff}")

    # ---- (c) group_buckets=False
    for name in ("multiblock22", "multiblock_lp"):
        problem = INSTANCES[name]()
        params = LoradsParams(verbose=False, **PARAMS.get(name, {}))
        grouped = LoradsSolver(problem, params, device="cuda")
        before = dict(kernels.LAUNCHES)
        by0 = dict(tdev.HOST_SYNCS_BY)
        torch.cuda.synchronize()
        t0 = time.time()
        s = LoradsSolver(problem, params, group_buckets=False,
                         device="cuda")
        res = s.solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: kernels.LAUNCHES[k] - before[k]
                    for k in kernels.LAUNCHES
                    if kernels.LAUNCHES[k] > before[k]}
        by = {k: tdev.HOST_SYNCS_BY[k] - by0[k] for k in by0
              if tdev.HOST_SYNCS_BY[k] > by0[k]}
        g = RESULTS[name]
        st_ref, ref = REFERENCE_UNGROUPED[name]
        rel = abs(res.pobj - ref) / abs(ref)
        print(f"memo {name} ungrouped: buckets {_bucket_shapes(s)} "
              f"(grouped {g['buckets']}; memo entries apart "
              f"{s.ps is not grouped.ps}) status {res.status.value} pObj "
              f"{res.pobj!r} (lorads_tpu CPU f64 ungrouped {st_ref}, "
              f"{ref!r}, rel {rel:.2e}; grouped {g['res'].status.value} "
              f"{g['res'].pobj!r}) wall {wall:.3f} s (grouped "
              f"{g['wall']:.3f} s) ALM inner {res.alm_stats.inner_iter} "
              f"ADMM {res.admm_stats.iter} CG {s.admm_cg_total} (grouped "
              f"{g['res'].alm_stats.inner_iter}, {g['res'].admm_stats.iter},"
              f" {g['cg']}); host reads {by} (grouped {g['reads']}); "
              f"launches {launches} (grouped "
              f"{ {k: n for k, n in g['launches'].items() if n} })  "
              f"[{card}]")
        if s.ps is grouped.ps or any(bk.B != 1 for bk in s.pd.buckets) \
                or len(s.pd.buckets) != len(problem.blocks):
            raise AssertionError(f"memo {name}: ungrouped buckets "
                                 f"{_bucket_shapes(s)}")
        for r in (res, g["res"]):
            if r.status is not SolverStatus.PRIMAL_DUAL_OPTIMAL:
                raise AssertionError(f"memo {name}: {r.status.value}")
        if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
            raise AssertionError(f"memo {name} ungrouped: pObj "
                                 f"{res.pobj} vs {ref}")
        for k in PATH_KERNELS[f"ungrouped {name}"]:
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"memo {name} ungrouped never "
                                     f"launched {k}")
    counts = dict(kernels.LAUNCHES)
    for k in PATH_KERNELS["memo"]:
        if counts[k] <= 0:
            raise AssertionError(f"the memo phase never launched {k}")
    print(f"memo launches: { {k: n for k, n in counts.items() if n} }, "
          f"host syncs {tdev.HOST_SYNCS}  [{card}]")
    return counts


def main_path(card):
    """Phase 4: the Max-Cut, matrix-completion, theta, multi-block / LP
    and batch paths, the CGNR refinement's path, then the probes' path
    (the probe driver).  Returns the launch counts summed over the
    paths."""
    from lorads_torch.ops import kernels

    paths = {"maxcut": ("maxcut300", "maxcut20000", "gset_torus10000"),
             "matcomp": ("matcomp500", "matcomp2000"),
             "theta": ("theta_gtoy60", "theta300", "theta800"),
             "lp": ("hand_multiblock", "hand_multiblock_gs", "multiblock22",
                    "multiblock_lp"),
             "batch": ("maxcut20000x4",)}
    total = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for path, names in paths.items():
        counts = solve_path(card, path,
                            [(name, INSTANCES[name]) for name in names])
        for k in total:
            total[k] += counts[k]
    for path in (cgnr_path, probes_path):
        counts = path(card)
        for k in total:
            total[k] += counts[k]
    return total


def _shard_bucket(problem, plan, layout, D, dtype=None):
    """The instance's one bucket (its block plan from the solver's
    presolve) rebuilt as a shard layout of D shards on the card: summed
    (sp) or rowshard (tp)."""
    import torch

    from lorads_torch.parallel.pattern_sharded import build_pattern_shards
    from lorads_torch.parallel.row_sharded import build_rowshard_bucket
    dtype = dtype or torch.float64
    if layout == "sp":
        return build_pattern_shards(plan, problem.m, D, dtype, summed=True)
    return build_rowshard_bucket(plan, problem.m, D, dtype)


def shard_kernel_checks(measure, bks, rng):
    """Each kernel the shard layouts launch, at their shapes, against its
    plain version (Measure): K2 and K3 (U is V) on maxcut20000's summed
    D = 4 shards, K3p, K3, K4 (A(.) and C + A^*(w)) and K5 on
    matcomp2000's, K4 on theta800's row slabs (A(.) over the [4, 200 *
    800] slab, W onto its slots), each at B = 4.  Library: the four
    shards as one block-diagonal CSR matrix, one call (K2, K5:
    torch.sparse.mm; K3: torch.sparse.sampled_addmm on the off pattern;
    K4: its entry lists times the flattened x, or addmm with C)."""
    import torch

    from lorads_torch.ops import kernels
    from lorads_torch.ops import pattern as pat

    dev = torch.device("cuda")

    def rand(shape, dt=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=dt)

    s, sfx = 8, "f64"
    bk = bks["maxcut20000"]
    B, n, Ks, Ko = bk.B, bk.n, bk.Ks, bk.Ko
    r = 20
    diag = torch.arange(n, device=dev).expand(B, n)
    for rr, wd in ((r, True), (1, False)):
        X = rand((B, n, rr))
        cd = bk.c_diag if wd else None
        args = (X, cd, bk.sym_cols_rs, bk.c_sym_rs, bk.bnd_sym_rows)
        C = _blockdiag_csr(bk.sym_rows_rs, bk.sym_cols_rs, bk.c_sym_rs, n,
                           (diag, diag, bk.c_diag) if wd else None)
        Xf = X.reshape(B * n, rr)
        measure("cmul_csr", f"shard sp maxcut20000 B={B} f64 r={rr}"
                + (" diag" if wd else " no-diag"), sfx,
                lambda: kernels.cmul_csr(*args),
                lambda: kernels.cmul_csr_plain(*args),
                kernels.cmul_csr_plain(X.abs(), None if cd is None
                                       else cd.abs(), bk.sym_cols_rs,
                                       bk.c_sym_rs.abs(), bk.bnd_sym_rows),
                nbytes=B * (2 * n * rr * s + Ks * (4 + s) + (n + 1) * 4
                            + (n * s if wd else 0)),
                flops=B * (2 * Ks * rr + (2 * n * rr if wd else 0)),
                library=lambda: torch.sparse.mm(C, Xf))

    def poff(bk):
        return _blockdiag_csr(bk.off_rows, bk.off_cols, torch.ones(
            bk.off_rows.shape, dtype=torch.float64, device=dev), bk.n)
    U = rand((B, n, r))
    uvt_cases(measure, kernels, f"shard sp maxcut20000 B={B} ", sfx, U,
              None, bk.off_rows, bk.off_cols,
              _tiles_kw(pat, bk, "off", kernels.uvt_split), n, Ko,
              poff(bk), B=B)

    bk = bks["matcomp2000"]
    B, n, Ks, Ko, m = bk.B, bk.n, bk.Ks, bk.Ko, bk.m_loc
    r = 20
    a = (bk.off_rows, bk.off_cols)
    R, D = rand((B, n, r)), rand((B, n, r))
    kw = _tiles_kw(pat, bk, "off", kernels.uvt_pair_split)
    measure("uvt_pair_split", f"shard sp matcomp2000 B={B} f64 r={r}", sfx,
            lambda: kernels.uvt_pair_split(R, D, *a, **kw),
            lambda: kernels.uvt_pair_split_plain(R, D, *a),
            kernels.uvt_pair_split_plain(R.abs(), D.abs(), *a),
            nbytes=B * (2 * n * r * s + 2 * Ko * 4 + 2 * (n + Ko) * s),
            flops=B * (4 * n * r + 6 * Ko * r))
    V = rand((B, n, r))
    uvt_cases(measure, kernels, f"shard sp matcomp2000 B={B} ", sfx,
              rand((B, n, r)), V, *a,
              _tiles_kw(pat, bk, "off", kernels.uvt_split), n, Ko,
              poff(bk), B=B)
    o = rand((B, Ko))
    a4 = (o, bk.a_pos_o_cs, bk.a_val_o_cs, bk.bnd_a_con_o_cs)
    N = bk.a_pos_o_cs.shape[1]
    measure("gather_segsum", f"shard sp matcomp2000 B={B} f64 A(.) "
            f"m_loc={m}", sfx,
            lambda: kernels.gather_segsum(*a4, alpha=2.0),
            lambda: kernels.gather_segsum_plain(*a4, None, 2.0),
            kernels.gather_segsum_plain(o.abs(), a4[1], a4[2].abs(), a4[3],
                                        None, 2.0),
            nbytes=B * (N * (2 * s + 4) + (m + 1) * 4 + m * s),
            flops=B * 3 * N, exact=True,
            library=_seg_library(_seg_csr(*a4[1:], Ko, alpha=2.0), o))
    w = rand((B, m))
    a4w = (w, bk.a_con_o_s, bk.a_val_o_s, bk.bnd_a_pos_o_s)
    measure("gather_segsum", f"shard sp matcomp2000 B={B} f64 A^*(w)+C "
            f"Ko={Ko}", sfx,
            lambda: kernels.gather_segsum(*a4w, base=bk.c_off),
            lambda: kernels.gather_segsum_plain(*a4w, bk.c_off),
            kernels.gather_segsum_plain(w.abs(), a4w[1], a4w[2].abs(),
                                        a4w[3], bk.c_off.abs()),
            nbytes=B * (m * s + N * (4 + s) + (Ko + 1) * 4 + 2 * Ko * s),
            flops=B * (2 * N + Ko),
            library=_seg_library(_seg_csr(*a4w[1:], m), w, bk.c_off))
    W_d, W_o = rand((B, n)), rand((B, Ko))
    a5 = (bk.sym_slot_rs, bk.sym_cols_rs, bk.bnd_sym_rows)
    slot = bk.sym_slot_rs.long()
    diag = torch.arange(n, device=dev).expand(B, n)
    Wc = _blockdiag_csr(
        bk.sym_rows_rs, bk.sym_cols_rs,
        torch.where(slot >= 0, torch.gather(W_o, 1, slot.clamp(min=0)),
                    torch.zeros((), dtype=W_o.dtype, device=dev)), n,
        (diag, diag, W_d))
    for rr in (r, 1):
        X = rand((B, n, rr))
        Xf = X.reshape(B * n, rr)
        measure("wmul_csr", f"shard sp matcomp2000 B={B} f64 r={rr}", sfx,
                lambda: kernels.wmul_csr(X, W_d, W_o, *a5,
                                         **_tiles_kw(pat, bk, "sym")),
                lambda: kernels.wmul_csr_plain(X, W_d, W_o, *a5),
                kernels.wmul_csr_plain(X.abs(), W_d.abs(), W_o.abs(), *a5),
                nbytes=B * (2 * n * rr * s + (n + Ko) * s + Ks * 8
                            + (n + 1) * 4),
                flops=B * 2 * (Ks + n) * rr,
                library=lambda: torch.sparse.mm(Wc, Xf))

    bk = bks["theta800"]
    B, n, nl, m = bk.B, bk.n, bk.n_loc, bk.m_loc
    S = nl * n
    x = rand((B, S))
    a4 = (x, bk.a_lin_cs, bk.a_val_inner_cs, bk.bnd_a_con_cs)
    N = bk.a_lin_cs.shape[1]
    measure("gather_segsum", f"shard tp theta800 B={B} f64 A(.) slab "
            f"{nl}x{n} m_loc={m}", sfx,
            lambda: kernels.gather_segsum(*a4),
            lambda: kernels.gather_segsum_plain(*a4),
            kernels.gather_segsum_plain(x.abs(), a4[1], a4[2].abs(), a4[3]),
            nbytes=B * (N * (2 * s + 4) + (m + 1) * 4 + m * s),
            flops=B * 2 * N,
            library=_seg_library(_seg_csr(*a4[1:], S), x))
    w = rand((B, m))
    base = bk.c_full.reshape(B, S)
    a4w = (w, bk.a_con2_s, bk.a_val2_s, bk.bnd_a_lin2)
    N = bk.a_con2_s.shape[1]
    measure("gather_segsum", f"shard tp theta800 B={B} f64 C+A^*(w) slab "
            f"slots {S}", sfx,
            lambda: kernels.gather_segsum(*a4w, base=base),
            lambda: kernels.gather_segsum_plain(*a4w, base),
            kernels.gather_segsum_plain(w.abs(), a4w[1], a4w[2].abs(),
                                        a4w[3], base.abs()),
            nbytes=B * (m * s + N * (4 + s) + (S + 1) * 4 + 2 * S * s),
            flops=B * (2 * N + S),
            library=_seg_library(_seg_csr(*a4w[1:], m), w, base))


_CAPTURE_PROBE = r"""
import json, sys
import torch
import torch.distributed as dist
from lorads_torch.alg import devloop
from lorads_torch.parallel import comm, distributed

distributed.init_multihost(store=dist.HashStore(), rank=0, world_size=1,
                           device="cuda")
mesh = distributed.solver_mesh(1, "cuda")
out = {}
x = torch.arange(1, 4097, dtype=torch.float64, device="cuda") / 7.0
eager = comm.all_reduce(x * 0.5 + 1.0, mesh, "probe")
torch.cuda.synchronize()
try:
    xs = x.clone()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        ys = comm.all_reduce(xs * 0.5 + 1.0, mesh, "probe")
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    out["plain graph"] = {"captured": True,
                          "bit_for_bit": bool(torch.equal(ys, eager))}
except Exception as e:
    out["plain graph"] = {"captured": False, "error": repr(e)[:400]}
torch.cuda.synchronize()


def step(inp, st, kind):
    y, k = st
    return (comm.all_reduce(y * 0.5 + inp, mesh, "probe"), k + 1)


def loop():
    return devloop.Loop(
        key=("collective probe",), step=step,
        pack=lambda inp, st: torch.stack([st[0].sum(), st[1].double()]),
        inputs=torch.ones((), dtype=torch.float64, device="cuda"),
        state=(x.clone(), torch.zeros((), dtype=torch.int64,
                                      device="cuda")),
        running=lambda inp, st: st[1] < 6)


ref = devloop.eager_chunk(loop())
try:
    st, pack = devloop.run(loop())
    torch.cuda.synchronize()
    out["while body"] = {"captured": True,
                         "bit_for_bit": bool(torch.equal(st[0], ref[0])
                                             and int(st[1]) == 6)}
except Exception as e:
    out["while body"] = {"captured": False, "error": repr(e)[:400]}
out["calls"] = dict(comm.CALLS)
print("PROBE " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def collective_capture_probe(card):
    """Whether an NCCL all_reduce (world size 1) captures into a plain
    CUDA graph and into a WHILE node's body (devloop), and whether each
    replay is bit for bit its eager run: in a child process of its own,
    so that a failed capture cannot leave this one's CUDA state broken.
    Returns the finding."""
    import subprocess
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CAPTURE_PROBE],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    found = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("PROBE ")]
    if proc.returncode != 0 and not found:
        found = {"probe": {"captured": False, "rc": proc.returncode,
                           "error": proc.stderr[-600:]}}
    else:
        found = json.loads(found[-1][6:])
    print(f"shard capture: NCCL all_reduce at world size 1 in a plain CUDA "
          f"graph {found.get('plain graph')}, in a WHILE body "
          f"{found.get('while body')} (child rc {proc.returncode})  "
          f"[{card}]")
    # the device loops keep their collectives inside their graphs
    # (devloop): both captures must hold, bit for bit
    want = {"captured": True, "bit_for_bit": True}
    for where in ("plain graph", "while body"):
        if found.get(where) != want:
            raise AssertionError(f"shard capture: {where}: "
                                 f"{found.get(where)}")
    return found


def shard_path(card, measure):
    """The shard phase.  One H100 here: no run has more than one rank.
    (1) The layouts at full width, unplaced (SHARD_LAYOUTS): the bucket
    rebuilt as a summed (sp) or rowshard (tp) layout of 4 shards, swapped
    into the solver's ProblemData, solved through LoradsSolver.solve()
    with the launch counts reset just before and read just after, each
    held to REFERENCE_POBJ within POBJ_RTOL, primal_dual_optimal, one
    read a device-loop run, its wall beside the main path's unsharded
    wall of the instance; the kernels at those shapes against their plain
    versions (shard_kernel_checks).  (2) A one-rank NCCL group
    (HashStore): sharded_solver_step, make_sharded_gradient and
    make_row_sharded_gradient on CUDA tensors against their unsharded
    oracles at tests/test_sharded.py's tolerances, shard="auto" solving
    as the unsharded path does, the comm counters of each, and whether a
    collective captures into the loops' graphs (collective_capture_probe).
    Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from lorads_torch import LoradsParams, LoradsSolver, SolverStatus
    from lorads_torch.alg import aop
    from lorads_torch.ops import kernels
    from lorads_torch.parallel import comm, distributed
    from lorads_torch.parallel.pattern_sharded import (
        build_pattern_shards, make_sharded_gradient)
    from lorads_torch.parallel.row_sharded import (
        build_row_shards, make_row_sharded_gradient)
    from lorads_torch.parallel.sharded import sharded_solver_step

    print("shard: one NVIDIA H100 here, so no run has more than one rank: "
          "the layouts run unplaced on one card, the building blocks on a "
          "one-rank NCCL group")
    total = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    bks = {}
    for name, layout, D in SHARD_LAYOUTS:
        problem = INSTANCES[name]()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        with _run_reads() as runs:
            solver = LoradsSolver(problem, LoradsParams(verbose=False),
                                  device="cuda")
            torch.cuda.synchronize()
            t1 = time.time()
            bk = _shard_bucket(problem, solver.ps.plans[0], layout, D)
            bks[name] = bk
            solver.pd = dataclasses.replace(solver.pd, buckets=(bk,))
            torch.cuda.synchronize()
            t2 = time.time()
            res = solver.solve()
        torch.cuda.synchronize()
        wall = time.time() - t2
        counts = dict(kernels.LAUNCHES)
        ref = REFERENCE_POBJ[name]
        rel = abs(res.pobj - ref) / abs(ref)
        print(f"shard {name} {layout} D={D} ({'summed' if bk.summed else f'rowshard n_loc={bk.n_loc}'}"
              f"{', diag-parent' if bk.diag_parent else ''}): status "
              f"{res.status.value} pObj {res.pobj!r} (lorads_tpu CPU f64 "
              f"{ref!r}, rel {rel:.2e}) dinf {res.dinf_l1:.3e} solve "
              f"{wall:.3f} s (unsharded solve "
              f"{SOLVE_WALLS.get(name, float('nan')):.3f} s in this "
              f"process), construction {t1 - t0:.3f} s, shard build "
              f"{t2 - t1:.3f} s, ALM inner {res.alm_stats.inner_iter} "
              f"ADMM {res.admm_stats.iter} CG {solver.admm_cg_total} "
              f"device-loop runs {runs} (one read each) launches "
              f"{ {k: v for k, v in counts.items() if v} }  [{card}]")
        if res.status is not SolverStatus.PRIMAL_DUAL_OPTIMAL:
            raise AssertionError(f"shard {name}: {res.status.value}")
        if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
            raise AssertionError(f"shard {name}: pObj {res.pobj} vs {ref}")
        for k in PATH_KERNELS[f"shard {name}"]:
            if counts[k] <= 0:
                raise AssertionError(f"shard {name} never launched {k}")
        for k in total:
            total[k] += counts[k]
    rng = np.random.default_rng(20)
    shard_kernel_checks(measure, bks, rng)

    # ---- the group at world size 1, on NCCL
    torch.cuda.synchronize()
    kernels.reset_launches()
    distributed.init_multihost(store=dist.HashStore(), rank=0,
                               world_size=1, device="cuda")
    try:
        mesh = distributed.solver_mesh(1, "cuda")
        comm.reset()
        s = LoradsSolver(_gen().random_multiblock(n_blocks=8, dim=12, m=10,
                                                  seed=3),
                         LoradsParams(verbose=False), device="cuda")
        got = sharded_solver_step(mesh, s.pd, s.U, s.V, s.dual, 1.0)
        ref = sharded_solver_step(None, s.pd, s.U, s.V, s.dual, 1.0)
        errs = []
        for g, r_, (rt, at) in zip(got, ref, ((1e-7, 1e-8), (1e-7, 1e-8),
                                              (1e-9, 1e-10), (1e-9, 1e-10))):
            torch.testing.assert_close(g, r_, rtol=rt, atol=at)
            errs.append(float((g - r_).abs().max()))
        print(f"shard nccl sharded_solver_step (random_multiblock 8 x 12): "
              f"max |diff| U {errs[0]:.3e} V {errs[1]:.3e} total "
              f"{errs[2]:.3e} grad {errs[3]:.3e} against the unplaced run; "
              f"comm {comm.counts()}  [{card}]")
        for name, kind in (("maxcut20000", "sp"), ("theta800", "tp")):
            comm.reset()
            s = LoradsSolver(INSTANCES[name](), LoradsParams(verbose=False),
                             device="cuda")
            plan = s.ps.plans[0]
            dual = torch.as_tensor(rng.standard_normal(s.m), device="cuda")
            rho = 1.7
            if kind == "sp":
                data = build_pattern_shards(plan, s.m, 4, torch.float64,
                                            device="cuda")
                step = make_sharded_gradient(mesh, data, s.pd.rhs,
                                             s.pd.c_nrm_inf)
            else:
                data = build_row_shards(plan, s.m, 4, torch.float64,
                                        device="cuda")
                step = make_row_sharded_gradient(mesh, data,
                                                 s.pd.c_nrm_inf)
            tot, grad, cert = step(s.R.cones[0][0], s.pd.rhs, dual, rho)
            _, tot0 = aop.auv(s.pd, s.R, s.R)
            g0 = aop.grad(s.pd, s.R, rho * (tot0 - s.pd.rhs) - dual)
            c0 = aop.cert_value(s.pd, g0)
            torch.testing.assert_close(tot, tot0, rtol=1e-9, atol=1e-10)
            torch.testing.assert_close(grad, g0.cones[0][0], rtol=1e-9,
                                       atol=1e-10)
            if abs(float(cert) - float(c0)) > 1e-9 * abs(float(c0)):
                raise AssertionError(f"{kind} gradient: cert {cert} {c0}")
            print(f"shard nccl {'make_sharded_gradient' if kind == 'sp' else 'make_row_sharded_gradient'} "
                  f"({name}, D=4): max |diff| total "
                  f"{float((tot - tot0).abs().max()):.3e} grad "
                  f"{float((grad - g0.cones[0][0]).abs().max()):.3e} cert "
                  f"{abs(float(cert) - float(c0)):.3e} against the "
                  f"unsharded gradient; comm {comm.counts()}  [{card}]")
        comm.reset()
        problem = INSTANCES["maxcut300"]()
        base = LoradsSolver(problem, LoradsParams(verbose=False),
                            device="cuda").solve()
        s = LoradsSolver(problem, LoradsParams(verbose=False, shard="auto"),
                         device="cuda")
        res = s.solve()
        same = (res.pobj == base.pobj and torch.equal(res.R.cones[0],
                                                      base.R.cones[0]))
        print(f"shard nccl shard=auto on 1 rank: mesh {s.mesh}, "
              f"note {s.shard_note!r}, pObj {res.pobj!r} (unsharded "
              f"{base.pobj!r}, bit for bit {same}); comm {comm.counts()}  "
              f"[{card}]")
        if s.mesh is not None or not same or comm.counts():
            raise AssertionError("shard=auto on one rank is not the "
                                 "unsharded solve")
    finally:
        dist.destroy_process_group()
    counts = dict(kernels.LAUNCHES)
    for k in PATH_KERNELS["shard blocks"]:
        if counts[k] <= 0:
            raise AssertionError(f"the shard building blocks never "
                                 f"launched {k}")
    for k in total:
        total[k] += counts[k]
    print(f"shard launches (the phase's solves and building blocks): "
          f"{ {k: v for k, v in total.items() if v} }  [{card}]")
    collective_capture_probe(card)
    return total


# the port's kernel functions, as a device trace names them
PORT_KERNEL_RE = (r"\b(adj_a_dense|cmul_pairs|gather_cols|gather_cols_staged|"
                  r"gather_flat|gather_rows|loop_cond|lp_gs|onehot_gather|"
                  r"onehot_scatter|scatter_add|sddmm_l2|sddmm_off|"
                  r"sddmm_staged|segment_sum|segsum|sym_eig|wmul_combine|"
                  r"wmul_rows|wmul_tiled|zero)_kernel\b")

# the kernels of each group of the port's wrappers as a trace names them:
# a launch of a group's wrapper is at least one of the group's kernel
# events (K2 and K5 at r = 1 take K4's segsum kernel; K3, K3p and K6 share
# the SDDMM kernels)
TRACE_GROUPS = {
    "segsum": (("cmul_csr", "gather_segsum", "wmul_csr"),
               r"\b(cmul_pairs|segsum|wmul_rows|wmul_tiled)_kernel\b"),
    "sddmm": (("uvt_split", "uvt_pair_split", "adj_a_offdiag"),
              r"\bsddmm_(off|l2|staged)_kernel\b"),
    "adj_a_dense": (("adj_a_dense",), r"\badj_a_dense_kernel\b"),
    "lp_gs": (("lp_gs_sweep",), r"\blp_gs_kernel\b"),
    "segment_sum": (("segment_sum",), r"\bsegment_sum_kernel\b"),
    "sym_eig": (("sym_eig_small",), r"\bsym_eig_kernel\b"),
    "loop_cond": (("loop_cond",), r"\bloop_cond_kernel\b"),
}


@contextlib.contextmanager
def _phase_launches(attr):
    """{kernel: launches} made inside LoradsSolver.``attr`` (a phase)
    while the block runs, summed over its calls."""
    from lorads_torch.alg.solver import LoradsSolver
    from lorads_torch.ops import kernels

    fn, out = getattr(LoradsSolver, attr), {}

    def counted(self, *a, **k):
        before = dict(kernels.LAUNCHES)
        try:
            return fn(self, *a, **k)
        finally:
            for name, n in kernels.LAUNCHES.items():
                out[name] = out.get(name, 0) + n - before[name]
    setattr(LoradsSolver, attr, counted)
    try:
        yield out
    finally:
        setattr(LoradsSolver, attr, fn)


def _trace_holds(logdir, launches, what):
    """{group: (kernel events in the trace in ``logdir``, the group's
    ``launches``)} for each group a phase launched; raises unless some
    group was launched, every such group's events reach its launches and
    every kernel launch in the trace has its kernel event."""
    import glob
    import re

    from lorads_torch.utils.profiling import lost_kernels

    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    lost = lost_kernels(events)
    if lost:
        raise AssertionError(f"{what}: {len(lost)} kernel launches in the "
                             f"trace have no kernel event: {lost[:3]}")
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    out = {}
    for group, (wrappers, rx) in TRACE_GROUPS.items():
        n = sum(launches.get(w, 0) for w in wrappers)
        if n:
            pat = re.compile(rx)
            out[group] = (sum(1 for x in names if pat.search(x)), n)
    if not out or any(ev < n for ev, n in out.values()):
        raise AssertionError(f"{what}: the trace's kernel events against "
                             f"the phase's launches {out}")
    return out


def _solve_timed(problem, device="cuda", load=None, warm=None, **params):
    """(solver, result, wall s) of one solve through LoradsSolver; ``load``
    a checkpoint to resume from, ``warm`` a solution file to warm-start
    from."""
    import numpy as np
    import torch

    from lorads_torch import LoradsParams, LoradsSolver

    torch.cuda.synchronize()
    t0 = time.time()
    solver = LoradsSolver(problem, LoradsParams(verbose=False, **params),
                          device=device)
    if load is not None:
        solver.load(load)
    if warm is not None:
        with np.load(warm) as z:
            fs = [z[f"f{i}"] for i in range(problem.n_sdp_blocks)]
            lp = z["lp"] if "lp" in z.files else None
            solver.set_initial_factors(fs, lp, dual=z["y"])
    res = solver.solve()
    torch.cuda.synchronize()
    return solver, res, time.time() - t0


def _certified(name, res, ref):
    rel = abs(res.pobj - ref) / abs(ref)
    if res.status.value != "primal_dual_optimal":
        raise AssertionError(f"{name}: status {res.status.value}")
    if not (math.isfinite(res.pobj) and rel <= POBJ_RTOL):
        raise AssertionError(f"{name}: pObj {res.pobj!r} vs {ref!r}")
    return rel


def _fix_ini_lines(fn):
    """The FIX_INI trace lines fn() prints, as (key, value) pairs."""
    import contextlib
    import io
    import re

    from lorads_torch.alg import alm

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        alm.TRACE_FIX_INI = False
    lines = re.findall(r"^(nrm2U|tau): (\S+)$", buf.getvalue(), re.M)
    return [(k, float(v)) for k, v in lines], out


def _fix_ini_outer(name, device):
    """The FIX_INI lines of the first ALM outer iteration of ``name``
    from the all-ones start, on ``device``."""
    from lorads_torch import LoradsParams, LoradsSolver
    from lorads_torch.alg import alm

    def run():
        s = LoradsSolver(INSTANCES[name](), LoradsParams(
            verbose=False, fix_init_point=True), device=device)
        return s.alm_phase(alm.ALMStats(rho=s.ps.rho0), time.time(),
                           max_alm_iter=1)
    return _fix_ini_lines(run)


def _trace_counts(logdir):
    """(kernel events, the port's kernel events, cudaGraphLaunch calls,
    kernel events that name a graph, the file's bytes) of the trace in
    ``logdir``."""
    import glob
    import re

    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"device_trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    port = re.compile(PORT_KERNEL_RE)
    kern = [e for e in events if e.get("cat") == "kernel"]
    mine = sum(1 for e in kern if port.search(e.get("name", "")))
    graph_calls = sum(1 for e in events
                      if e.get("name", "").startswith("cudaGraphLaunch"))
    in_graph = sum(1 for e in kern
                   if any("graph" in k.lower() for k in e.get("args", {})))
    return len(kern), mine, graph_calls, in_graph, os.path.getsize(files[0])


def extras_path(card):
    """Phase 5: the solver's extras on the card, with the launch counts
    reset just before and read just after: checkpoint and resume, the
    warm start from a solution file, a device trace, the FIX_INI trace,
    the DUAL_U_V variant (K8c with s) and the CLI's sequence of those
    flags.  Returns the launch counts."""
    import contextlib
    import io
    import tempfile

    import torch

    from lorads_torch import device as tdev
    from lorads_torch.io import sdpa
    from lorads_torch.ops import kernels
    from lorads_torch.utils.profiling import device_trace

    mc = INSTANCES["maxcut20000"]()
    ref = REFERENCE_POBJ["maxcut20000"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    tdev.reset_host_syncs()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- checkpoint at both phase boundaries, then resume
        ck = os.path.join(tmp, "maxcut20000.ckpt")
        saved = []
        from lorads_torch.alg.solver import LoradsSolver
        save = LoradsSolver.save

        def counted_save(self, path, *a, **k):
            saved.append(a[2] if len(a) > 2 else k.get("phase"))
            other = tdev.HOST_SYNCS_BY["other"]
            save(self, path, *a, **k)
            saved.append(tdev.HOST_SYNCS_BY["other"] - other)

        LoradsSolver.save = counted_save
        try:
            s1, r1, w1 = _solve_timed(mc, checkpoint_path=ck)
        finally:
            LoradsSolver.save = save
        rel1 = _certified("maxcut20000 (checkpointed)", r1, ref)
        with open(ck + ".meta.json") as f:
            meta = json.load(f)
        if saved[0::2] != ["post_alm", "post_admm"] or \
                meta["phase"] != "post_admm":
            raise AssertionError(f"checkpoint saves {saved}, meta {meta}")
        s2, r2, w2 = _solve_timed(mc, load=ck)
        rel2 = _certified("maxcut20000 (resumed)", r2, r1.pobj)
        print(f"extras checkpoint: maxcut20000 saved at {saved[0::2]} "
              f"({saved[1::2]} host reads each, label other), "
              f"{os.path.getsize(ck)} B; cold solve with checkpoints wall "
              f"{w1:.3f} s ALM inner {r1.alm_stats.inner_iter} pObj "
              f"{r1.pobj!r} (rel {rel1:.2e}); resumed wall {w2:.3f} s "
              f"ALM inner {r2.alm_stats.inner_iter} pObj {r2.pobj!r} "
              f"(rel to the cold solve {rel2:.2e})  [{card}]")
        # ---- warm start from the solution file
        sol = os.path.join(tmp, "maxcut20000_sol.npz")
        s1.save_solution(sol)
        s3, r3, w3 = _solve_timed(mc, warm=sol)
        rel3 = _certified("maxcut20000 (warm start)", r3, r1.pobj)
        print(f"extras warm start: maxcut20000 from {os.path.getsize(sol)} "
              f"B wall {w3:.3f} s ALM inner {r3.alm_stats.inner_iter} "
              f"pObj {r3.pobj!r} (rel to the cold solve {rel3:.2e})  "
              f"[{card}]")
        # ---- a device trace around one solve: its loops run eagerly,
        # so the trace holds the ALM's kernels (K2, K3)
        tdir = os.path.join(tmp, "trace")
        t0 = time.time()
        with device_trace(tdir, "cuda"), \
                _phase_launches("alm_phase") as alm_l, \
                _phase_launches("_dual_infeas_pass") as cert_l:
            _, r4, w4 = _solve_timed(mc)
        w4x = time.time() - t0
        _certified("maxcut20000 (traced)", r4, ref)
        n_kern, n_mine, n_graph, _, size = _trace_counts(tdir)
        held = _trace_holds(tdir, {k: alm_l[k] + cert_l.get(k, 0)
                                   for k in alm_l},
                            "maxcut20000's ALM and certificates")
        print(f"extras device_trace: maxcut20000 solve wall {w4:.3f} s "
              f"({w4x:.3f} s with the trace's export), trace {size} B: "
              f"{n_kern} kernel events, {n_mine} of them the port's "
              f"kernels, {n_graph} cudaGraphLaunch calls; the ALM "
              f"phase's K2 {alm_l['cmul_csr']} and K3 "
              f"{alm_l['uvt_split']} launches, the certificates' K2 "
              f"{cert_l['cmul_csr']} and K9 {cert_l['sym_eig_small']} "
              f"(their Lanczos loops eager under the trace), kernel "
              f"events against the launches by group {held}, every "
              f"launch in the trace with its kernel event  [{card}]")
        if not (alm_l["cmul_csr"] > 0 and alm_l["uvt_split"] > 0):
            raise AssertionError(f"the traced ALM launched {alm_l}")
        if not (cert_l["cmul_csr"] > 0 and cert_l["sym_eig_small"] > 0):
            raise AssertionError(f"the traced certificates launched "
                                 f"{cert_l}")
        # ---- a device trace around a solve that reaches the ADMM phase:
        # the trace holds the ADMM chunks' kernels
        tdir = os.path.join(tmp, "trace_admm")
        with device_trace(tdir, "cuda"), \
                _phase_launches("admm_phase") as admm_l:
            _, r6, w6 = _solve_timed(INSTANCES["hand_multiblock"]())
        _certified("hand_multiblock (traced)", r6,
                   REFERENCE_POBJ["hand_multiblock"])
        n_kern, n_mine, _, _, size = _trace_counts(tdir)
        held = _trace_holds(tdir, admm_l, "hand_multiblock's ADMM")
        print(f"extras device_trace: hand_multiblock solve wall {w6:.3f} s, "
              f"ADMM {r6.admm_stats.iter} iterations, trace {size} B: "
              f"{n_kern} kernel events, {n_mine} of them the port's; the "
              f"ADMM phase's kernel events against its launches by group "
              f"{held}, every launch in the trace with its kernel event  "
              f"[{card}]")
        if r6.admm_stats.iter <= 0:
            raise AssertionError("the traced hand_multiblock solve ran no "
                                 "ADMM iteration")
    # ---- FIX_INI_POINT
    trace, (_, r5, w5) = _fix_ini_lines(lambda: _solve_timed(
        mc, fix_init_point=True, max_alm_iter=2, max_admm_iter=5))
    keys = [k for k, _ in trace]
    n_u, n_t = keys.count("nrm2U"), keys.count("tau")
    print(f"extras fix_init_point: maxcut20000 max_alm_iter=2: "
          f"{len(trace)} trace lines ({n_u} nrm2U, {n_t} tau) for "
          f"{r5.alm_stats.inner_iter} inner steps; status "
          f"{r5.status.value} wall {w5:.3f} s  [{card}]")
    if (n_u != r5.alm_stats.inner_iter or n_u == 0 or n_t > n_u
            or not all(math.isfinite(v) for _, v in trace)):
        raise AssertionError("fix_init_point: the trace does not count "
                             "the inner steps")
    # the card against the CPU: maxcut300's first step (from there on its
    # gradient is rounding noise: the all-ones start keeps R's columns
    # equal and lands on x = 1/sqrt(r)), matcomp500's first 10 values
    for name, n in (("maxcut300", 2), ("matcomp500", 10)):
        got, _ = _fix_ini_outer(name, "cuda")
        ref_lines, _ = _fix_ini_outer(name, "cpu")
        worst = max(abs(a - b) / abs(b) for (_, a), (_, b) in
                    zip(got[:n], ref_lines[:n]))
        print(f"extras fix_init_point: {name} ALM outer 1 ({len(got)} "
              f"lines on the card, {len(ref_lines)} on the CPU): first {n}"
              f" values {[v for _, v in got[:n]]}, worst relative "
              f"difference to the CPU run {worst:.2e}")
        if ([k for k, _ in got[:n]] != [k for k, _ in ref_lines[:n]]
                or len(got) < n or worst > 1e-9):
            raise AssertionError(f"fix_init_point: {name}'s trace on the "
                                 "card parts from the CPU run")
    # ---- DUAL_U_V: K8c with s (multiblock_lp), the LP Jacobi update
    # (hand_multiblock)
    for name, (st_ref, p_ref) in REFERENCE_DUAL_UV.items():
        s0 = kernels.WITH_S_LAUNCHES["lp_gs_sweep"]
        solver, res, wall = _solve_timed(INSTANCES[name](), dual_uv=True,
                                         **PARAMS.get(name, {}))
        rel = abs(res.pobj - p_ref) / abs(p_ref)
        with_s = kernels.WITH_S_LAUNCHES["lp_gs_sweep"] - s0
        print(f"extras dual_uv: {name} status {res.status.value} pObj "
              f"{res.pobj!r} (lorads_tpu CPU f64 {p_ref!r}, rel {rel:.2e})"
              f" ALM inner {res.alm_stats.inner_iter} ADMM "
              f"{res.admm_stats.iter} CG {solver.admm_cg_total} wall "
              f"{wall:.3f} s; K8c launches with s {with_s}  [{card}]")
        if res.status.value != st_ref or rel > POBJ_RTOL:
            raise AssertionError(f"dual_uv {name}: {res.status.value} "
                                 f"{res.pobj!r}")
        if (with_s > 0) != (name == "multiblock_lp"):
            raise AssertionError(f"dual_uv {name}: K8c with s launched "
                                 f"{with_s} times")
    # ---- the CLI, in this process
    from lorads_torch.__main__ import main as cli
    fx = os.path.join(FIX, "maxcut2000.dat-s")
    with tempfile.TemporaryDirectory() as tmp:
        ck, sol = os.path.join(tmp, "ck"), os.path.join(tmp, "sol.npz")
        bad = os.path.join(tmp, "bad.npz")
        with open(bad, "wb") as f:
            f.write(b"not an npz")
        runs = (("--dualUV 1 --checkpoint --solOut",
                 ["--dualUV", "1", "--checkpoint", ck, "--solOut", sol], 0,
                 f"solution written to {sol}"),
                ("--resume", ["--resume", ck], 0,
                 f"resumed from {ck} (phase post_admm)"),
                ("--warmStart", ["--warmStart", sol], 0,
                 f"warm started from {sol}"),
                ("--warmStart (corrupt file)", ["--warmStart", bad], 2,
                 "could not warm-start"),
                ("--traceDir", ["--traceDir", os.path.join(tmp, "tr")], 0,
                 "primal_dual_optimal"))
        for label, flags, rc_ref, line in runs:
            out, err = io.StringIO(), io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli([fx, "--quiet"] + flags)
            text = out.getvalue() + err.getvalue()
            ok = rc == rc_ref and line in text and (
                rc != 0 or "primal_dual_optimal" in text)
            print(f"extras cli {label}: exit {rc} in "
                  f"{time.time() - t0:.3f} s, {sdpa.LAST_READER} SDPA "
                  f"reader, '{line}' {'found' if line in text else 'MISSING'}"
                  f"  [{card}]")
            if not ok:
                raise AssertionError(f"cli {label}: exit {rc}\n{text}")
        if not os.listdir(os.path.join(tmp, "tr")):
            raise AssertionError("cli --traceDir wrote no trace")
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    print(f"main path extras: kernel launches {counts} (lp_gs_sweep with "
          f"s: {kernels.WITH_S_LAUNCHES['lp_gs_sweep']}), host syncs "
          f"{tdev.HOST_SYNCS} {dict(tdev.HOST_SYNCS_BY)}")
    for k in PATH_KERNELS["extras"]:
        if counts[k] <= 0:
            raise AssertionError(f"the extras path never launched {k}")
    return counts


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-of", metavar="DIR",
                    help="only phases 1-3 (build, kernel checks and "
                    "times), on the lorads_torch of the checkout at DIR: "
                    "two checkouts' kernels timed alike on one card")
    ap.add_argument("--eig-inputs", metavar="FILE",
                    help="a whole run writes the K9 inputs of the main "
                    "paths there; a --kernels-of run times K9 on them")
    args = ap.parse_args(argv)
    global KERNELS_OF
    if args.kernels_of:
        KERNELS_OF = args.kernels_of
        sys.path.insert(0, os.path.abspath(args.kernels_of))
    try:
        import torch

        import lorads_torch  # noqa: F401
        from lorads_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              "root of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 3

    card = timing().card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    t0 = time.time()
    lib = build.build(verbose=True)
    build.load()
    print(f"build: {lib.name} in {time.time() - t0:.2f} s "
          f"(nvcc {build.BUILD_SECONDS:.2f} s)")

    measure = kernel_checks(card)
    results = measure.results
    if args.kernels_of:
        record = {}
        if args.eig_inputs:
            record = {k: v.cuda() for k, v in
                      torch.load(args.eig_inputs).items()}
        sym_eig_checks(measure, record)
        results["loop_cond"] = [loop_cond_checks(card, floor=False)]
        print(f"card: {card}")
        print(json.dumps({"kernels_of": os.path.abspath(args.kernels_of),
                          "cases": results}))
        return 0
    devloop_checks(card)
    alm_outer_checks(card)
    admm_chunk_checks(card)
    results["loop_cond"] = [loop_cond_checks(card)]
    loop_cond_site_checks(card)
    record = {}
    cert_checks(card, record)
    repair_checks(card, record)
    if args.eig_inputs:
        torch.save({k: v.cpu() for k, v in record.items()}, args.eig_inputs)
    sym_eig_checks(measure, record)
    solve_ex_capture(card)
    counts = main_path(card)
    for k, n in extras_path(card).items():
        counts[k] += n
    for k, n in f32_path(card).items():
        counts[k] += n
    for k, n in shard_path(card, measure).items():
        counts[k] += n
    for k, n in memo_path(card).items():
        counts[k] += n

    src = {"segment_sum": ("lorads_torch/csrc/segment_sum.cu",
                           "lorads_tpu/ops/pattern.py:138"),
           "cmul_csr": ("lorads_torch/csrc/cmul.cu",
                        "lorads_tpu/ops/pattern.py:1509"),
           "uvt_split": ("lorads_torch/csrc/uvt.cu",
                         "lorads_tpu/ops/pattern.py:1056"),
           "uvt_pair_split": ("lorads_torch/csrc/uvt_pair.cu",
                              "lorads_tpu/ops/pattern.py:1100"),
           "gather_segsum": ("lorads_torch/csrc/gather_segsum.cu",
                             "lorads_tpu/ops/pattern.py:1140"),
           "wmul_csr": ("lorads_torch/csrc/wmul.cu",
                        "lorads_tpu/ops/pattern.py:1312"),
           "adj_a_offdiag": ("lorads_torch/csrc/adj_a.cu",
                             "lorads_tpu/ops/pattern.py:1476"),
           "adj_a_dense": ("lorads_torch/csrc/adj_a_dense.cu",
                           "lorads_tpu/ops/pattern.py:1458"),
           "lp_gs_sweep": ("lorads_torch/csrc/lp_gs.cu",
                           "lorads_tpu/alg/admm.py:238"),
           "sym_eig_small": ("lorads_torch/csrc/sym_eig.cu",
                             "lorads_tpu/alg/lanczos.py:117"),
           "onehot_scatter": ("lorads_torch/csrc/onehot_mma.cu",
                              "tools/probes/onehot.py:190"),
           "onehot_gather": ("lorads_torch/csrc/onehot_mma.cu",
                             "tools/probes/onehot.py:238"),
           "row_gather": ("lorads_torch/csrc/row_gather.cu",
                          "tools/probes/microbench_pallas_gather.py:61"),
           "scatter_add": ("lorads_torch/csrc/scatter_add.cu",
                           "tools/probes/microbench_gather9.py:146"),
           "loop_cond": ("lorads_torch/csrc/graph_cond.cu",
                         "lorads_tpu/alg/admm.py:658")}
    summary = []
    for name, (path, replaces) in src.items():
        first = results[name][0]
        summary.append({"name": name, "route": "cuda", "source": path,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": first["max_abs_err"],
                        "ms": first["ms"], "plain_ms": first["plain_ms"],
                        "bound_ms": first["bound_ms"],
                        "bound_by": first["bound_by"],
                        "library_ms": first["library_ms"]})
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
