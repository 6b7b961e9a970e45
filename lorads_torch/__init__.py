"""lorads_torch -- the PyTorch / CUDA port of lorads_tpu.

A low-rank SDP solver for

    min <C, X>  s.t.  A(X) = b,  X >= 0 (PSD),

with X factored as R R^T (Burer-Monteiro): Phase I is an augmented
Lagrangian method with L-BFGS and an exact quartic line search, Phase II
an ADMM splitting X = U V^T, and a Lanczos (or exact eigh) certificate
measures dual infeasibility.

The port runs one split, sparse block whose constraint slots are the
global ones, at f64, on an NVIDIA GPU: the Max-Cut path (diag-identity
constraints, closed-form ADMM) and the general sparse path of matrix
completion (constraints on any pattern slots, ADMM with matrix-free CG).
Hand-written CUDA kernels in ``csrc/``, built with nvcc on first use,
carry the sparse work (ops/kernels.py lists them).  Other configurations
raise NotImplementedError.  Imports torch, never jax.
"""

from lorads_torch.alg.solver import LoradsSolver, SolveResult, solve
from lorads_torch.config import LoradsParams, SolverStatus
from lorads_torch.core.problem import SDPProblem
from lorads_torch.io.sdpa import read_sdpa, write_sdpa

__version__ = "0.1.0"

__all__ = [
    "LoradsParams",
    "SolverStatus",
    "SDPProblem",
    "read_sdpa",
    "write_sdpa",
    "LoradsSolver",
    "SolveResult",
    "solve",
]
