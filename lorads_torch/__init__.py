"""lorads_torch -- the PyTorch / CUDA port of lorads_tpu (Max-Cut slice).

A low-rank SDP solver for

    min <C, X>  s.t.  A(X) = b,  X >= 0 (PSD),

with X factored as R R^T (Burer-Monteiro): Phase I is an augmented
Lagrangian method with L-BFGS and an exact quartic line search, Phase II
an ADMM splitting X = U V^T, and a Lanczos (or exact eigh) certificate
measures dual infeasibility.

This slice runs the Max-Cut path of lorads_tpu on an NVIDIA GPU: one
split, diag-identity sparse block at f64, with hand-written CUDA kernels
for C @ X (``cmul``), sym(U V^T) on the pattern (``uvt``) and the sorted
segment sum, built from ``csrc/`` with nvcc on first use.  Other
configurations raise NotImplementedError.  Imports torch, never jax.
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
