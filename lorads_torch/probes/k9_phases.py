"""Where K9's time goes, on one NVIDIA GPU (no profiler counter reads it).

    python -m lorads_torch.probes.k9_phases

Builds instrumented copies of ``lorads_torch/csrc/sym_eig.cu`` (the
library's own build is untouched): thread 0 reads ``clock64`` at fixed
points of the source, found by their text (the script fails if the
source no longer has them), so each call reports the cycles of the
load (the lower triangle and the coupled indices), the setup (the
compact block, V = I, round 0's rotations), each sweep's rounds (from
before its first round to after its last barrier), the sweeps' tests
and the output.  Three more copies run a fixed 6 sweeps: as is,
with warp 0 alone (the rotations a round ahead, the chain each round
waits on) and with the updating warps alone (A's blocks and V's
chunks); their cycles a round split the round between the two.  The
inputs are K9's main-path shapes made from a seed: a symmetric f32
[1, 36, 36] (a Ritz problem's size), a symmetric f64 [1, 48, 48] (a
projected slack at full width) and the same masked to real width 24 as
alg/spectral_repair.py masks it.  The copy as is is checked against
torch.linalg.eigh within 8 n eps ||A||; the fixed-sweep copies, stopped
early or wrong by design, are not.  Prints one line a copy and case,
the card's name and power limit, and last a JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from lorads_torch import timing
from lorads_torch.ops import build

SOURCE = build.CSRC / "sym_eig.cu"

# (anchor, text inserted after it) of the instrumented copy
_STAMPS = [
    ("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n",
     "  const long long t0_ = clock64();\n"
     "  long long t1_ = 0, t2_ = 0, t3_ = 0, rounds_ = 0, nr_ = 0;\n"),
    ("  __syncthreads();\n  const int m = *count;\n", "  t1_ = clock64();\n"),
    ("  T* cur = a0;\n", "  t2_ = clock64();\n"),
    ("      cur = nxt;\n      nxt = tmp;\n    }\n",
     "    rounds_ += clock64() - r0_;\n    nr_ += M - 1;\n"),
]
# (anchor, text inserted before it): a sweep's rounds start
_ROUNDS = ("    for (int r = 0; r < M - 1; ++r, ++g) {\n",
           "    const long long r0_ = clock64();\n")
_END = ("  if (sweeps_out != nullptr && threadIdx.x == 0)\n",
        "  __syncthreads();\n"
        "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
        "    lt_k9_probe[0] = t1_ - t0_;\n"
        "    lt_k9_probe[1] = t2_ - t1_;\n"
        "    lt_k9_probe[2] = rounds_;\n"
        "    lt_k9_probe[3] = nr_;\n"
        "    lt_k9_probe[4] = t3_ - t2_ - rounds_;\n"
        "    lt_k9_probe[5] = clock64() - t3_;\n"
        "  }\n")
_SWEEPS_END = ("  // the eigenvalues: the block's diagonal",
               "  t3_ = clock64();\n")
_STOP = "    if (!(off > stop)) break;  // converged (NaN runs to the cap)\n"
_WARP0 = "      if (warp == 0) {\n        // the next round's rotations"
_UPDATERS = "      } else {\n        // A's blocks"
_BARRIER = "      __syncthreads();\n      T* tmp = cur;"


def _edit(src: str, anchor: str, text: str, before=False) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"k9_phases: {SOURCE.name} no longer has the "
                           f"point {anchor.strip()[:60]!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def variants() -> dict:
    """The instrumented copies' sources: ``as is`` (K9's own stop rule)
    and, at 6 sweeps, ``6 sweeps``, ``warp 0 alone``, ``updaters
    alone``."""
    src = SOURCE.read_text()
    src = _edit(src, "namespace {\n",
                "__device__ unsigned long long lt_k9_probe[8];\n\n",
                before=True)
    for anchor, text in _STAMPS:
        src = _edit(src, anchor, text)
    src = _edit(src, _ROUNDS[0], _ROUNDS[1], before=True)
    src = _edit(src, _SWEEPS_END[0], _SWEEPS_END[1], before=True)
    src = _edit(src, _END[0], _END[1], before=True)
    src += ('\nextern "C" int lt_k9_probe_read(void* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, lt_k9_probe, '
            'sizeof(lt_k9_probe));\n}\n')
    fixed = _edit(src, _STOP, "    if (sweep >= 6) break;\n").replace(
        _STOP, "")
    for mark in (_WARP0, _UPDATERS, _BARRIER):
        if fixed.count(mark) != 1:
            raise RuntimeError(f"k9_phases: no point {mark.strip()[:40]!r}")
    w0, up, bar = (fixed.index(m) for m in (_WARP0, _UPDATERS, _BARRIER))
    warp0 = fixed[:up] + "      }\n" + fixed[bar:]
    updaters = (fixed[:w0] + "      if (warp != 0) {\n"
                + fixed[up + len("      } else {\n"):])
    return {"as is": src, "6 sweeps": fixed, "warp 0 alone": warp0,
            "updaters alone": updaters}


def _build(name: str, text: str) -> ctypes.CDLL:
    out = build.BUILD_DIR / "k9_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name.replace(' ', '_')}.cu"
    cu.write_text(text)
    lib = cu.with_suffix(".so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
                    str(build.CSRC), "-o", str(lib), str(cu)], check=True,
                   capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.lt_sym_eig.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dll.lt_sym_eig.restype = ctypes.c_int
    dll.lt_k9_probe_read.argtypes = [ctypes.c_void_p]
    dll.lt_k9_probe_read.restype = ctypes.c_int
    return dll


def cases() -> dict:
    rng = np.random.default_rng(9)

    def sym(n):
        x = rng.standard_normal((1, n, n))
        return x + np.swapaxes(x, 1, 2)

    m = (np.arange(48) < 24).astype(float)
    m2 = m[:, None] * m[None, :]
    masked = sym(48) * m2 + 2.0 * (1.0 - m2) * np.eye(48)
    return {"f32 [1,36,36]": torch.as_tensor(sym(36), dtype=torch.float32),
            "f64 [1,48,48]": torch.as_tensor(sym(48), dtype=torch.float64),
            "f64 [1,48,48] width 24": torch.as_tensor(masked)}


def _run(dll, A):
    B, n, _ = A.shape
    w = torch.empty((B, n), dtype=A.dtype, device=A.device)
    V = torch.empty_like(A)
    sw = torch.zeros(B, dtype=torch.int32, device=A.device)
    rc = dll.lt_sym_eig(int(A.dtype == torch.float64), A.data_ptr(),
                        w.data_ptr(), V.data_ptr(), sw.data_ptr(), B, n,
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"k9_phases: launch failed ({rc})")
    return w, V, sw


def main() -> int:
    if not torch.cuda.is_available():
        print("k9_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    card = timing.card_line()
    libs = {name: _build(name, text) for name, text in variants().items()}
    out = []
    for label, A in cases().items():
        A = A.cuda()
        n = A.shape[1]
        ref = torch.linalg.eigh(A)[0].double()
        tol = 8 * n * torch.finfo(A.dtype).eps * float(ref.abs().max())
        for name, dll in libs.items():
            _run(dll, A)                      # warm
            w, _, sw = _run(dll, A)
            torch.cuda.synchronize()
            ok = None
            if name == "as is":
                ok = float((w.double() - ref).abs().max()) <= tol
                if not ok:
                    raise AssertionError(f"k9_phases: {name} on {label} "
                                         f"disagrees with eigh")
            buf = (ctypes.c_ulonglong * 8)()
            if dll.lt_k9_probe_read(ctypes.byref(buf)) != 0:
                raise RuntimeError("k9_phases: reading the stamps failed")
            load, setup, rounds, nr, tests, end = list(buf)[:6]
            row = dict(case=label, copy=name, sweeps=int(sw[0]),
                       load=load, setup=setup, rounds=rounds, n_rounds=nr,
                       per_round=rounds / nr if nr else None, tests=tests,
                       output=end, eigenvalues_ok=ok)
            out.append(row)
            per = "-" if not nr else f"{rounds / nr:.0f}"
            print(f"k9 {label} [{name}]: sweeps {row['sweeps']}, cycles: "
                  f"load {load}, setup {setup}, {nr} rounds {rounds} "
                  f"({per} a round), tests {tests}, output {end}  [{card}]")
    print(f"card: {card}")
    print(json.dumps({"k9_phases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
