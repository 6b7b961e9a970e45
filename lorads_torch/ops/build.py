"""Build and load the CUDA kernels of ``lorads_torch/csrc``.

On first use one ``nvcc`` call compiles every ``csrc/*.cu`` into a
shared library with a plain C interface, written to
``<repo>/build/lorads_torch/`` under a name keyed by a hash of the
sources and flags, and loads it with ``ctypes``.  Later calls (and later
processes, while the sources are unchanged) reuse the library.  Building
needs ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``);
nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lorads_torch"

# Hopper (sm_90a), no --use_fast_math (it would undo the f32
# compensated sums of warp_acc.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point: (is_f64, pointers..., ints..., stream)
_SIGNATURES = {
    "lt_segment_sum": [_I, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "lt_cmul": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "lt_uvt_split": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                     _VP],
}

_LIB = None
# wall seconds of the nvcc call made by this process (0.0 = cached)
BUILD_SECONDS = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblorads_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the lorads_torch CUDA kernels "
                       "need the CUDA toolkit to build")


def build(verbose: bool = False) -> Path:
    """Compile the sources into the keyed library unless it exists."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_out), *cu]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        if verbose and (res.stdout or res.stderr):
            print(res.stdout + res.stderr)
        os.replace(tmp_out, out)
    BUILD_SECONDS = time.time() - t0
    return out


def load():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
