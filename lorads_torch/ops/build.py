"""Build and load the CUDA kernels of ``lorads_torch/csrc``.

On first use every ``csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the
objects into a shared library with a plain C interface, written to
``<repo>/build/lorads_torch/`` under a name keyed by a hash of the
sources and flags; ``ctypes`` loads it.  Later calls (and later
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
# compensated sums of warp_acc.cuh); -Xptxas -v reports each kernel's
# registers, shared memory and spills (printed by build(verbose=True))
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point: (is_f64 or mode flags, pointers...,
# ints..., stream)
_SIGNATURES = {
    "lt_segment_sum": [_I, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "lt_cmul": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "lt_uvt_split": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                     _VP],
    "lt_uvt_pair": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                    _I, _VP],
    "lt_gather_segsum": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                         ctypes.c_double, _VP],
    "lt_wmul": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                _VP],
    "lt_adj_a_offdiag": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                         _I, _VP],
    "lt_adj_a_dense": [_I, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "lt_lp_gs_sweep": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _I, _I, _I, ctypes.c_double, _VP],
    "lt_onehot_scatter": [_I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                          _VP],
    "lt_onehot_gather": [_I, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "lt_row_gather": [_I, _VP, _VP, _VP, _I, _I, _I, _VP],
    "lt_scatter_add": [_VP, _VP, _VP, _I, _I, _VP],
}

_LIB = None
# wall seconds of the build made by this process (0.0 = cached)
BUILD_SECONDS = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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


def _run_all(cmds):
    """Start every command at once and wait for all of them; raise if
    any failed.  Returns the commands' combined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the sources into the keyed library unless it exists: one
    nvcc process per source, in parallel, then one link."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(tmp) / f"{src.stem}.o")
            objs.append(obj)
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)])
        log = _run_all(cmds)
        tmp_out = Path(tmp) / out.name
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp_out), *objs]])
        if verbose and log:
            print(log)
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
