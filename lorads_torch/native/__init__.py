"""The native (C++) SDPA tokenizer, built with g++ on first use and
loaded with ctypes (lorads_tpu/native/__init__.py's loader).

The library is built from ``sdpa_reader.cpp`` into
``<repo>/build/lorads_torch/`` (never into the source tree) under a name
keyed by a hash of the source, the flags and the machine, first under a
temporary name in that directory and then moved into place with
``os.replace``, so processes (or test workers) that build at once do not
race.  ``-march=native`` is left out: the build directory may travel
with the checkout to another host.  ``load`` returns None when g++ is
missing or the build fails, and the reader falls back to its
pure-Python path (io/sdpa.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "sdpa_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lorads_torch"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsdpa_reader_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> bool:
    """Compile the tokenizer unless its library exists; True on
    success."""
    out = library_path()
    if out.exists() and not force:
        return True
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):   # no g++, or it failed
        return False


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed), or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(str(library_path()))
        except OSError:
            return None
        lib.sdpa_parse.restype = ctypes.c_void_p
        lib.sdpa_parse.argtypes = [ctypes.c_char_p]
        lib.sdpa_error.restype = ctypes.c_char_p
        lib.sdpa_error.argtypes = [ctypes.c_void_p]
        for f in (lib.sdpa_m, lib.sdpa_n_blocks, lib.sdpa_n_entries):
            f.restype = ctypes.c_int64
            f.argtypes = [ctypes.c_void_p]
        lib.sdpa_copy_header.restype = None
        lib.sdpa_copy_header.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib.sdpa_copy_entries.restype = None
        lib.sdpa_copy_entries.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 5
        lib.sdpa_free.restype = None
        lib.sdpa_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
