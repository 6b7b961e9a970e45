"""lorads_torch's native SDPA reader (lorads_torch/native: the C++
tokenizer built with g++ into build/lorads_torch/ on first use, and
io/sdpa.py's ``_from_raw``) against its pure-Python reader: every array
of every .dat-s fixture equal; the fallback to the Python reader when
the library cannot be built; parse errors; where the library lands."""

import pathlib

import numpy as np
import pytest
import torch

from lorads_torch import native
from lorads_torch.io import sdpa


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are small, and the test workers
    share the cores (eight threads a worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = sorted((ROOT / "tests" / "fixtures").glob("*.dat-s"))


def _need_native():
    if native.load() is None:
        pytest.skip("g++ could not build the tokenizer")


def _same(a, b):
    assert (a.m, len(a.blocks)) == (b.m, len(b.blocks))
    np.testing.assert_array_equal(a.rhs, b.rhs)
    for x, y in zip(a.blocks, b.blocks):
        assert (x.dim, x.m) == (y.dim, y.m)
        for f in ("obj_row", "obj_col", "obj_val", "a_con", "a_row",
                  "a_col", "a_val"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype, f
            np.testing.assert_array_equal(u, v, f)
    assert (a.lp is None) == (b.lp is None)
    if a.lp is not None:
        assert (a.lp.n_cols, a.lp.m) == (b.lp.n_cols, b.lp.m)
        for f in ("obj", "a_con", "a_col", "a_val"):
            u, v = getattr(a.lp, f), getattr(b.lp, f)
            assert u.dtype == v.dtype, f
            np.testing.assert_array_equal(u, v, f)


def test_every_fixture_is_checked():
    assert len(FIXTURES) >= 6


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_native_reader_equals_python_reader(path):
    _need_native()
    got = sdpa.read_sdpa(str(path))
    assert sdpa.LAST_READER == "native"
    ref = sdpa.read_sdpa(str(path), native=False)
    assert sdpa.LAST_READER == "python"
    _same(got, ref)


def test_falls_back_to_python_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "load", lambda: None)
    path = str(FIXTURES[0])
    got = sdpa.read_sdpa(path)
    assert sdpa.LAST_READER == "python"
    _same(got, sdpa._read_sdpa_python(path))


def test_native_parse_error_raises(tmp_path):
    _need_native()
    bad = tmp_path / "bad.dat-s"
    bad.write_text("3\n1\n2\n1 2\n")
    with pytest.raises(ValueError):
        sdpa.read_sdpa(str(bad))


def test_library_builds_outside_the_source_tree():
    out = native.library_path()
    assert out.parent == ROOT / "build" / "lorads_torch"
    assert out.name.startswith("libsdpa_reader_") and out.suffix == ".so"
    assert not list((ROOT / "lorads_torch").rglob("*.so"))
