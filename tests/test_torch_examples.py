"""Smoke-run the PyTorch/CUDA port's example scripts (examples/torch/*.py)
on the CPU, one subprocess each, as tests/test_examples.py runs
lorads_tpu's: each takes ``--device`` (default cuda) and is run here
with ``--device cpu``."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

EXAMPLES = sorted(
    (pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch")
    .glob("*.py"))


def test_the_three_twins_are_there():
    assert [p.stem for p in EXAMPLES] == [
        "basic_usage", "batch_and_extract", "checkpoint_and_resume"]


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_runs(script, tmp_path):
    proc = subprocess.run(
        [sys.executable, str(script), "--device", "cpu"], cwd=tmp_path,
        # one intra-op thread: the test workers share the cores
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, (
        f"{script.name} failed\n--- stdout ---\n{proc.stdout[-4000:]}"
        f"\n--- stderr ---\n{proc.stderr[-4000:]}")
    assert "primal_dual_optimal" in proc.stdout
    # the twins import the port alone
    assert not re.search(r"^\s*(import|from)\s+(jax|lorads_tpu)\b",
                         script.read_text(), re.M)
