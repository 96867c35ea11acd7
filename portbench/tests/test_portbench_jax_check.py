"""The check that no run loaded JAX or the JAX package compares whole
top-level module names."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import ROOT

from portbench import harness


@pytest.mark.parametrize("name, flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("flashfftconv_tpu", True), ("flashfftconv_tpu.ops.monarch", True),
    ("flashfftconv_tpu_torch", False), ("flashfftconv_tpu_torch.models.lm", False),
    ("jaxtyping", False), ("flaxen", False), ("torch", False),
])
def test_whole_top_level_names(name, flagged):
    assert harness.forbidden_modules({name: None}) == ([name] if flagged else [])


def test_loading_the_port_and_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import flashfftconv_tpu_torch; "
            "from flashfftconv_tpu_torch.models import dna, lm; "
            "from flashfftconv_tpu_torch.utils import train, metrics; "
            "from portbench import harness, calibrate, trace, program; "
            "harness.traffic('train'); harness.traffic('score'); "
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"flashfftconv_tpu", "flashfftconv_tpu_torch", "jax", "jaxlib",
                           "flax"}, path


def test_no_harness_file_imports_jax():
    for path in Path(ROOT / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not {n.split(".")[0] for n in names} & {"flashfftconv_tpu", "jax", "jaxlib",
                                                        "flax"}, path
