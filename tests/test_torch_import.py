"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and chip_smoke.py refuses to run without a GPU or away from the package. It
exports every name the JAX package exports."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "flashfftconv_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_pulls_in_no_jax():
    code = (
        "import sys, flashfftconv_tpu_torch, flashfftconv_tpu_torch.models.lm, "
        "flashfftconv_tpu_torch.models.dna, flashfftconv_tpu_torch.models.bert, "
        "flashfftconv_tpu_torch.models.m2_bert, flashfftconv_tpu_torch.utils.checkpoint_import, "
        "flashfftconv_tpu_torch.utils.generation, flashfftconv_tpu_torch.utils.jax_weights, "
        "flashfftconv_tpu_torch.utils.metrics, flashfftconv_tpu_torch.utils.optim, "
        "flashfftconv_tpu_torch.utils.train, flashfftconv_tpu_torch.ops.attention, "
        "flashfftconv_tpu_torch.ops.attention_cuda, flashfftconv_tpu_torch.ops.fused, "
        "flashfftconv_tpu_torch.models.attention, flashfftconv_tpu_torch.models.gpt, "
        "flashfftconv_tpu_torch.models.vit, flashfftconv_tpu_torch.models.moe, "
        "flashfftconv_tpu_torch.ops.sparse\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'flashfftconv_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), cwd=ROOT, timeout=120)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_jax_import_statement(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "flashfftconv_tpu"), (
                f"{path} imports {name}"
            )


# The port's name for a JAX package export: ops/monarch.py is the port of
# monarch_xla, and its plain conv fft_conv_plain that of fft_conv_xla.
ALIASES = {"fft_conv_xla": "fft_conv_plain"}


def test_port_exports_every_name_of_the_jax_package():
    """Every name of the JAX package's ``__all__`` (read with ast, so no JAX
    is imported) is in the port's ``__all__``, under its alias where it has
    one, and resolves."""
    import flashfftconv_tpu_torch as tff

    tree = ast.parse((ROOT / "flashfftconv_tpu" / "__init__.py").read_text())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__" for t in node.targets))
    missing = [n for n in jax_all if ALIASES.get(n, n) not in tff.__all__]
    assert not missing, missing
    for name in tff.__all__:
        assert hasattr(tff, name), name


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              cwd=cwd, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
