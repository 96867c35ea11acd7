"""The six torch example CLIs (``examples/*/*_torch.py``) on the CPU.

Each runs in process through ``main(argv)`` with ``--device cpu`` at the
arguments of its JAX script's smoke test (``tests/test_examples.py``; the
JAX scripts' ``--impl xla`` is the port's default route on the CPU, so it is
left out), and must print the same marker. Each copies the data generators
it needs from its JAX script, which imports JAX at module level: those
copies are held to the JAX scripts' output, bit for bit, on the same seed.
No CLI imports JAX or the JAX package, and each refuses to start without a
card unless ``--device cpu`` is given.
"""

import argparse
import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CLIS = {
    "lm": "examples/lm/train_torch.py",
    "hyena_dna": "examples/hyena_dna/train_torch.py",
    "bert": "examples/bert/train_torch.py",
    "listops": "examples/lra/train_listops_torch.py",
    "retrieval": "examples/lra/train_retrieval_torch.py",
    "ett": "examples/forecasting/train_ett_torch.py",
}
_MODULES = {}


def _load(path: str, name: str):
    """The script at ``path`` as a module named ``name`` (the JAX scripts of
    lm, hyena_dna and bert are all ``train.py``)."""
    if name not in _MODULES:
        spec = importlib.util.spec_from_file_location(name, ROOT / path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[name] = module
    return _MODULES[name]


def cli(key: str):
    return _load(CLIS[key], f"{key}_torch_cli")


def jax_script(key: str):
    return _load(CLIS[key].replace("_torch.py", ".py"), f"{key}_jax_cli")


@pytest.mark.parametrize("key", sorted(CLIS))
def test_cli_imports_no_jax(key):
    tree = ast.parse((ROOT / CLIS[key]).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax",
                                              "flashfftconv_tpu"), f"{key} imports {name}"


@pytest.mark.parametrize("key", sorted(CLIS))
def test_cli_refuses_to_start_without_cuda(key):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli(key).main([])


# --- the CLIs in process, at the JAX smoke tests' arguments --------------------------


def test_lm_cli(tmp_path, capsys):
    cli("lm").main(["--device", "cpu", "--steps", "3", "--d_model", "32", "--n_layer", "1",
                    "--l_max", "128", "--batch_size", "4", "--log-every", "1",
                    "--log-file", str(tmp_path / "lm.jsonl")])
    out = capsys.readouterr().out
    assert "sample:" in out
    with open(tmp_path / "lm.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [0, 1, 2]


def test_lm_cli_config_checkpoint_and_resume(tmp_path, capsys):
    """The registry config of ``examples/lm/configs/hyena_pystdlib.yaml`` (its
    model block: 4 Hyena layers of width 256) at a small length, on a text
    file (the native loader), checkpointed at step 2 and resumed to 3."""
    text = tmp_path / "corpus.txt"
    text.write_bytes(b"".join(p.read_bytes() for p in sorted(ROOT.glob("csrc/*"))
                              if p.suffix in (".cpp", ".txt", "")) * 4)
    config = str(ROOT / "examples/lm/configs/hyena_pystdlib.yaml")
    common = ["--device", "cpu", "--config", config, "--data", str(text), "--l_max", "64",
              "--batch_size", "2", "--eval-every", "1", "--log-every", "1", "--warmup", "1", "--ckpt-dir", str(tmp_path / "ckpt"),
              "--log-file", str(tmp_path / "lm.jsonl")]
    cli("lm").main(common + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "using native C++ dataloader" in out and "model: 3." in out
    assert "bits/byte" in out and "saved checkpoint" in out and "sample:" in out
    cli("lm").main(common + ["--steps", "3", "--resume", "--time-steps"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "step 2: loss" in out and "step 1: loss" not in out
    with open(tmp_path / "lm.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "loss" in r] == [0, 1, 2]
    assert all(np.isfinite(r["val_bits_per_byte"]) for r in recs if "val_loss" in r)


def test_lm_cli_preset_and_config_precedence():
    args = cli("lm").get_args(["--preset", "hyena-125M", "--batch_size", "2"])
    assert (args.d_model, args.n_layer, args.l_max, args.vocab_size) == (768, 12, 8192, 50257)
    assert args.batch_size == 2
    cfg = str(ROOT / "examples/lm/configs/hyena_pystdlib.yaml")
    args = cli("lm").get_args(["--config", cfg, "--steps", "7", "--eval-every=3"])
    assert (args.steps, args.eval_every, args.l_max, args.lr) == (7, 3, 2048, 0.002)
    assert args.model_cfg["_name_"] == "lm" and args.data == "pystdlib"


def test_hyena_dna_cli(capsys):
    cli("hyena_dna").main(["--device", "cpu", "--steps", "2", "--d_model", "32",
                           "--n_layer", "1", "--l_max", "512"])
    assert "bits/base" in capsys.readouterr().out


def test_hyena_dna_cli_benchmark(capsys):
    cli("hyena_dna").main(["--device", "cpu", "--benchmark", "--d_model", "32", "--n_layer", "1",
                           "--l_max", "512", "--batch_size", "2"])
    assert "tokens/ms" in capsys.readouterr().out


def test_bert_cli(capsys):
    cli("bert").main(["--device", "cpu", "--steps", "3", "--d_model", "32", "--n_layer", "1",
                      "--batch_size", "4"])
    assert "mlm loss" in capsys.readouterr().out


def test_listops_cli(tmp_path, capsys):
    """The JAX test's arguments with --min-len 16: its default of 500 is
    above --l-max 256, which no expression can meet."""
    cli("listops").main(["--device", "cpu", "--epochs", "1", "--n-train", "64", "--n-val",
                         "32", "--batch_size", "32", "--l-max", "256", "--min-len", "16",
                         "--d_model", "32", "--n_layers", "1",
                         "--data-cache", str(tmp_path / "listops.npz"),
                         "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "val acc" in capsys.readouterr().out
    assert (tmp_path / "ckpt" / "state.pt").exists()


def test_retrieval_cli(tmp_path, capsys):
    cli("retrieval").main(["--device", "cpu", "--epochs", "1", "--n-train", "64", "--n-val",
                           "32", "--batch_size", "16", "--l-max", "256", "--d_model", "32",
                           "--n_layers", "1", "--data-cache", str(tmp_path / "retrieval.npz"),
                           "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "val acc" in capsys.readouterr().out


def test_forecasting_cli(tmp_path, capsys):
    cli("ett").main(["--device", "cpu", "--epochs", "1", "--n-steps", "2000", "--l-max", "256",
                     "--horizon", "24", "--batch_size", "16", "--d_model", "32", "--n_layers",
                     "1", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "val mse" in capsys.readouterr().out


# --- the copied generators against the JAX scripts -----------------------------------


def test_listops_dataset_matches_jax():
    for args in ((24, 256, 0, 32), (8, 128, 5, 16)):
        x, y = cli("listops").build_dataset(*args[:3], min_len=args[3])
        jx, jy = jax_script("listops").build_dataset(*args[:3], min_len=args[3])
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    with pytest.raises(ValueError):
        cli("listops").build_dataset(4, 256, 0, min_len=500)


def test_retrieval_dataset_matches_jax():
    got = cli("retrieval").build_dataset(8, 128, 0, noise=0.2)
    ref = jax_script("retrieval").build_dataset(8, 128, 0, noise=0.2)
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a, b)


def test_ett_series_windows_and_baseline_match_jax():
    ours, ref = cli("ett"), jax_script("ett")
    s = ours.build_series(1000, seed=3)
    np.testing.assert_array_equal(s, ref.build_series(1000, seed=3))
    for a, b in zip(ours.make_windows(s, 64, 8, 4), ref.make_windows(s, 64, 8, 4), strict=True):
        np.testing.assert_array_equal(a, b)
    assert ours.seasonal_naive_mse(s, 256, 24, 600) == ref.seasonal_naive_mse(s, 256, 24, 600)


def test_genome_matches_jax(tmp_path):
    fasta = tmp_path / "g.fa"
    fasta.write_text(">chr\nACGTNacgtRY\nGGCC\n>b\nttaa\n")
    for argv in (["--seed", "3"], ["--fasta", str(fasta)]):
        args = cli("hyena_dna").get_args(argv)
        ref = jax_script("hyena_dna").load_genome(argparse.Namespace(fasta=args.fasta,
                                                                     seed=args.seed))
        got = cli("hyena_dna").load_genome(args)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_mlm_batch_and_corpus_match_jax():
    ours, ref = cli("bert"), jax_script("bert")
    corpus = ours.load_corpus()
    np.testing.assert_array_equal(corpus, ref.load_corpus())
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(2):
        for a, b in zip(ours.mlm_batch(corpus, 4, 64, 0.15, r1),
                        ref.mlm_batch(corpus, 4, 64, 0.15, r2), strict=True):
            np.testing.assert_array_equal(a, b)


def test_lm_corpora_match_jax(tmp_path):
    ours, ref = cli("lm"), jax_script("lm")
    text = tmp_path / "t.txt"
    text.write_bytes(bytes(range(256)) * 3)
    for data in ("", str(text)):
        (a, pa), (b, pb) = ours.load_bytes(argparse.Namespace(data=data)), \
            ref.load_bytes(argparse.Namespace(data=data))
        np.testing.assert_array_equal(a, b)
        assert pa == pb
    got = ours.build_pystdlib_corpus(str(tmp_path / "a" / "pystdlib.bin"))
    want = ref.build_pystdlib_corpus(str(tmp_path / "b" / "pystdlib.bin"))
    assert got.size > 1_000_000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours.build_pystdlib_corpus(str(tmp_path / "a" / "pystdlib.bin")),
                                  want)  # from the cache
