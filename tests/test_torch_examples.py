"""The ten torch example CLIs (``examples/*/*_torch.py``) on the CPU.

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

# The test workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CLIS = {
    "lm": "examples/lm/train_torch.py",
    "hyena_dna": "examples/hyena_dna/train_torch.py",
    "bert": "examples/bert/train_torch.py",
    "listops": "examples/lra/train_listops_torch.py",
    "retrieval": "examples/lra/train_retrieval_torch.py",
    "ett": "examples/forecasting/train_ett_torch.py",
    "pathfinder": "examples/lra/train_pathfinder_torch.py",
    "seqcls": "examples/seqcls/train_torch.py",
    "cifar": "examples/cifar/train_torch.py",
    "ultra_long": "examples/seq_parallel/train_ultra_long_torch.py",
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


def test_pathfinder_cli(tmp_path, capsys):
    cli("pathfinder").main(["--device", "cpu", "--epochs", "1", "--n-train", "64", "--n-val",
                            "32", "--batch_size", "32", "--d_model", "32", "--n_layers", "1",
                            "--data-cache", str(tmp_path / "pathfinder.npz"),
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "val acc" in capsys.readouterr().out
    assert (tmp_path / "ckpt" / "state.pt").exists()


def test_seqcls_cli(tmp_path, capsys):
    """The JAX script has no smoke test; these are the arguments chip_smoke
    gives it."""
    cli("seqcls").main(["--device", "cpu", "--epochs", "1", "--per-class", "64",
                        "--limit-batches", "2", "--d_model", "32", "--n_layers", "1",
                        "--data-cache", str(tmp_path / "seqcls.npz"),
                        "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "val acc" in capsys.readouterr().out


def test_cifar_cli(tmp_path, capsys):
    cli("cifar").main(["--device", "cpu", "--epochs", "1", "--synthetic", "--d_model", "32",
                       "--n_layers", "1", "--batch_size", "32", "--limit-batches", "2",
                       "--ckpt-dir", str(tmp_path / "ckpt")])
    assert "val acc" in capsys.readouterr().out
    cli("cifar").main(["--device", "cpu", "--epochs", "2", "--synthetic", "--d_model", "32",
                       "--n_layers", "1", "--batch_size", "32", "--limit-batches", "1",
                       "--ckpt-dir", str(tmp_path / "ckpt"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed" in out and "from epoch 0" in out and "epoch 1:" in out


def test_ultra_long_cli(capsys):
    cli("ultra_long").main(["--device", "cpu", "--l-max", "2048", "--steps", "2",
                            "--d_model", "16", "--n_layers", "1"])
    out = capsys.readouterr().out
    assert "mesh: {'dp': 1, 'sp': 1}" in out and "final loss" in out


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


def test_pathfinder_dataset_matches_jax():
    for n, seed in ((16, 0), (6, 3)):
        x, y = cli("pathfinder").build_dataset(n, seed)
        jx, jy = jax_script("pathfinder").build_dataset(n, seed)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_pathfinder_generator_properties():
    """tests/test_examples.py's properties, on the port's copy."""
    ours = cli("pathfinder")
    x, y = ours.build_dataset(16, seed=0)
    assert x.shape == (16, ours.SIDE * ours.SIDE) and set(np.unique(y)) == {0, 1}
    for img in x:
        assert (img == ours.MARK_VAL).sum() >= 4
        assert ((img > 0) & (img < ours.MARK_VAL)).sum() > 20
    m0, m1 = x[y == 0].mean(), x[y == 1].mean()
    assert abs(m0 - m1) / max(m0, m1) < 0.2


def test_seqcls_dataset_matches_jax(tmp_path, monkeypatch):
    ours, ref = cli("seqcls"), jax_script("seqcls")
    assert ours.CLASSES == ref.CLASSES and ours.SEQ_LEN == ref.SEQ_LEN
    got = ours.build_dataset(str(tmp_path / "a.npz"), 8, 1)
    want = ref.build_dataset(str(tmp_path / "b.npz"), 8, 1)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    # a class whose roots hold no file: the JAX script fails in np.stack([])
    monkeypatch.setattr(ours, "CLASSES", [("empty", [str(tmp_path / "none")], (".py",))])
    with pytest.raises(ValueError, match="class empty"):
        ours.build_dataset(str(tmp_path / "c.npz"), 8, 1)


def test_cifar_synthetic_set_matches_jax():
    for gray in (False, True):
        args = argparse.Namespace(synthetic=True, grayscale=gray, seed=2)
        for a, b in zip(cli("cifar").load_cifar(args), jax_script("cifar").load_cifar(args),
                        strict=True):
            np.testing.assert_array_equal(a, b)


def _fake_cifar(root, n_batches=2, rows=20, seed=0):
    """Two small data_batch pickles in CIFAR-10's python format."""
    import pickle

    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, n_batches + 1):
        data = rng.integers(0, 256, (rows, 3072), dtype=np.uint8)
        labels = rng.integers(0, 10, rows).tolist()
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": data, "labels": labels, "batch_label": f"batch {i}"}, f)
        out.append((data, labels))
    return out


def test_cifar_loader_reads_the_pickles(tmp_path):
    """The pickles through the loader against the JAX script's numpy steps on
    what torchvision's CIFAR10 + ToTensor would give: the images as HWC
    bytes, PIL's grayscale, /255, (d, 1024).T, the per-channel
    standardisation and the last-tenth split."""
    from PIL import Image

    batches = _fake_cifar(tmp_path)
    data = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    hwc = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    for gray in (False, True):
        if gray:
            imgs = [np.asarray(Image.fromarray(im).convert("L"))[None] for im in hwc]
        else:
            imgs = [im.transpose(2, 0, 1) for im in hwc]
        d_input = 1 if gray else 3
        xs = np.stack([(im.astype(np.float32) / 255).reshape(d_input, 1024).T for im in imgs])
        mean = xs.mean((0, 1), keepdims=True)
        std = xs.std((0, 1), keepdims=True) + 1e-6
        xs = (xs - mean) / std
        n_val = len(xs) // 10
        want = xs[:-n_val], ys[:-n_val], xs[-n_val:], ys[-n_val:]
        args = argparse.Namespace(synthetic=False, grayscale=gray, seed=0,
                                  data_dir=str(tmp_path))
        got = cli("cifar").load_cifar(args)
        assert got[0].shape == (36, 1024, d_input) and got[2].shape == (4, 1024, d_input)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)


def test_cifar_without_files_uses_synthetic(tmp_path, capsys):
    args = argparse.Namespace(synthetic=False, grayscale=False, seed=2, data_dir=str(tmp_path))
    got = cli("cifar").load_cifar(args)
    assert "using synthetic data" in capsys.readouterr().out
    want = cli("cifar").load_cifar(argparse.Namespace(synthetic=True, grayscale=False, seed=2))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_ultra_long_batch_matches_jax():
    for b, l, vocab, seed in ((1, 2048, 64, 0), (3, 100, 17, 5)):
        got = cli("ultra_long").make_batch(np.random.default_rng(seed), b, l, vocab)
        want = jax_script("ultra_long").make_batch(np.random.default_rng(seed), b, l, vocab)
        for a, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, w)
