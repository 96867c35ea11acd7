"""Causal LM training (Hyena / H3 / M2 / attention mixers) with the PyTorch port.

The port's counterpart of ``examples/lm/train.py``: a model from the
arguments or from a ``_name_``-keyed config through the registry, the
examples/lm recipe (clip the gradients' global norm, then AdamW under a
linear-warmup cosine schedule), a 2% validation split reported in bits per
byte, JSONL metrics, a checkpoint at the end and ``--resume`` from it, an
emergency checkpoint when the loop dies, the native C++ data loader when the
data is a file, and a generation sample at the end. On the card every long
and short conv, forward and backward, runs the port's CUDA kernels.

The JAX script shards the batch over a data-parallel mesh; here the world
size is 1 (the port's mesh module is still to come). Like the JAX script,
``--resume`` restores the model, the optimizer, its schedule and the step,
and restarts the data loader from its seed. The dropout masks are a function
of (seed, step), as the JAX script's ``fold_in(rng, step)`` makes them, so a
resumed step draws the masks the uninterrupted run would have.

Data: byte-level LM over a local text corpus (--data any text file, or
'pystdlib', the Python standard library's sources assembled locally;
default: the JAX package's sources). Nothing is downloaded.

Run:  python examples/lm/train_torch.py --steps 50 --mixer hyena --d_model 128
      python examples/lm/train_torch.py --preset hyena-125M --data pystdlib
      python examples/lm/train_torch.py --device cpu --steps 3 --d_model 32 --n_layer 1 --l_max 128
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

# hyena-125M: GPT-Neo-125M's geometry (12 layers, d_model 768, d_inner 3072,
# vocab 50257). The data are bytes (ids < 256), but the embedding and the
# tied head are sized at the GPT-2 vocabulary, as the JAX preset does.
PRESETS = {
    "hyena-125M": dict(mixer="hyena", d_model=768, n_layer=12, l_max=8192,
                       batch_size=4, vocab_size=50257),
}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="", help="yaml config (registry _name_ keys)")
    p.add_argument("--preset", default="", choices=[""] + list(PRESETS))
    p.add_argument("--mixer", default="hyena", choices=["hyena", "h3", "m2", "mha"])
    p.add_argument("--d_model", default=256, type=int)
    p.add_argument("--n_layer", default=4, type=int)
    p.add_argument("--l_max", default=1024, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--steps", default=200, type=int)
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--weight_decay", default=0.1, type=float)
    p.add_argument("--warmup", default=20, type=int)
    p.add_argument("--clip", default=1.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--data", default="",
                   help="text/token file, or 'pystdlib' for the Python-stdlib source "
                   "corpus (~15 MB, assembled locally); default: the JAX package's sources")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", default=10, type=int)
    p.add_argument("--eval-every", default=0, type=int, help="val bits/byte cadence")
    p.add_argument("--run-name", default="")
    p.add_argument("--impl", default="auto", choices=["auto", "cuda", "plain", "fft"],
                   help="long-conv route (the JAX script's 'xla' is 'plain' here)")
    p.add_argument("--vocab-size", dest="vocab_size", default=256, type=int)
    p.add_argument("--remat", action="store_true", help="gradient checkpointing per block")
    p.add_argument("--log-file", default="",
                   help="exact JSONL artifact path (default ./logs/<run>.jsonl)")
    p.add_argument("--time-steps", action="store_true",
                   help="time every step (synchronised) and print the train-step peak memory")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    given = {a.split("=")[0] for a in (sys.argv[1:] if argv is None else argv)
             if a.startswith("--")}
    if args.preset:
        # the preset fills fields left at their defaults; explicit flags win
        for k, v in PRESETS[args.preset].items():
            if getattr(args, k) == p.get_default(k):
                setattr(args, k, v)
    args.model_cfg = None
    if args.config:
        import yaml

        with open(args.config) as f:
            cfg = yaml.safe_load(f)
        for key, val in cfg.items():
            attr = key.replace("-", "_")
            if hasattr(args, attr) and f"--{key}" not in given:
                setattr(args, attr, val)
        args.model_cfg = cfg.get("model")
    return args


def build_pystdlib_corpus(cache_path: str) -> np.ndarray:
    """The running Python's standard-library sources (test directories left
    out, files in sorted order) as one byte corpus, cached as a flat uint8
    file; returns int32 ids."""
    import sysconfig

    if os.path.exists(cache_path):
        return np.fromfile(cache_path, np.uint8).astype(np.int32)
    stdlib = sysconfig.get_paths()["stdlib"]
    chunks = []
    for path in sorted(glob.glob(os.path.join(stdlib, "**/*.py"), recursive=True)):
        if "test" in path:
            continue
        with open(path, "rb") as f:
            chunks.append(np.frombuffer(f.read(), np.uint8))
    corpus = np.concatenate(chunks)
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    tmp = f"{cache_path}.tmp-{os.getpid()}"
    corpus.tofile(tmp)
    os.replace(tmp, cache_path)
    print(f"built pystdlib corpus: {len(corpus):,} bytes -> {cache_path}", flush=True)
    return corpus.astype(np.int32)


def load_bytes(args) -> tuple[np.ndarray, str]:
    """Returns (tokens, backing file path or '')."""
    here = os.path.dirname(os.path.abspath(__file__))
    if args.data == "pystdlib":
        cache = os.path.join(here, "data", "pystdlib.bin")
        return build_pystdlib_corpus(cache), cache
    if args.data:
        with open(args.data, "rb") as f:
            return np.frombuffer(f.read(), np.uint8).astype(np.int32), args.data
    root = os.path.join(here, "..", "..")
    chunks = []
    for path in sorted(glob.glob(os.path.join(root, "flashfftconv_tpu/**/*.py"), recursive=True)):
        with open(path, "rb") as f:
            chunks.append(np.frombuffer(f.read(), np.uint8))
    return np.concatenate(chunks).astype(np.int32), ""


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_torch.py: CUDA is not available; pass --device cpu to train on the CPU")
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils import native_loader
    from flashfftconv_tpu_torch.utils.data import lm_batches
    from flashfftconv_tpu_torch.utils.generation import generate
    from flashfftconv_tpu_torch.utils.logging import MetricLogger
    from flashfftconv_tpu_torch.utils.metrics import SpeedMonitor, cross_entropy
    from flashfftconv_tpu_torch.utils.registry import instantiate
    from flashfftconv_tpu_torch.utils.train import (
        auto_save_on_exception,
        create_train_state,
        lm_optimizer,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )

    device = torch.device(args.device)
    tokens, data_path = load_bytes(args)
    # Hold out the final 2% as validation (a split that no resume moves).
    n_val = max(len(tokens) // 50, args.batch_size * (args.l_max + 1)) if args.eval_every else 0
    val_tokens = tokens[len(tokens) - n_val :] if n_val else None
    tokens = tokens[: len(tokens) - n_val]
    print(f"corpus: {len(tokens):,} train bytes, {n_val:,} val bytes", flush=True)
    if n_val and data_path:
        # The native loader maps a file: give it one that holds the train
        # split alone, so validation bytes never reach training.
        train_path = data_path + ".train"
        if not os.path.exists(train_path) or os.path.getsize(train_path) != len(tokens):
            tmp = f"{train_path}.tmp-{os.getpid()}"
            tokens.astype(np.uint8).tofile(tmp)
            os.replace(tmp, train_path)
        data_path = train_path

    generator = torch.Generator().manual_seed(args.seed)
    if args.model_cfg:
        model = instantiate("model", args.model_cfg, l_max=args.l_max, dtype=torch.bfloat16,
                            device=device, generator=generator)
    else:
        model = ConvLMHeadModel(
            d_model=args.d_model, n_layer=args.n_layer, d_inner=4 * args.d_model,
            vocab_size=args.vocab_size, l_max=args.l_max, mixer=args.mixer,
            mixer_kwargs={"impl": args.impl}, remat=args.remat, dtype=torch.bfloat16,
            device=device, generator=generator,
        )
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params, mixer={args.mixer}", flush=True)

    opt, sched = lm_optimizer(model, lr=args.lr, weight_decay=args.weight_decay,
                              warmup=args.warmup, steps=args.steps)
    state = create_train_state(model, opt, sched)
    train_step = make_train_step(model, opt, sched, clip=args.clip)

    start_step = 0
    if args.resume and args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        state, extra = restore_checkpoint(os.path.abspath(args.ckpt_dir), state, {"step": 0})
        start_step = int(extra["step"])
        print(f"resumed at step {start_step}", flush=True)

    if args.time_steps:
        args.log_every = 1  # a synchronised, timed step each step
    logger = MetricLogger(logdir=args.log_file or "./logs",
                          run_name=args.run_name or f"lm-{args.mixer}")
    speed = SpeedMonitor()

    @torch.no_grad()
    def run_eval() -> float:
        """Mean val loss over contiguous windows; bits/byte = loss / ln 2."""
        model.eval()
        losses = []
        span = args.batch_size * args.l_max
        for off in range(0, len(val_tokens) - span - 1, span):
            xy = torch.from_numpy(val_tokens[off : off + span + 1]).to(device).long()
            x = xy[:-1].reshape(args.batch_size, args.l_max)
            y = xy[1:].reshape(args.batch_size, args.l_max)
            losses.append(float(cross_entropy(model(x), y)))
        model.train()
        return float(np.mean(losses)) if losses else float("nan")

    # Prefer the native threaded loader (batch assembly overlaps the steps);
    # without a backing file, batches come from lm_batches.
    loader = None
    if data_path and native_loader.available():
        loader = native_loader.NativeLMLoader(data_path, args.batch_size, args.l_max,
                                              seed=args.seed)
        batches = iter(loader)
        print("using native C++ dataloader", flush=True)
    else:
        batches = lm_batches(tokens, args.batch_size, args.l_max,
                             np.random.default_rng(args.seed))

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    guard = auto_save_on_exception(args.ckpt_dir or "./checkpoint/lm")
    try:
        with guard:
            for step in range(start_step, args.steps):
                x_np, y_np = next(batches)
                x = torch.from_numpy(x_np).to(device).long()
                y = torch.from_numpy(y_np).to(device).long()
                torch.manual_seed((args.seed << 32) + step)  # dropout masks of this step
                if args.time_steps and cuda:
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                loss = float(train_step(x, y)["loss"])  # waits for the step
                step_ms = (time.perf_counter() - t0) * 1e3
                state.step += 1
                if args.time_steps and step == start_step:
                    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MB"
                            if cuda else "not measured on the CPU")
                    print(f"train-step peak memory: {peak}", flush=True)
                if step % args.log_every == 0 or step == args.steps - 1:
                    guard.track(state, extra={"step": step})
                    m = speed.step(args.batch_size * args.l_max)
                    m.update(loss=loss, ppl=math.exp(loss), step=step)
                    if args.time_steps:
                        m["step_ms"] = step_ms
                    logger.log(m, step=step)
                    tok_s = m.get("items_per_sec", 0.0)
                    print(f"step {step}: loss {loss:.3f} ppl {math.exp(loss):.1f}"
                          + (f" | {tok_s / 1e3:.1f}K tok/s" if tok_s else "")
                          + (f" | {step_ms:.2f} ms" if args.time_steps else ""), flush=True)
                if args.eval_every and (step % args.eval_every == args.eval_every - 1
                                        or step == args.steps - 1):
                    vloss = run_eval()
                    bpb = vloss / math.log(2)
                    logger.log({"val_loss": vloss, "val_bits_per_byte": bpb}, step=step)
                    print(f"step {step}: val loss {vloss:.3f}, {bpb:.3f} bits/byte", flush=True)
    finally:
        if loader is not None:
            loader.close()

    if args.ckpt_dir:
        save_checkpoint(os.path.abspath(args.ckpt_dir), state, {"step": args.steps})
        print(f"saved checkpoint to {args.ckpt_dir}", flush=True)

    # Generation sample (byte-level).
    model.eval()
    prompt = torch.from_numpy(tokens[None, :32]).to(device).long()
    out = generate(model, prompt, max_new_tokens=32, max_length=args.l_max, temperature=0.8,
                   top_k=40, generator=torch.Generator(device).manual_seed(args.seed))
    txt = bytes(out[0].clamp(0, 255).tolist()).decode("utf-8", "replace")
    print(f"sample: {txt!r}", flush=True)
    logger.finish()


if __name__ == "__main__":
    main()
