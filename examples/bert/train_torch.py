"""M2-BERT masked-language-model pretraining with the PyTorch port.

The port's counterpart of ``examples/bert/train.py``: Monarch Mixer BERT
(bidirectional gated long-conv mixers, block-diagonal or dense MLPs)
trained on the 15% masked-LM objective with the examples/bert recipe (clip
1.0, AdamW at lr 8e-4, weight decay 1e-5 on every parameter), and the
forward benchmark in tokens/ms and seqs/s. On the card every long conv (FFT
size 2 * l_max; 256 at the base-110M preset) runs the direct-DFT kernels.

Data: byte-level over a local corpus (the JAX package's sources).

Run:  python examples/bert/train_torch.py --steps 30 --d_model 128 --n_layer 2
      python examples/bert/train_torch.py --preset base-110M --benchmark
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

MASK_ID = 256
VOCAB = 257  # bytes + [MASK]

# base-110M: the reference's m2-110M config (12 layers, hidden 768,
# max_seq_len 128, batch 128, dense MLP, GLU off), with bert-base-uncased's
# vocabulary of 30522 so that the embedding table and the MLM decoder have
# the reference's size (the ids here stay < 257).
PRESETS = {
    "base-110M": dict(d_model=768, n_layer=12, l_max=128, batch_size=128,
                      mlp_nblocks=0, vocab_size=30522, tie_mlm_head=True),
}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="", choices=[""] + list(PRESETS))
    p.add_argument("--d_model", default=256, type=int)
    p.add_argument("--n_layer", default=4, type=int)
    p.add_argument("--l_max", default=128, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--mlp-nblocks", dest="mlp_nblocks", default=4, type=int,
                   help="0 = dense MLP (the 110M config); >0 = BlockdiagLinear")
    p.add_argument("--steps", default=100, type=int)
    p.add_argument("--lr", default=8e-4, type=float)
    p.add_argument("--mask-prob", default=0.15, type=float)
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--impl", default="auto", choices=["auto", "cuda", "plain", "fft"],
                   help="long-conv route (the JAX script's 'xla' is 'plain' here)")
    p.add_argument("--vocab-size", dest="vocab_size", default=VOCAB, type=int)
    p.add_argument("--tie-mlm-head", dest="tie_mlm_head", action="store_true",
                   help="tie the MLM decoder to the word embeddings")
    p.add_argument("--log-file", default="", help="JSONL metrics artifact path")
    p.add_argument("--time-steps", action="store_true", help="report every step's wall time")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.preset:
        # the preset fills fields left at their defaults; explicit flags win
        for k, v in PRESETS[args.preset].items():
            if getattr(args, k) == p.get_default(k):
                setattr(args, k, v)
    return args


def load_corpus() -> np.ndarray:
    """Byte ids of the JAX package's Python sources (read as text)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
    chunks = []
    for path in sorted(glob.glob(os.path.join(root, "flashfftconv_tpu/**/*.py"),
                                 recursive=True)):
        with open(path, "rb") as f:
            chunks.append(np.frombuffer(f.read(), np.uint8))
    return np.concatenate(chunks).astype(np.int32)


def mlm_batch(tokens, batch_size, seq_len, mask_prob, rng):
    """One masked-LM batch of random windows: x with MASK_ID at the masked
    positions, labels the true ids there and -100 (ignored) elsewhere."""
    starts = rng.integers(0, len(tokens) - seq_len, batch_size)
    x = np.stack([tokens[s : s + seq_len] for s in starts])
    labels = x.copy()
    mask = rng.random(x.shape) < mask_prob
    x = np.where(mask, MASK_ID, x)
    labels = np.where(mask, labels, -100)  # ignore index
    return x, labels


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_torch.py: CUDA is not available; pass --device cpu to run on the CPU")
    from flashfftconv_tpu_torch.models.bert import M2BertForMaskedLM
    from flashfftconv_tpu_torch.utils.benchmarking import benchmark_forward
    from flashfftconv_tpu_torch.utils.logging import MetricLogger
    from flashfftconv_tpu_torch.utils.train import (
        bert_optimizer,
        create_train_state,
        make_train_step,
        mlm_loss,
    )

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    model = M2BertForMaskedLM(
        vocab_size=args.vocab_size, d_model=args.d_model, n_layer=args.n_layer,
        d_inner=4 * args.d_model, l_max=args.l_max, mlp_nblocks=args.mlp_nblocks,
        tie_mlm_head=args.tie_mlm_head, impl=args.impl, device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    n_params = sum(p.numel() for p in model.parameters())
    print(f"M2-BERT: {n_params / 1e6:.2f}M params", flush=True)
    logger = MetricLogger(args.log_file) if args.log_file else None
    config = dict(preset=args.preset or "custom", vocab_size=args.vocab_size,
                  d_model=args.d_model, n_layer=args.n_layer, l_max=args.l_max,
                  B=args.batch_size, mlp_nblocks=args.mlp_nblocks, n_params=int(n_params),
                  impl=args.impl, device=args.device)
    toks = args.batch_size * args.l_max

    if args.benchmark:
        model.eval()
        ids = torch.zeros((args.batch_size, args.l_max), dtype=torch.long, device=device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        ms = benchmark_forward(model, ids, repeats=10, device=device)
        peak = (f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MB" if cuda
                else "not measured on the CPU")
        print(f"fwd: {ms:.2f} ms | {toks / ms:.1f} tokens/ms | "
              f"{args.batch_size / (ms / 1e3):.1f} seqs/s | peak {peak}", flush=True)
        if logger:
            logger.log({**config, "mode": "fwd_benchmark", "fwd_ms": ms,
                        "tokens_per_ms": toks / ms,
                        "seqs_per_s": args.batch_size / (ms / 1e3)})
        return

    corpus = load_corpus()
    model.train()
    opt = bert_optimizer(model, lr=args.lr)
    state = create_train_state(model, opt)
    step_fn = make_train_step(model, opt, clip=1.0, loss_fn=mlm_loss)
    data_rng = np.random.default_rng(args.seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_prev = time.perf_counter()
    for step in range(args.steps):
        x, labels = (torch.from_numpy(a).to(device).long()
                     for a in mlm_batch(corpus, args.batch_size, args.l_max, args.mask_prob,
                                        data_rng))
        torch.manual_seed((args.seed << 32) + step)  # dropout masks of this step
        out = step_fn(x, labels)
        loss, acc = float(out["loss"]), float(out["accuracy"])  # waits for the step
        state.step += 1
        dt = time.perf_counter() - t_prev
        t_prev = time.perf_counter()
        if args.time_steps and step == 0:
            peak = (f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MB" if cuda
                    else "not measured on the CPU")
            print(f"train-step peak memory: {peak}", flush=True)
        if step % 10 == 0 or step == args.steps - 1 or args.time_steps:
            print(f"step {step}: mlm loss {loss:.3f} acc {acc * 100:.1f}% "
                  f"{dt:.2f} s/step {toks / dt:.0f} tokens/s", flush=True)
        if logger:
            rec = {"mlm_loss": loss, "mlm_acc": acc, "step_s": dt, "tokens_per_s": toks / dt}
            if step == 0:
                rec.update(config, mode="train", first_step_s=dt)
            logger.log(rec, step=step)


if __name__ == "__main__":
    main()
