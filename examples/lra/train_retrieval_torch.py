"""LRA Retrieval-protocol task with the SequenceModel harness, on the PyTorch port.

The port's counterpart of ``examples/lra/train_retrieval.py``. LRA Retrieval
(AAN) classifies whether two long byte-level documents are related, each
encoded on its own (a two-tower protocol) and the pooled features compared
by a small classifier over [u, v, u - v, u * v]. The documents are
generated offline by the JAX script's generator (one seed, the same data):
an "article" is a sequence from a random Markov chain over a 64-token
vocabulary; a positive pair is two noisy copies of one article, a negative
pair noisy copies of two articles of the same chain. Random is 50%.

Drives ``SequenceModel`` with an embedding encoder, long-conv mixer blocks,
the stacked (2B, L) batch and the retrieval decoder, with
``utils.tasks.get_task("classification")`` and AdamW under warmup + cosine.

Run:  python examples/lra/train_retrieval_torch.py --epochs 10
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

VOCAB = 64


def _markov_chain(rng):
    """Row-stochastic transition matrix with sparse support (article style)."""
    trans = rng.dirichlet(np.full(VOCAB, 0.05), size=VOCAB)
    return trans.astype(np.float64)


def _sample_seq(rng, trans, l):
    seq = np.empty(l, np.int32)
    s = int(rng.integers(VOCAB))
    for i in range(l):
        seq[i] = s
        s = int(rng.choice(VOCAB, p=trans[s]))
    return seq


def _noisy(rng, seq, rate):
    out = seq.copy()
    mask = rng.random(len(seq)) < rate
    out[mask] = rng.integers(0, VOCAB, mask.sum())
    return out


def build_dataset(n_pairs: int, l: int, seed: int, noise: float = 0.3, n_chains: int = 8):
    """Returns (x1, x2, y): two (n, l) documents per pair and a 0/1 label.
    Negatives come from the same chain as their first document (hard
    negatives)."""
    rng = np.random.default_rng(seed)
    chains = [_markov_chain(rng) for _ in range(n_chains)]
    x1 = np.empty((n_pairs, l), np.int32)
    x2 = np.empty((n_pairs, l), np.int32)
    y = np.empty((n_pairs,), np.int32)
    for i in range(n_pairs):
        label = i % 2
        c = chains[int(rng.integers(n_chains))]
        src = _sample_seq(rng, c, l)
        if label:
            a, b = _noisy(rng, src, noise), _noisy(rng, src, noise)
        else:
            other = _sample_seq(rng, c, l)
            a, b = _noisy(rng, src, noise), _noisy(rng, other, noise)
        x1[i], x2[i], y[i] = a, b, label
    perm = rng.permutation(n_pairs)
    return x1[perm], x2[perm], y[perm]


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", default=2e-3, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--n_layers", default=4, type=int)
    p.add_argument("--d_model", default=96, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--warmup-steps", default=500, type=int)
    p.add_argument("--noise", default=0.3, type=float)
    p.add_argument("--n-train", default=8000, type=int)
    p.add_argument("--n-val", default=1000, type=int)
    p.add_argument("--l-max", default=1024, type=int)
    p.add_argument("--data-cache", default="examples/lra/data/retrieval.npz")
    p.add_argument("--ckpt-dir", default="./checkpoint/retrieval")
    p.add_argument("--log-file", default="")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_retrieval_torch.py: CUDA is not available; pass --device cpu to run "
                 "on the CPU")
    from flashfftconv_tpu_torch.models.sequence import SequenceModel
    from flashfftconv_tpu_torch.utils.logging import MetricLogger
    from flashfftconv_tpu_torch.utils.optim import (
        adamw,
        cosine_decay_schedule,
        warmup_cosine_decay_schedule,
    )
    from flashfftconv_tpu_torch.utils.tasks import get_task
    from flashfftconv_tpu_torch.utils.train import (
        auto_save_on_exception,
        create_train_state,
        evaluate,
        make_train_step,
        save_checkpoint,
    )

    device = torch.device(args.device)
    if os.path.exists(args.data_cache):
        z = np.load(args.data_cache)
        x1, x2, y = z["x1"], z["x2"], z["y"]
    else:
        t0 = time.time()
        x1, x2, y = build_dataset(args.n_train + args.n_val, args.l_max, args.seed,
                                  noise=args.noise)
        os.makedirs(os.path.dirname(args.data_cache) or ".", exist_ok=True)
        np.savez_compressed(args.data_cache, x1=x1, x2=x2, y=y)
        print(f"generated {len(y)} pairs in {time.time() - t0:.0f}s", flush=True)
    tr = slice(0, args.n_train)
    va = slice(args.n_train, args.n_train + args.n_val)
    steps_per_epoch = args.n_train // args.batch_size
    print(f"train {x1[tr].shape} x2, val {x1[va].shape}, {steps_per_epoch} steps/epoch",
          flush=True)

    torch.manual_seed(args.seed)  # dropout
    model = SequenceModel(
        d_model=args.d_model, n_layers=args.n_layers,
        layer={"mixer": "long-conv", "mixer_kwargs": {"l_max": args.l_max, "lam": 0.001}},
        encoder="embedding", decoder={"_name_": "retrieval", "n_classes": 2, "mode": "mean"},
        n_tokens=VOCAB, l_max=args.l_max, dropout=args.dropout, dtype=torch.bfloat16,
        device=device, generator=torch.Generator().manual_seed(args.seed),
    ).train()
    task = get_task("classification")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params", flush=True)

    total = args.epochs * steps_per_epoch
    if args.warmup_steps:
        sched = warmup_cosine_decay_schedule(0.0, args.lr, args.warmup_steps,
                                             max(total, args.warmup_steps + 1))
    else:
        sched = cosine_decay_schedule(args.lr, total)
    opt, lr_sched = adamw(model.parameters(), sched, weight_decay=args.weight_decay)
    state = create_train_state(model, opt, lr_sched)

    def loss_fn(logits, labels):
        return task.loss(logits, labels), {"acc": task.metrics["acc"](logits.detach(), labels)}

    train_step = make_train_step(model, opt, lr_sched, clip=math.inf, loss_fn=loss_fn)

    @torch.no_grad()
    def eval_step(batch):
        # (a, b, labels, w): w masks the rows evaluate() pads
        a, b, labels, w = batch
        model.eval()
        try:
            pred = model(torch.cat([a, b], dim=0)).argmax(-1)
        finally:
            model.train()
        return {"correct": ((pred == labels).float() * w).sum(), "total": w.sum()}

    def rows(a, idx):
        return torch.from_numpy(a[idx]).to(device).long()

    data_rng = np.random.default_rng(args.seed)
    logger = MetricLogger(args.log_file) if args.log_file else None
    best_acc = 0.0
    guard = auto_save_on_exception(os.path.dirname(os.path.abspath(args.ckpt_dir)))
    with guard:
        for epoch in range(args.epochs):
            t0 = time.time()
            perm = data_rng.permutation(args.n_train)
            tot_loss = tot_acc = 0.0
            for i in range(steps_per_epoch):
                idx = perm[i * args.batch_size : (i + 1) * args.batch_size]
                # the two towers stacked: (2B, L)
                m = train_step(torch.cat([rows(x1[tr], idx), rows(x2[tr], idx)], dim=0),
                               rows(y[tr], idx))
                state.step += 1
                tot_loss += float(m["loss"])
                tot_acc += float(m["acc"])
            guard.track(state, extra={"epoch": epoch, "acc": best_acc})

            correct, total = evaluate(eval_step, (x1[va], x2[va], y[va]), args.batch_size,
                                      device)
            acc = 100.0 * correct / total
            epoch_s = time.time() - t0
            print(f"epoch {epoch}: train loss {tot_loss / steps_per_epoch:.3f} "
                  f"acc {100 * tot_acc / steps_per_epoch:.2f}% | val acc {acc:.2f}% "
                  f"| {epoch_s:.1f}s", flush=True)
            if logger:
                logger.log({"epoch": epoch, "train_loss": tot_loss / steps_per_epoch,
                            "train_acc": 100 * tot_acc / steps_per_epoch, "val_acc": acc,
                            "epoch_s": epoch_s}, step=epoch)
            if acc > best_acc:
                best_acc = acc
                save_checkpoint(os.path.abspath(args.ckpt_dir), state,
                                {"epoch": epoch, "acc": acc})
    print(f"best val acc: {best_acc:.2f}%", flush=True)


if __name__ == "__main__":
    main()
