"""LRA ListOps with the LongConv model, generated offline, on the PyTorch port.

The port's counterpart of ``examples/lra/train_listops.py``. ListOps (Nangia
& Bowman 2018; the Long Range Arena's "listops-1000") is a synthetic
dataset: nested prefix expressions over MAX / MIN / MED / SM (sum mod 10)
applied to digits, serialised with bracket tokens and classified by their
value (10 classes). The generator here is the JAX script's, so one seed
gives the same dataset in both. Sequences are token ids (vocab 16),
right-padded to --l-max; the model pools over the non-pad positions.
Training is the example's (AdamW, the long-conv kernels at their own lr
without decay, warmup + cosine, no clipping); the validation accuracy is
counted over every validation row, and the best epoch is checkpointed.

Run:  python examples/lra/train_listops_torch.py --epochs 20
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
import torch.nn.functional as F

OPS = ["MAX", "MIN", "MED", "SM"]
# Vocab: 0 pad, 1 "[MAX" .. 4 "[SM", 5 "]", 6..15 digits 0..9.
PAD, CLOSE = 0, 5
VOCAB = 16


def _eval_op(op: int, args: list[int]) -> int:
    if op == 0:
        return max(args)
    if op == 1:
        return min(args)
    if op == 2:
        s = sorted(args)
        return s[(len(s) - 1) // 2]
    return sum(args) % 10


def _gen_tree(rng, depth: int, max_depth: int, max_args: int):
    """Returns (tokens, value): each child recurses with probability 0.25
    (below max_depth) and is a digit leaf otherwise, as LRA's generator."""
    op = int(rng.integers(4))
    n_args = int(rng.integers(2, max_args + 1))
    toks = [1 + op]
    vals = []
    for _ in range(n_args):
        if depth + 1 >= max_depth or rng.random() >= 0.25:
            d = int(rng.integers(10))
            toks.append(6 + d)
            vals.append(d)
        else:
            sub_t, sub_v = _gen_tree(rng, depth + 1, max_depth, max_args)
            toks.extend(sub_t)
            vals.append(sub_v)
    toks.append(CLOSE)
    return toks, _eval_op(op, vals)


def build_dataset(n: int, l_max: int, seed: int, min_len: int = 500, max_depth: int = 10,
                  max_args: int = 10):
    """n (x, y) pairs, x right-padded token ids of length l_max, each
    expression's length drawn by rejection into [min_len, l_max]."""
    if min_len > l_max:
        raise ValueError(f"min_len {min_len} > l_max {l_max}: no expression can qualify")
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, l_max), np.int32)
    ys = np.zeros((n,), np.int32)
    i = 0
    while i < n:
        toks, val = _gen_tree(rng, 0, max_depth, max_args)
        if not (min_len <= len(toks) <= l_max):
            continue
        xs[i, : len(toks)] = toks
        ys[i] = val
        i += 1
    return xs, ys


class ListOpsModel(torch.nn.Module):
    """The LongConvModel over token ids: one-hot over the vocabulary and a
    mean pool over the non-pad positions."""

    def __init__(self, **kwargs):
        super().__init__()
        from flashfftconv_tpu_torch.models.long_conv import LongConvModel

        self.model = LongConvModel(VOCAB, d_output=10, **kwargs)

    def forward(self, ids):
        return self.model(F.one_hot(ids.long(), VOCAB).float(), mask=ids != PAD)


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", default=4e-3, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--n_layers", default=6, type=int)
    p.add_argument("--d_model", default=128, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--kernel_lr", default=1e-3, type=float)
    p.add_argument("--kernel_lam", default=0.001, type=float)
    p.add_argument("--kernel_dropout", default=0.0, type=float,
                   help="dropout on the squashed conv kernel")
    p.add_argument("--warmup-steps", default=1000, type=int)
    p.add_argument("--prenorm", action="store_true", help="pre-norm residual blocks")
    p.add_argument("--conv-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="long-conv compute dtype")
    p.add_argument("--seed", default=0, type=int)
    # listops-1000 scale: 96K train / 2K val, lengths rejected to
    # [min-len, l-max] (LRA uses [500, 2000]; l-max 2048 keeps the conv
    # plan a power of two).
    p.add_argument("--n-train", default=96000, type=int)
    p.add_argument("--n-val", default=2000, type=int)
    p.add_argument("--min-len", default=500, type=int)
    p.add_argument("--l-max", default=2048, type=int)
    p.add_argument("--data-cache", default="examples/lra/data/listops_lra.npz")
    p.add_argument("--ckpt-dir", default="./checkpoint/listops")
    p.add_argument("--log-file", default="")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_listops_torch.py: CUDA is not available; pass --device cpu to run "
                 "on the CPU")
    from flashfftconv_tpu_torch.utils.logging import MetricLogger
    from flashfftconv_tpu_torch.utils.metrics import accuracy, cross_entropy
    from flashfftconv_tpu_torch.utils.optim import make_optimizer
    from flashfftconv_tpu_torch.utils.train import (
        auto_save_on_exception,
        create_train_state,
        evaluate,
        make_eval_step,
        make_train_step,
        save_checkpoint,
    )

    device = torch.device(args.device)
    if os.path.exists(args.data_cache):
        z = np.load(args.data_cache)
        x, y = z["x"], z["y"]
    else:
        t0 = time.time()
        x, y = build_dataset(args.n_train + args.n_val, args.l_max, args.seed,
                             min_len=args.min_len)
        os.makedirs(os.path.dirname(args.data_cache) or ".", exist_ok=True)
        np.savez_compressed(args.data_cache, x=x, y=y)
        print(f"generated {len(x)} sequences in {time.time() - t0:.0f}s", flush=True)
    train_x, train_y = x[: args.n_train], y[: args.n_train]
    val_x = x[args.n_train : args.n_train + args.n_val]
    val_y = y[args.n_train : args.n_train + args.n_val]
    steps_per_epoch = len(train_x) // args.batch_size
    print(f"train {train_x.shape}, val {val_x.shape}, {steps_per_epoch} steps/epoch", flush=True)

    torch.manual_seed(args.seed)  # dropout
    model = ListOpsModel(
        d_model=args.d_model, n_layers=args.n_layers, dropout=args.dropout,
        kernel_lam=args.kernel_lam, kernel_dropout=args.kernel_dropout, l_max=args.l_max,
        prenorm=args.prenorm, conv_dtype=getattr(torch, args.conv_dtype), device=device,
        generator=torch.Generator().manual_seed(args.seed),
    ).train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params", flush=True)

    opt, sched = make_optimizer(model.model, lr=args.lr, weight_decay=args.weight_decay,
                                special_lr=args.kernel_lr, epochs=args.epochs,
                                steps_per_epoch=steps_per_epoch,
                                warmup_steps=args.warmup_steps)
    state = create_train_state(model, opt, sched)

    def loss_fn(logits, labels):
        return cross_entropy(logits, labels), {"accuracy": accuracy(logits.detach(), labels)}

    train_step = make_train_step(model, opt, sched, clip=math.inf, loss_fn=loss_fn)
    eval_step = make_eval_step(model)
    data_rng = np.random.default_rng(args.seed)
    logger = MetricLogger(args.log_file) if args.log_file else None

    best_acc = 0.0
    guard = auto_save_on_exception(os.path.dirname(os.path.abspath(args.ckpt_dir)))
    with guard:
        for epoch in range(args.epochs):
            t0 = time.time()
            perm = data_rng.permutation(len(train_x))
            tot_loss = tot_acc = 0.0
            for i in range(steps_per_epoch):
                idx = perm[i * args.batch_size : (i + 1) * args.batch_size]
                m = train_step(torch.from_numpy(train_x[idx]).to(device).long(),
                               torch.from_numpy(train_y[idx]).to(device).long())
                state.step += 1
                tot_loss += float(m["loss"])
                tot_acc += float(m["accuracy"])
            guard.track(state, extra={"epoch": epoch, "acc": best_acc})

            correct, total = evaluate(eval_step, (val_x, val_y), args.batch_size, device)
            acc = 100.0 * correct / total
            epoch_s = time.time() - t0
            print(f"epoch {epoch}: train loss {tot_loss / steps_per_epoch:.3f} "
                  f"acc {100 * tot_acc / steps_per_epoch:.2f}% | val acc {acc:.2f}% | "
                  f"{epoch_s:.1f}s", flush=True)
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
