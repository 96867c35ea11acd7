"""Sequential CIFAR-10 with the LongConv model, on the PyTorch port.

The port's counterpart of ``examples/cifar/train.py``: the LongConvModel over
1024-step pixel sequences, AdamW + cosine schedule with a no-weight-decay
group for the conv kernels, a bf16 conv, checkpoint save and ``--resume``.

Data: the CIFAR-10 python pickles (``cifar-10-batches-py/data_batch_1`` ..
``_5``, the files torchvision's ``CIFAR10`` reads) under ``--data-dir``,
read with ``pickle`` and numpy into what the JAX script's torchvision path
gives: each image as 1024 steps of 3 channels in [0, 1] (or 1 with
``--grayscale``, PIL's integer luma), standardised per channel over the
whole set, the last tenth held out for validation. Nothing is downloaded:
without those files, or with ``--synthetic``, the JAX script's synthetic
set (class prototypes plus noise, from the seed) takes their place.

Run:  python examples/cifar/train_torch.py --epochs 2 --synthetic
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--batch_size", default=96, type=int)
    p.add_argument("--n_layers", default=6, type=int)
    p.add_argument("--d_model", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--kernel_dropout", default=0.2, type=float)
    p.add_argument("--kernel_lr", default=1e-3, type=float)
    p.add_argument("--kernel_lam", default=0.001, type=float)
    p.add_argument("--prenorm", action="store_true")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", "-r", action="store_true")
    p.add_argument("--data-dir", default="./data/cifar/")
    p.add_argument("--ckpt-dir", default="./checkpoint/cifar")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--limit-batches", default=0, type=int, help="debug: cap batches/epoch")
    p.add_argument("--log-file", default="", help="JSONL metrics log path")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def read_cifar_batches(data_dir: str, grayscale: bool = False):
    """(xs (N, 1024, C) float32 in [0, 1], ys (N,) int64) from the training
    pickles ``data_batch_1`` .. ``data_batch_5`` under
    ``data_dir/cifar-10-batches-py`` that exist, in order. Each pickle's
    ``data`` rows are 1024 red, 1024 green and 1024 blue bytes; grayscale is
    PIL's ``convert("L")``, (19595 R + 38470 G + 7471 B + 32768) >> 16.
    Raises FileNotFoundError when none exists."""
    root = os.path.join(data_dir, "cifar-10-batches-py")
    paths = [os.path.join(root, f"data_batch_{i}") for i in range(1, 6)]
    paths = [p for p in paths if os.path.isfile(p)]
    if not paths:
        raise FileNotFoundError(f"no data_batch_* pickle under {root}")
    data, labels = [], []
    for path in paths:
        with open(path, "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        data.append(np.asarray(entry["data"], np.uint8).reshape(-1, 3, 1024))
        labels.extend(entry["labels"] if "labels" in entry else entry["fine_labels"])
    rgb = np.concatenate(data)
    if grayscale:
        r, g, b = (rgb[:, c].astype(np.uint32) for c in range(3))
        rgb = ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)[:, None]
    xs = rgb.astype(np.float32).transpose(0, 2, 1) / 255
    return xs, np.asarray(labels)


def load_cifar(args):
    """(train_x, train_y, val_x, val_y) as flattened 1024-step sequences."""
    d_input = 1 if args.grayscale else 3
    if not args.synthetic:
        try:
            xs, ys = read_cifar_batches(args.data_dir, args.grayscale)
            mean = xs.mean((0, 1), keepdims=True)
            std = xs.std((0, 1), keepdims=True) + 1e-6
            xs = (xs - mean) / std
            n_val = len(xs) // 10
            return xs[:-n_val], ys[:-n_val], xs[-n_val:], ys[-n_val:]
        except (FileNotFoundError, pickle.UnpicklingError, KeyError) as e:
            print(f"CIFAR-10 unavailable ({e}); using synthetic data", flush=True)
    rng = np.random.default_rng(args.seed)
    n_train, n_val, n_cls = 4096, 512, 10
    protos = rng.standard_normal((n_cls, 1024, d_input)).astype(np.float32)
    ys = rng.integers(0, n_cls, n_train + n_val)
    xs = protos[ys] + 0.5 * rng.standard_normal(
        (n_train + n_val, 1024, d_input)
    ).astype(np.float32)
    return xs[:n_train], ys[:n_train], xs[n_train:], ys[n_train:]


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_torch.py: CUDA is not available; pass --device cpu to run on the CPU")
    from flashfftconv_tpu_torch.models.long_conv import LongConvModel
    from flashfftconv_tpu_torch.utils.logging import MetricLogger
    from flashfftconv_tpu_torch.utils.metrics import accuracy, cross_entropy
    from flashfftconv_tpu_torch.utils.optim import make_optimizer
    from flashfftconv_tpu_torch.utils.train import (
        auto_save_on_exception,
        create_train_state,
        evaluate,
        latest_checkpoint,
        make_eval_step,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )

    device = torch.device(args.device)
    train_x, train_y, val_x, val_y = load_cifar(args)
    d_input = train_x.shape[-1]
    steps_per_epoch = len(train_x) // args.batch_size
    if args.limit_batches:
        steps_per_epoch = min(steps_per_epoch, args.limit_batches)

    torch.manual_seed(args.seed)  # dropout
    model = LongConvModel(
        d_input=d_input, d_output=10, d_model=args.d_model, n_layers=args.n_layers,
        dropout=args.dropout, prenorm=args.prenorm, kernel_lam=args.kernel_lam,
        kernel_dropout=args.kernel_dropout, l_max=1024, conv_dtype=torch.bfloat16,
        device=device, generator=torch.Generator().manual_seed(args.seed),
    ).train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params", flush=True)

    opt, sched = make_optimizer(model, lr=args.lr, weight_decay=args.weight_decay,
                                special_lr=args.kernel_lr, epochs=args.epochs,
                                steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, opt, sched)

    ckpt_path = os.path.abspath(args.ckpt_dir)
    start_epoch, best_acc = 0, 0.0
    if args.resume:
        # the newer of the regular checkpoint and a crash-time auto-save
        newest = latest_checkpoint(os.path.dirname(ckpt_path), name=os.path.basename(ckpt_path))
        if newest:
            state, extra = restore_checkpoint(newest, state, {"epoch": 0, "acc": 0.0})
            start_epoch, best_acc = int(extra["epoch"]) + 1, float(extra["acc"])
            print(f"resumed {newest} from epoch {start_epoch - 1}, best acc {best_acc:.2f}",
                  flush=True)

    def loss_fn(logits, labels):
        return cross_entropy(logits, labels), {"accuracy": accuracy(logits.detach(), labels)}

    train_step = make_train_step(model, opt, sched, clip=math.inf, loss_fn=loss_fn)
    eval_step = make_eval_step(model)
    data_rng = np.random.default_rng(args.seed)
    logger = MetricLogger(args.log_file) if args.log_file else None

    guard = auto_save_on_exception(os.path.dirname(ckpt_path))
    with guard:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            perm = data_rng.permutation(len(train_x))
            tot_loss = tot_acc = 0.0
            for i in range(steps_per_epoch):
                idx = perm[i * args.batch_size : (i + 1) * args.batch_size]
                m = train_step(torch.from_numpy(train_x[idx]).to(device),
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
                save_checkpoint(ckpt_path, state, {"epoch": epoch, "acc": acc})
    print(f"best val acc: {best_acc:.2f}%", flush=True)


if __name__ == "__main__":
    main()
