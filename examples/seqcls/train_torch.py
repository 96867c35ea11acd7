"""Byte-sequence classification with the LongConv model, on the PyTorch port.

The port's counterpart of ``examples/seqcls/train.py``: the same model and
protocol as sCIFAR (LongConv stack, per-parameter lr groups, bf16 conv,
AdamW + cosine, L=1024 sequences) on a real dataset that is on every
machine: 1024-byte fragments of local files, labelled by file type (python /
c headers / json / prose / shell / elf). ``build_dataset`` is the JAX
script's (the same globs, file order and seed give the same dataset); a
class whose roots hold no fragment stops it with an error that names the
class. Each byte, scaled to [-0.5, 0.5], is one input channel.

Run:  python examples/seqcls/train_torch.py --epochs 10
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

SEQ_LEN = 1024

# label -> (glob roots, extensions)
CLASSES = [
    ("python", ["/usr/local/lib/python3.12", "/opt/venv/lib/python3.12/site-packages/numpy",
                "/opt/venv/lib/python3.12/site-packages/scipy"], (".py",)),
    ("c_header", ["/usr/include", "/usr/local/include"], (".h", ".hpp", ".c", ".cc")),
    ("json", ["/opt/venv", "/usr/share", "/etc"], (".json",)),
    ("prose", ["/usr/share/doc", "/usr/share/perl"], ("copyright", "README", ".txt")),
    ("shell", ["/etc", "/usr/bin", "/usr/share/bash-completion", "/usr/share"],
     (".sh", ".bash", ".conf", ".cfg", "rc")),
    ("elf", ["/usr/lib/x86_64-linux-gnu", "/usr/bin"], (".so", ".0", ".1", ".2")),
]


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--batch_size", default=96, type=int)
    p.add_argument("--n_layers", default=6, type=int)
    p.add_argument("--d_model", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--kernel_lr", default=1e-3, type=float)
    p.add_argument("--kernel_lam", default=0.001, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--per-class", default=4000, type=int, help="sequences per class")
    p.add_argument("--data-cache", default="examples/seqcls/data/seqcls.npz")
    p.add_argument("--ckpt-dir", default="./checkpoint/seqcls")
    p.add_argument("--log-file", default="")
    p.add_argument("--limit-batches", default=0, type=int)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_dataset(cache_path: str, per_class: int, seed: int):
    """(x, y) of real 1024-byte fragments from the local disk: up to 8
    windows a file, files in sorted glob order under each class's roots,
    per_class fragments a class, shuffled by the seed; cached as npz.
    Raises ValueError naming a class whose roots hold no fragment."""
    if os.path.exists(cache_path):
        z = np.load(cache_path)
        return z["x"], z["y"]
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for label, (name, roots, exts) in enumerate(CLASSES):
        frags = []
        for root in roots:
            if len(frags) >= per_class:
                break
            for path in sorted(glob.glob(os.path.join(root, "**/*"), recursive=True)):
                if not path.endswith(exts) or not os.path.isfile(path):
                    continue
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    continue
                nwin = min(len(data) // SEQ_LEN, 8)
                for w in range(nwin):
                    frags.append(np.frombuffer(data[w * SEQ_LEN : (w + 1) * SEQ_LEN], np.uint8))
                if len(frags) >= per_class:
                    break
        if not frags:
            raise ValueError(f"class {name}: no file of {exts} with {SEQ_LEN} bytes or more "
                             f"under {roots}")
        if len(frags) < per_class // 4:
            print(f"warning: class {name} has only {len(frags)} fragments")
        frags = frags[:per_class]
        xs.append(np.stack(frags))
        ys.append(np.full(len(frags), label, np.int32))
        print(f"class {name}: {len(frags)} fragments", flush=True)
    x = np.concatenate(xs).astype(np.uint8)
    y = np.concatenate(ys)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez_compressed(cache_path, x=x, y=y)
    print(f"dataset: {x.shape} -> {cache_path}", flush=True)
    return x, y


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
        make_eval_step,
        make_train_step,
        save_checkpoint,
    )

    device = torch.device(args.device)
    x, y = build_dataset(args.data_cache, args.per_class, args.seed)
    n_val = len(x) // 10
    # the normalised byte value as a single input channel, like sCIFAR grayscale
    val_x = (x[-n_val:, :, None].astype(np.float32) / 255.0) - 0.5
    val_y = y[-n_val:]
    train_x = (x[:-n_val, :, None].astype(np.float32) / 255.0) - 0.5
    train_y = y[:-n_val]
    steps_per_epoch = len(train_x) // args.batch_size
    if args.limit_batches:
        steps_per_epoch = min(steps_per_epoch, args.limit_batches)
    print(f"train {train_x.shape}, val {val_x.shape}, {steps_per_epoch} steps/epoch", flush=True)

    torch.manual_seed(args.seed)  # dropout
    model = LongConvModel(
        d_input=1, d_output=len(CLASSES), d_model=args.d_model, n_layers=args.n_layers,
        dropout=args.dropout, kernel_lam=args.kernel_lam, l_max=SEQ_LEN,
        conv_dtype=torch.bfloat16, device=device,
        generator=torch.Generator().manual_seed(args.seed),
    ).train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params", flush=True)

    opt, sched = make_optimizer(model, lr=args.lr, weight_decay=args.weight_decay,
                                special_lr=args.kernel_lr, epochs=args.epochs,
                                steps_per_epoch=steps_per_epoch)
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
                save_checkpoint(os.path.abspath(args.ckpt_dir), state,
                                {"epoch": epoch, "acc": acc})
    print(f"best val acc: {best_acc:.2f}%", flush=True)


if __name__ == "__main__":
    main()
