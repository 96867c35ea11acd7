"""LRA Pathfinder-32 with the LongConv model, generated offline, on the PyTorch port.

The port's counterpart of ``examples/lra/train_pathfinder.py``. Pathfinder
(Linsley et al. 2018; LRA config "pathfinder32") is a synthetically
generated vision benchmark: a 32x32 grayscale image holds several dashed
curves ("snakes") and two bright endpoint markers, and the label is whether
the two markers lie on the same curve. The generator here is the JAX
script's, so one seed gives the same dataset in both: each snake a
constant-speed random walk with momentum, rendered dashed; positives mark
the two ends of one snake, negatives ends of two different snakes, with the
marker distance matched between the classes by rejection. The image is
flattened to an L=1024 intensity sequence (the LRA protocol) and classified
by the LongConv stack; training is the example's (AdamW, the long-conv
kernels at their own lr without decay, warmup + cosine, no clipping), the
validation accuracy is counted over every validation row, and the best
epoch is checkpointed.

Run:  python examples/lra/train_pathfinder_torch.py --epochs 20
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

SIDE = 32
PATH_VAL = 0.55  # dash intensity
MARK_VAL = 1.0   # endpoint marker intensity


def _snake(rng, n_steps: int):
    """Constant-speed random walk with momentum: (n_steps, 2) float points."""
    pos = np.array([rng.uniform(4, SIDE - 4), rng.uniform(4, SIDE - 4)])
    ang = rng.uniform(0, 2 * math.pi)
    pts = np.empty((n_steps, 2))
    for i in range(n_steps):
        pts[i] = pos
        ang += rng.normal(0.0, 0.35)
        step = np.array([math.cos(ang), math.sin(ang)])
        nxt = pos + step
        # reflect off the borders
        for d in range(2):
            if not (1.0 <= nxt[d] <= SIDE - 2.0):
                ang = math.pi - ang if d == 0 else -ang
                step = np.array([math.cos(ang), math.sin(ang)])
                nxt = pos + step
        pos = np.clip(nxt, 1.0, SIDE - 2.0)
    return pts


def _stamp(img, x, y, val, r=0):
    xi, yi = int(round(x)), int(round(y))
    lo_x, hi_x = max(xi - r, 0), min(xi + r + 1, SIDE)
    lo_y, hi_y = max(yi - r, 0), min(yi + r + 1, SIDE)
    img[lo_y:hi_y, lo_x:hi_x] = np.maximum(img[lo_y:hi_y, lo_x:hi_x], val)


def _render(rng, snakes):
    """Dash-render snakes: 3 px on, 2 px off (the dashed-contour look)."""
    img = np.zeros((SIDE, SIDE), np.float32)
    for pts in snakes:
        for i, (x, y) in enumerate(pts):
            if i % 5 < 3:
                _stamp(img, x, y, PATH_VAL)
    return img


def make_image(rng, positive: bool, n_snakes: int = 4, n_steps: int = 40,
               max_tries: int = 40):
    """One sample. Markers go on two snake endpoints; the classes' marker
    distance distributions are matched by rejecting negatives whose marker
    pair is much farther apart than a typical positive's."""
    for _ in range(max_tries):
        snakes = [_snake(rng, n_steps) for _ in range(n_snakes)]
        if positive:
            s = snakes[int(rng.integers(n_snakes))]
            a, b = s[0], s[-1]
        else:
            i, j = rng.choice(n_snakes, size=2, replace=False)
            ends_i = snakes[i][0] if rng.random() < 0.5 else snakes[i][-1]
            ends_j = snakes[j][0] if rng.random() < 0.5 else snakes[j][-1]
            a, b = ends_i, ends_j
        dist = float(np.hypot(*(a - b)))
        # typical same-snake end separation for this walk is ~4-20 px;
        # force both classes into the same band
        if not (3.0 <= dist <= 22.0):
            continue
        img = _render(rng, snakes)
        _stamp(img, a[0], a[1], MARK_VAL, r=1)
        _stamp(img, b[0], b[1], MARK_VAL, r=1)
        return img
    # fall back to whatever the last draw was (rare)
    img = _render(rng, snakes)
    _stamp(img, a[0], a[1], MARK_VAL, r=1)
    _stamp(img, b[0], b[1], MARK_VAL, r=1)
    return img


def build_dataset(n: int, seed: int):
    rng = np.random.default_rng(seed)
    xs = np.empty((n, SIDE * SIDE), np.float32)
    ys = np.empty((n,), np.int32)
    for i in range(n):
        label = i % 2
        xs[i] = make_image(rng, bool(label)).reshape(-1)
        ys[i] = label
    perm = rng.permutation(n)
    return xs[perm], ys[perm]


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
    p.add_argument("--warmup-steps", default=1000, type=int)
    p.add_argument("--prenorm", action="store_true", help="pre-norm residual blocks")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--n-train", default=40000, type=int)
    p.add_argument("--n-val", default=4000, type=int)
    p.add_argument("--data-cache", default="examples/lra/data/pathfinder32.npz")
    p.add_argument("--ckpt-dir", default="./checkpoint/pathfinder")
    p.add_argument("--log-file", default="")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_pathfinder_torch.py: CUDA is not available; pass --device cpu to run "
                 "on the CPU")
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
    if os.path.exists(args.data_cache):
        z = np.load(args.data_cache)
        x, y = z["x"], z["y"]
    else:
        t0 = time.time()
        x, y = build_dataset(args.n_train + args.n_val, args.seed)
        os.makedirs(os.path.dirname(args.data_cache) or ".", exist_ok=True)
        np.savez_compressed(args.data_cache, x=x, y=y)
        print(f"generated {len(x)} images in {time.time() - t0:.0f}s", flush=True)
    # one intensity channel a position: (N, 1024, 1)
    train_x, train_y = x[: args.n_train, :, None], y[: args.n_train]
    val_x, val_y = x[args.n_train :, :, None], y[args.n_train :]
    steps_per_epoch = len(train_x) // args.batch_size
    print(f"train {train_x.shape[:2]}, val {val_x.shape[:2]}, {steps_per_epoch} steps/epoch",
          flush=True)

    torch.manual_seed(args.seed)  # dropout
    model = LongConvModel(
        d_input=1, d_output=2, d_model=args.d_model, n_layers=args.n_layers,
        dropout=args.dropout, kernel_lam=args.kernel_lam, l_max=SIDE * SIDE,
        prenorm=args.prenorm, conv_dtype=torch.bfloat16, device=device,
        generator=torch.Generator().manual_seed(args.seed),
    ).train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params", flush=True)

    opt, sched = make_optimizer(model, lr=args.lr, weight_decay=args.weight_decay,
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
