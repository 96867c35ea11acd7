"""ETT-protocol multi-horizon forecasting with the SequenceModel harness, on the PyTorch port.

The port's counterpart of ``examples/forecasting/train_ett.py``. The series
is the JAX script's generated stand-in for ETTh (one seed, the same data):
7 correlated hourly channels of daily and weekly seasonality, a slow trend
and channel-mixed AR(2) noise. The model reads --l-max steps and predicts
the next --horizon steps of every channel (MSE; MAE reported), with a 75/25
train/validation split in time. A seasonal-naive baseline (y[t+h] =
y[t+h-168]) is printed beside it.

Drives ``SequenceModel`` with a linear encoder, long-conv mixer blocks, the
'last' decoder emitting (B, horizon, C), and
``utils.tasks.get_task("forecasting")``, with AdamW under a cosine decay.

Run:  python examples/forecasting/train_ett_torch.py --epochs 10
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

N_CHANNELS = 7
WEEK = 168  # hours


def build_series(n_steps: int, seed: int):
    """(n_steps, 7) standardized synthetic ETT-like series."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_steps)
    base = np.zeros((n_steps, N_CHANNELS))
    for c in range(N_CHANNELS):
        daily = rng.uniform(0.5, 2.0) * np.sin(2 * np.pi * (t + rng.uniform(0, 24)) / 24)
        weekly = rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (t + rng.uniform(0, WEEK)) / WEEK)
        trend = rng.uniform(-1.0, 1.0) * t / n_steps
        base[:, c] = daily + weekly + trend
    # channel-mixed AR(2) noise: shared shocks make channels correlated
    mix = rng.standard_normal((N_CHANNELS, N_CHANNELS)) * 0.3 + np.eye(N_CHANNELS)
    e = rng.standard_normal((n_steps, N_CHANNELS)) @ mix.T
    ar = np.zeros_like(e)
    for i in range(2, n_steps):
        ar[i] = 0.6 * ar[i - 1] - 0.2 * ar[i - 2] + 0.3 * e[i]
    x = base + ar
    return ((x - x.mean(0)) / (x.std(0) + 1e-8)).astype(np.float32)


def make_windows(series, l_in: int, horizon: int, stride: int = 1):
    n = (len(series) - l_in - horizon) // stride + 1
    xs = np.stack([series[i * stride : i * stride + l_in] for i in range(n)])
    ys = np.stack([series[i * stride + l_in : i * stride + l_in + horizon] for i in range(n)])
    return xs, ys


def seasonal_naive_mse(series, l_in: int, horizon: int, start: int):
    """y_hat[t+h] = y[t+h-WEEK]: the no-model yardstick."""
    errs = []
    for i in range(start, len(series) - l_in - horizon, 37):
        tgt = series[i + l_in : i + l_in + horizon]
        prd = series[i + l_in - WEEK : i + l_in - WEEK + horizon]
        errs.append(((tgt - prd) ** 2).mean())
    return float(np.mean(errs))


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--n_layers", default=4, type=int)
    p.add_argument("--d_model", default=64, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--n-steps", default=12000, type=int)
    p.add_argument("--l-max", default=512, type=int)
    p.add_argument("--horizon", default=96, type=int)
    p.add_argument("--ckpt-dir", default="./checkpoint/ett")
    p.add_argument("--log-file", default="")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_ett_torch.py: CUDA is not available; pass --device cpu to run on the CPU")
    from flashfftconv_tpu_torch.models.sequence import SequenceModel
    from flashfftconv_tpu_torch.utils.logging import MetricLogger
    from flashfftconv_tpu_torch.utils.optim import adamw, cosine_decay_schedule
    from flashfftconv_tpu_torch.utils.tasks import get_task
    from flashfftconv_tpu_torch.utils.train import (
        auto_save_on_exception,
        create_train_state,
        make_train_step,
        save_checkpoint,
    )

    device = torch.device(args.device)
    series = build_series(args.n_steps, args.seed)
    split = int(len(series) * 0.75)
    train_x, train_y = make_windows(series[:split], args.l_max, args.horizon, stride=3)
    val_x, val_y = make_windows(series[split:], args.l_max, args.horizon, stride=7)
    steps_per_epoch = len(train_x) // args.batch_size
    naive = seasonal_naive_mse(series, args.l_max, args.horizon, split)
    print(f"train {train_x.shape}->{train_y.shape}, val {val_x.shape}, "
          f"{steps_per_epoch} steps/epoch | seasonal-naive val mse {naive:.4f}", flush=True)
    if len(val_x) < args.batch_size:
        raise SystemExit(f"the validation split ({len(val_x)} windows) is smaller than a batch")

    task = get_task("forecasting")
    torch.manual_seed(args.seed)  # dropout
    model = SequenceModel(
        d_model=args.d_model, n_layers=args.n_layers,
        layer={"mixer": "long-conv", "mixer_kwargs": {"l_max": args.l_max, "lam": 0.0}},
        encoder="linear",
        decoder={"_name_": "sequence", "mode": "last", "l_output": args.horizon,
                 "d_output": N_CHANNELS},
        l_max=args.l_max, dropout=args.dropout, dtype=torch.float32, d_input=N_CHANNELS,
        device=device, generator=torch.Generator().manual_seed(args.seed),
    ).train()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params", flush=True)

    opt, sched = adamw(model.parameters(),
                       cosine_decay_schedule(args.lr, args.epochs * steps_per_epoch),
                       weight_decay=args.weight_decay)
    state = create_train_state(model, opt, sched)
    train_step = make_train_step(model, opt, sched, clip=math.inf, loss_fn=task.loss)

    @torch.no_grad()
    def eval_step(xs, ys):
        model.eval()
        try:
            pred = model(xs)
        finally:
            model.train()
        return {k: float(f(pred, ys)) for k, f in task.metrics.items()}

    data_rng = np.random.default_rng(args.seed)
    logger = MetricLogger(args.log_file) if args.log_file else None
    best_mse = float("inf")
    guard = auto_save_on_exception(os.path.dirname(os.path.abspath(args.ckpt_dir)))
    with guard:
        for epoch in range(args.epochs):
            t0 = time.time()
            perm = data_rng.permutation(len(train_x))
            tot = 0.0
            for i in range(steps_per_epoch):
                idx = perm[i * args.batch_size : (i + 1) * args.batch_size]
                m = train_step(torch.from_numpy(train_x[idx]).to(device),
                               torch.from_numpy(train_y[idx]).to(device))
                state.step += 1
                tot += float(m["loss"])
            guard.track(state, extra={"epoch": epoch})

            # Whole batches only: a mean squared error needs no padded rows.
            mses, maes = [], []
            for i in range(0, len(val_x) - args.batch_size + 1, args.batch_size):
                m = eval_step(torch.from_numpy(val_x[i : i + args.batch_size]).to(device),
                              torch.from_numpy(val_y[i : i + args.batch_size]).to(device))
                mses.append(m["mse"])
                maes.append(m["mae"])
            mse, mae = float(np.mean(mses)), float(np.mean(maes))
            epoch_s = time.time() - t0
            print(f"epoch {epoch}: train mse {tot / steps_per_epoch:.4f} | val mse {mse:.4f} "
                  f"mae {mae:.4f} (naive {naive:.4f}) | {epoch_s:.1f}s", flush=True)
            if logger:
                logger.log({"epoch": epoch, "train_mse": tot / steps_per_epoch, "val_mse": mse,
                            "val_mae": mae, "naive_mse": naive, "epoch_s": epoch_s}, step=epoch)
            if mse < best_mse:
                best_mse = mse
                save_checkpoint(os.path.abspath(args.ckpt_dir), state, {"epoch": epoch,
                                                                        "mse": mse})
    print(f"best val mse: {best_mse:.4f} (seasonal-naive {naive:.4f})", flush=True)


if __name__ == "__main__":
    main()
