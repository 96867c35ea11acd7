"""Context-parallel training of a tiny Hyena LM at very long lengths, on the
PyTorch port: the sequence sharded over the ranks of a mesh.

The port's counterpart of ``examples/seq_parallel/train_ultra_long.py``. The
model is the JAX script's ``TinyHyenaLM`` (an embedding, n_layers residual
blocks of LayerNorm -> HyenaOperator of order 2 with an f32 conv, a final
LayerNorm and a Dense head), and every mixer's long conv runs through
``parallel/seq_conv.py`` over the ``sp`` dimension of a (``dp``, ``sp``)
mesh: each rank holds L / sp tokens of each sequence and the batch is split
over ``dp``. The task is the JAX script's byte-level LM on sequences whose
second half repeats the first (``make_batch``), one fixed batch; the
optimizer is its AdamW (optax's defaults: weight decay 1e-4).

One process is one rank. Alone it is a mesh of one rank, over a process
group it makes in memory; under torchrun (RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT set) it joins the group torchrun describes, one card a rank.

Run:  python examples/seq_parallel/train_ultra_long_torch.py --l-max 2097152 --steps 3
      torchrun --nproc-per-node 4 examples/seq_parallel/train_ultra_long_torch.py --sp 4
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
import torch.distributed as dist


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--l-max", type=int, default=8192)
    p.add_argument("--d_model", type=int, default=32)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--sp", type=int, default=0, help="sequence-axis size; 0 = all ranks")
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def make_batch(rng, b, l, vocab):
    """Byte sequences with long-range copies: the second half repeats the
    first half's motifs, so a model that can see across the whole context
    predicts it near-perfectly. Returns (x, y) both of length l."""
    motif = rng.integers(1, vocab, size=(b, l // 2 + 1), dtype=np.int32)
    seq = np.concatenate([motif, motif], axis=1)  # length l + 2
    return seq[:, :l], seq[:, 1 : l + 1]


class TinyHyenaLM(torch.nn.Module):
    """The JAX script's TinyHyenaLM: f32 embedding, n_layers x (LayerNorm ->
    HyenaOperator(order 2, filter_order 16, f32 conv) -> +residual), final
    LayerNorm, Dense head to the vocabulary."""

    def __init__(self, vocab, d_model, n_layers, l_max, mesh, device, generator):
        super().__init__()
        from flashfftconv_tpu_torch.models.hyena import HyenaOperator
        from flashfftconv_tpu_torch.models.layers import Dense, Embed, LayerNorm

        self.embed = Embed(vocab, d_model, dtype=torch.float32, device=device,
                           generator=generator)
        # flax's LayerNorm: epsilon 1e-6
        self.norm = torch.nn.ModuleList(LayerNorm(d_model, eps=1e-6, device=device)
                                        for _ in range(n_layers))
        self.mixer = torch.nn.ModuleList(
            HyenaOperator(d_model, l_max, order=2, filter_order=16, conv_dtype=torch.float32,
                          seq_mesh=mesh, seq_axis="sp", device=device, generator=generator)
            for _ in range(n_layers))
        self.norm_f = LayerNorm(d_model, eps=1e-6, device=device)
        self.head = Dense(d_model, vocab, dtype=torch.float32, device=device,
                          generator=generator)

    def forward(self, ids):
        h = self.embed(ids)
        for norm, mixer in zip(self.norm, self.mixer):
            h = h + mixer(norm(h))
        return self.head(self.norm_f(h))


def _init_group(device):
    """Join torchrun's process group, or make a one-rank group in memory."""
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    else:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_ultra_long_torch.py: CUDA is not available; pass --device cpu to run "
                 "on the CPU")
    from flashfftconv_tpu_torch.parallel.mesh import Sharding, make_mesh, mesh_axes
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy
    from flashfftconv_tpu_torch.utils.train import make_train_step

    device = torch.device(args.device)
    _init_group(device)
    try:
        n_dev = dist.get_world_size()
        sp = args.sp or n_dev
        mesh = make_mesh((n_dev // sp, sp), ("dp", "sp"), device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        print(f"mesh: {mesh_axes(mesh)}, devices: {n_dev}", flush=True)
        l = args.l_max
        model = TinyHyenaLM(args.vocab, args.d_model, args.n_layers, l, mesh, device,
                            torch.Generator().manual_seed(args.seed))
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model: {n_params / 1e3:.1f}K params, L={l}", flush=True)
        # optax.adamw's defaults: betas 0.9/0.999, eps 1e-8, weight decay 1e-4
        opt = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4)
        step = make_train_step(model, opt, clip=math.inf, loss_fn=cross_entropy, mesh=mesh)

        xb, yb = make_batch(np.random.default_rng(args.seed), args.batch_size, l, args.vocab)
        seq = Sharding(mesh, ("dp", "sp"))  # this rank's rows, and its chunk of each
        x, y = (seq.local(torch.from_numpy(a).long()).to(device) for a in (xb, yb))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for i in range(args.steps):
            t0 = time.time()
            loss = float(step(x, y)["loss"])  # waits for the step
            dt = time.time() - t0
            print(f"step {i}: loss {loss:.4f} ({dt:.2f}s, "
                  f"{args.batch_size * l / max(dt, 1e-9):.0f} tok/s)", flush=True)
        if device.type == "cuda":
            print(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
        print(f"final loss: {loss:.4f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
