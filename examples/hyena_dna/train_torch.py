"""HyenaDNA: genomics language modelling at long sequence lengths with the PyTorch port.

The port's counterpart of ``examples/hyena_dna/train.py``: the reference
model presets (``--model``, ``large-1m`` the 1M-base model), character-level
DNA ids (A/C/G/T/N), a FASTA file or the synthetic genome with planted
motifs, the forward-throughput benchmark (tokens/ms, seqs/s) and training
with the examples/hyena_dna recipe (clip 1.0, AdamW at a constant lr, weight
decay 0.1, dropout off), reported in bits per base. On the card the long
convs at FFT sizes 65,536 and up run the port's long-ladder kernels.

The memory levers are the JAX script's, as the port's ``ConvLMHeadModel``
and ``HyenaOperator`` take them. Its ``--scan-blocks`` and ``--no-lhs`` set
how XLA schedules the step and have no counterpart here (PyTorch's backward
already frees one block's activations before the next). The port plans
every long conv at 2 * l_max, so l_max must be a power of two.

Run:  python examples/hyena_dna/train_torch.py --l_max 16384 --steps 20
      python examples/hyena_dna/train_torch.py --benchmark --model large-1m
      python examples/hyena_dna/train_torch.py --model large-1m --remat --steps 4
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

from flashfftconv_tpu_torch.models.dna import DNA_VOCAB, MODEL_CONFIGS, synthetic_genome


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="", choices=[""] + list(MODEL_CONFIGS),
                   help="reference config preset; overrides d_model/n_layer/l_max")
    p.add_argument("--d_model", default=128, type=int)
    p.add_argument("--n_layer", default=2, type=int)
    p.add_argument("--l_max", default=16384, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--steps", default=20, type=int)
    p.add_argument("--lr", default=6e-4, type=float)
    p.add_argument("--fasta", default="", help="path to a FASTA file")
    p.add_argument("--benchmark", action="store_true", help="fwd-only tokens/ms")
    p.add_argument("--impl", default="auto", choices=["auto", "cuda", "plain", "fft"],
                   help="long-conv route (the JAX script's 'xla' is 'plain' here)")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing per block (for 1M training)")
    p.add_argument("--conv-h-chunks", default=0, type=int,
                   help="the long conv in N sequential channel blocks (exact)")
    p.add_argument("--proj-l-chunks", default=0, type=int,
                   help="L-chunked in_proj/short-filter/out_proj in the mixer (exact)")
    p.add_argument("--mlp-l-chunks", default=0, type=int, help="L-chunked MLP (exact)")
    p.add_argument("--short-filter-impl", default="", choices=["", "auto", "cuda", "plain"],
                   help="route of the short depthwise conv")
    p.add_argument("--bf16-filter", action="store_true",
                   help="cast the implicit filter's output (and cotangent) to bf16")
    p.add_argument("--bf16-filter-mlp", action="store_true",
                   help="run the implicit filter MLP in bf16 (parameters stay f32)")
    p.add_argument("--inner-remat", action="store_true",
                   help="remat the mixer and the MLP as separate regions in each block")
    p.add_argument("--bf16-residual", action="store_true",
                   help="carry the residual stream in bf16 instead of f32")
    p.add_argument("--bf16-ln-f", action="store_true", help="bf16 final layer norm")
    p.add_argument("--log-file", default="", help="JSONL metrics artifact path")
    p.add_argument("--time-steps", action="store_true",
                   help="report every step's wall time and the train-step peak memory")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.model:
        # the preset fills fields left at their defaults; explicit flags win
        for k, v in MODEL_CONFIGS[args.model].items():
            if getattr(args, k) == p.get_default(k):
                setattr(args, k, v)
    return args


def load_genome(args) -> np.ndarray:
    """The FASTA file's bases as ids (N for anything but ACGT), or the
    synthetic genome of ``args.seed``."""
    if args.fasta and os.path.exists(args.fasta):
        seq = []
        with open(args.fasta) as f:
            for line in f:
                if not line.startswith(">"):
                    seq.append(line.strip().upper())
        return np.asarray([DNA_VOCAB.get(c, 4) for c in "".join(seq)], np.int32)
    return synthetic_genome(args.seed)


def main(argv=None):
    args = get_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("train_torch.py: CUDA is not available; pass --device cpu to run on the CPU")
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.benchmarking import benchmark_forward
    from flashfftconv_tpu_torch.utils.data import lm_batches
    from flashfftconv_tpu_torch.utils.logging import MetricLogger
    from flashfftconv_tpu_torch.utils.train import (
        create_train_state,
        dna_optimizer,
        make_train_step,
    )

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    genome = load_genome(args)
    print(f"genome: {len(genome):,} bases", flush=True)

    filter_args = {"emb_dim": 5, **({"mlp_dtype": torch.bfloat16} if args.bf16_filter_mlp else {})}
    model = ConvLMHeadModel(
        d_model=args.d_model, n_layer=args.n_layer, d_inner=4 * args.d_model,
        vocab_size=len(DNA_VOCAB), l_max=args.l_max, mixer="hyena",
        mixer_kwargs={"impl": args.impl, "filter_args": filter_args,
                      "conv_h_chunks": args.conv_h_chunks,
                      "proj_l_chunks": args.proj_l_chunks,
                      "short_filter_impl": args.short_filter_impl or None,
                      "filter_output_dtype": torch.bfloat16 if args.bf16_filter else None},
        remat=args.remat, mlp_l_chunks=args.mlp_l_chunks,
        residual_f32=not args.bf16_residual, inner_remat=args.inner_remat,
        ln_f_f32=not args.bf16_ln_f, dtype=torch.bfloat16, pad_vocab_size_multiple=8,
        device=device, generator=torch.Generator().manual_seed(args.seed),
    ).eval()  # the example trains with dropout off
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params @ L={args.l_max}", flush=True)
    logger = MetricLogger(args.log_file) if args.log_file else None
    config = dict(model=args.model or "custom", d_model=args.d_model, n_layer=args.n_layer,
                  l_max=args.l_max, B=args.batch_size, n_params=int(n_params), impl=args.impl,
                  remat=args.remat, device=args.device)
    toks = args.batch_size * args.l_max
    batches = lm_batches(genome, args.batch_size, args.l_max, np.random.default_rng(args.seed))

    if args.benchmark:
        ids = torch.from_numpy(next(batches)[0]).to(device).long()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        ms = benchmark_forward(model, ids, repeats=10, device=device)
        peak = (f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MB" if cuda
                else "not measured on the CPU")
        print(f"fwd: {ms:.2f} ms | {toks / ms:.1f} tokens/ms | "
              f"{args.batch_size / (ms / 1e3):.2f} seqs/s | peak {peak}", flush=True)
        if logger:
            logger.log({**config, "mode": "fwd_benchmark", "fwd_ms": ms,
                        "tokens_per_ms": toks / ms,
                        "seqs_per_s": args.batch_size / (ms / 1e3)})
        return

    opt = dna_optimizer(model, lr=args.lr)
    state = create_train_state(model, opt)
    step_fn = make_train_step(model, opt, clip=1.0)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_prev = time.perf_counter()
    for step in range(args.steps):
        x, y = (torch.from_numpy(a).to(device).long() for a in next(batches))
        loss = float(step_fn(x, y)["loss"])  # waits for the step
        state.step += 1
        dt = time.perf_counter() - t_prev
        t_prev = time.perf_counter()
        if args.time_steps and step == 0:
            peak = (f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MB" if cuda
                    else "not measured on the CPU")
            print(f"train-step peak memory: {peak}", flush=True)
        if step % 5 == 0 or step == args.steps - 1 or args.time_steps:
            print(f"step {step}: loss {loss:.4f} (bits/base {loss / math.log(2):.3f}) "
                  f"{dt:.2f} s/step {toks / dt:.0f} tokens/s", flush=True)
        if logger:
            rec = {"loss": loss, "bits_per_base": loss / math.log(2), "step_s": dt,
                   "tokens_per_s": toks / dt}
            if step == 0:
                rec.update(config, mode="train", first_step_s=dt)
            logger.log(rec, step=step)


if __name__ == "__main__":
    main()
