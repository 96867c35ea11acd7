"""HyenaDNA on the port: presets, the synthetic genome and scoring.

Port of the JAX package's ``examples/hyena_dna/train.py`` without its
command line: the reference model presets (``MODEL_CONFIGS``),
character-level DNA ids (A/C/G/T/N), the synthetic genome with planted
motifs that stands in for a FASTA file, ``build_model`` (the example's
``ConvLMHeadModel`` arguments at their defaults: hyena mixer, filter
``emb_dim`` 5, vocabulary 5 padded to 8, f32 residual stream and final
LayerNorm, bf16 activations), ``score``, the serving entry point (mean
bits per base and the most likely next base of each request) and
``train_config``, the memory levers a preset's train step runs with on one
80 GB card. A train step is ``utils.train.make_train_step`` over
``utils.train.dna_optimizer`` on batches from ``utils.data.lm_batches``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel

DNA_VOCAB = {c: i for i, c in enumerate("ACGTN")}

# Reference model configs; "large-1m" is the 1M-base model (8 layers,
# d_model 256) whose long convs run at FFT size 2,097,152.
MODEL_CONFIGS = {
    "tiny-1k": dict(d_model=128, n_layer=2, l_max=1024),
    "tiny-16k-d128": dict(d_model=128, n_layer=2, l_max=16384),
    "small-32k": dict(d_model=256, n_layer=4, l_max=32768),
    "medium-160k": dict(d_model=256, n_layer=8, l_max=160_000),
    "medium-450k": dict(d_model=256, n_layer=8, l_max=450_000),
    "large-1m": dict(d_model=256, n_layer=8, l_max=1_048_576),
}


def synthetic_genome(seed: int = 0, n: int = 2_000_000) -> np.ndarray:
    """Random ACGT with 2000 planted copies of one 64-base motif, so that a
    model has long-range structure to learn; int32 ids, from ``seed``."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.int32)
    motif = rng.integers(0, 4, 64).astype(np.int32)
    for start in rng.integers(0, n - 64, 2000):
        g[start : start + 64] = motif
    return g


def train_config(name: str = "large-1m") -> dict:
    """The ``build_model`` overrides for training preset ``name`` at B = 1
    on one 80 GB H100: the fewest of the example's memory levers that fit.
    Up to 32768 bases none is needed; from 160,000 bases each block is
    rematerialised (``remat``), which at 1,048,576 bases keeps 8 block inputs
    of 0.5 GB and one block's activations live in place of eight blocks'."""
    return {"remat": True} if MODEL_CONFIGS[name]["l_max"] > 32768 else {}


def build_model(name: str = "large-1m", dtype: torch.dtype = torch.bfloat16, device="cuda",
                generator: torch.Generator | None = None, **overrides) -> ConvLMHeadModel:
    """The HyenaDNA LM of preset ``name`` (``overrides`` replace preset
    fields or any other ``ConvLMHeadModel`` argument, the memory levers of
    ``train_config`` and the mixer's, under ``mixer_kwargs``, among them).
    The long convs share one plan at FFT size 2 * l_max, so l_max must be a
    power of two here."""
    cfg = {**MODEL_CONFIGS[name], **overrides}
    d_model, l_max = cfg.pop("d_model"), cfg.pop("l_max")
    if l_max & (l_max - 1):
        raise NotImplementedError(
            f"l_max {l_max} is not a power of two: the port's plans are sized 2 * l_max"
        )
    mixer_kwargs = {"filter_args": {"emb_dim": 5}, **cfg.pop("mixer_kwargs", {})}
    cfg.setdefault("d_inner", 4 * d_model)
    return ConvLMHeadModel(
        d_model=d_model, vocab_size=len(DNA_VOCAB), l_max=l_max, mixer="hyena",
        mixer_kwargs=mixer_kwargs, pad_vocab_size_multiple=8, dtype=dtype, device=device,
        generator=generator, **cfg,
    )


def score(model: ConvLMHeadModel, ids: torch.Tensor) -> dict[str, torch.Tensor]:
    """Score requests ids (B, L) of DNA ids with one forward in eval mode
    (dropout off; the model's mode is restored), no grad.

    Returns ``bits_per_base`` (B,) f32, the mean over positions 1..L-1 of
    -log2 p(base | the bases before it); ``next_base`` (B,) int64, the most
    likely base (A, C, G, T or N) after the last position; and ``finite``,
    a scalar bool that is True when every logit is finite."""
    if ids.ndim != 2 or ids.shape[1] < 2:
        raise ValueError(f"ids must be (B, L >= 2), got shape {tuple(ids.shape)}")
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            logits = model(ids)
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            nll = -logp.gather(-1, ids[:, 1:, None].long())[..., 0]
            return {
                "bits_per_base": nll.mean(dim=1) / math.log(2.0),
                "next_base": logits[:, -1, : len(DNA_VOCAB)].argmax(dim=-1),
                "finite": torch.isfinite(logits).all(),
            }
    finally:
        model.train(was_training)
