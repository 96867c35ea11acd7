"""Autoregressive generation for the conv LMs (PyTorch).

Port of the JAX package's ``utils/generation.py``: long-conv models have no
KV cache, so each step re-runs the forward over the fixed-size, right-padded
context window and samples the next token from the logits at the last
filled position. Sampling draws from an explicit ``torch.Generator``.

``generate_kv`` is the KV-cached loop of the attention LMs
(``models.gpt.GPTLMHeadModel``): one decode step a token, prompt tokens
included (they fill the cache), sampling only past the prompt.
"""

from __future__ import annotations

import torch


def sample_logits(logits, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                  generator: torch.Generator | None = None):
    """Greedy (temperature 0) or categorical sampling with optional top-k and
    nucleus top-p filtering, over the last axis of ``logits``."""
    if temperature == 0.0:
        return logits.argmax(-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = logits.sort(dim=-1).values[..., -top_k, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p > 0.0:
        sorted_logits = logits.sort(dim=-1).values  # ascending
        cum = sorted_logits.softmax(-1).cumsum(-1)
        # drop the low-probability tail whose cumulative mass stays below
        # 1 - top_p (the kept set always includes the argmax)
        kth_idx = (cum <= 1.0 - top_p).sum(-1, keepdim=True)
        thresh = sorted_logits.gather(-1, kth_idx)
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    probs = logits.softmax(-1).reshape(-1, logits.shape[-1])
    return torch.multinomial(probs, 1, generator=generator).reshape(logits.shape[:-1])


@torch.inference_mode()
def generate(model, input_ids: torch.Tensor, max_new_tokens: int, max_length: int,
             temperature: float = 1.0, top_k: int = 0,
             generator: torch.Generator | None = None,
             prompt_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Generate tokens autoregressively.

    input_ids (B, L0); the context is right-padded with zeros to max_length
    so every step runs the same forward shape. Row b's prompt is its first
    ``prompt_lengths[b]`` tokens (all L0 by default, as in the JAX package),
    so one batch can serve prompts of different lengths. Returns
    (B, max(prompt_lengths) + max_new_tokens); a token that would land past
    max_length is dropped.
    """
    b, l0 = input_ids.shape
    device = input_ids.device
    tokens = torch.zeros((b, max_length), dtype=input_ids.dtype, device=device)
    tokens[:, :l0] = input_ids
    if prompt_lengths is None:
        pos = torch.full((b,), l0, dtype=torch.long, device=device)
    else:
        pos = prompt_lengths.to(device=device, dtype=torch.long).clone()
        if pos.shape != (b,) or int(pos.min()) < 1 or int(pos.max()) > l0:
            raise ValueError(f"prompt_lengths must be (B,) in [1, {l0}], got {prompt_lengths}")
        keep = torch.arange(max_length, device=device)[None, :] < pos[:, None]
        tokens = tokens * keep
    end = int(pos.max()) + max_new_tokens
    rows = torch.arange(b, device=device)
    for _ in range(max_new_tokens):
        logits = model(tokens)
        last = logits[rows, (pos - 1).clamp(0, max_length - 1)]
        nxt = sample_logits(last, temperature, top_k, generator=generator).to(tokens.dtype)
        inside = pos < max_length
        tokens[rows[inside], pos[inside]] = nxt[inside]
        pos = pos + 1
    return tokens[:, :end]


@torch.inference_mode()
def generate_kv(model, input_ids: torch.Tensor, max_new_tokens: int, max_length: int,
                temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """KV-cached generation: ``model.step`` at positions 0 .. L0 + new - 2,
    each feeding the token at that position and sampling the next one past
    the prompt. input_ids (B, L0); max_length bounds the caches (and the
    positions), L0 + max_new_tokens <= max_length. The caches hold keys and
    values in the model's dtype, as in the JAX package. Returns
    (B, L0 + max_new_tokens)."""
    b, l0 = input_ids.shape
    if l0 + max_new_tokens > max_length:
        raise ValueError(f"{l0} prompt tokens + {max_new_tokens} new exceed max_length "
                         f"{max_length}")
    tokens = torch.zeros((b, max_length), dtype=input_ids.dtype, device=input_ids.device)
    tokens[:, :l0] = input_ids
    caches = model.init_cache(b, max_length)
    for pos in range(l0 - 1 + max_new_tokens):
        logits, caches = model.step(tokens[:, pos : pos + 1], caches, pos)
        if pos + 1 >= l0:
            nxt = sample_logits(logits[:, 0], temperature, top_k, top_p, generator)
            tokens[:, pos + 1] = nxt.to(tokens.dtype)
    return tokens[:, : l0 + max_new_tokens]
