"""String-keyed registry and config instantiation (PyTorch).

Port of the JAX package's ``utils/registry.py``: configs name components by
short ``_name_`` keys; ``instantiate`` resolves the name, merges the
config's keys with the call site's keywords (which win) and constructs the
object. The kinds and names are the JAX package's, pointing at the port's
modules, so a JAX config carries over; call-site keywords such as
``dtype=torch.bfloat16, device=..., generator=...`` reach the constructors.

Two kinds differ in how they are called. An ``"optimizer"`` needs the
parameters it updates, ``instantiate("optimizer", cfg, params=...)``, takes
optax's keyword names and defaults and returns ``(optimizer, scheduler)``
(``utils.optim``: a schedule as ``learning_rate`` becomes a ``LambdaLR``).
A ``"scheduler"`` is a step -> value function with optax's values.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

_M = "flashfftconv_tpu_torch.models"
_O = "flashfftconv_tpu_torch.utils.optim"

_REGISTRIES: dict[str, dict[str, str | Callable]] = {
    "layer": {
        "hyena": f"{_M}.hyena.HyenaOperator",
        "h3": f"{_M}.h3.H3Operator",
        "m2": f"{_M}.m2_bert.MonarchMixerSequenceMixing",
        "long-conv": f"{_M}.long_conv.LongConv",
        "hyena-filter": f"{_M}.filters.HyenaFilter",
        "mha": f"{_M}.attention.MHAOperator",
        "s4d-kernel": f"{_M}.ssm.S4DKernel",
        "long-conv-kernel": f"{_M}.h3.LongConvKernel",
        "block-fft": f"{_M}.ssm.BlockFFT",
    },
    "encoder": {
        "linear": f"{_M}.sequence.LinearEncoder",
        "embedding": f"{_M}.sequence.EmbeddingEncoder",
        "one-hot": f"{_M}.sequence.OneHotEncoder",
        "position": f"{_M}.sequence.PositionalEncoder",
        "patch2d": f"{_M}.sequence.PatchEncoder",
    },
    "decoder": {
        "sequence": f"{_M}.sequence.SequenceDecoder",
        "retrieval": f"{_M}.sequence.RetrievalDecoder",
    },
    "pool": {
        "avg": f"{_M}.sequence.DownAvgPool",
        "linear": f"{_M}.sequence.DownLinearPool",
        "up-linear": f"{_M}.sequence.UpLinearPool",
        "spectral": f"{_M}.sequence.DownSpectralPool",
    },
    "model": {
        "sequence": f"{_M}.sequence.SequenceModel",
        "lm": f"{_M}.lm.ConvLMHeadModel",
        "lm-backbone": f"{_M}.lm.LMBackbone",
        "long-conv-model": f"{_M}.long_conv.LongConvModel",
        "gpt": f"{_M}.gpt.GPTLMHeadModel",
        "opt": f"{_M}.gpt.opt_lm",
        "vit": f"{_M}.vit.VisionTransformer",
        "bert": f"{_M}.bert.M2BertForMaskedLM",
        "m2-bert": f"{_M}.bert.M2BertModel",
        "bert-attn": f"{_M}.bert.BertForMaskedLM",
        "bert-attn-model": f"{_M}.bert.BertModel",
    },
    "optimizer": {
        "adamw": f"{_O}.adamw",
        "adam": f"{_O}.adam",
        "sgd": f"{_O}.sgd",
        "lamb": f"{_O}.lamb",
    },
    "scheduler": {
        "cosine": f"{_O}.cosine_decay_schedule",
        "constant": f"{_O}.constant_schedule",
        "warmup-cosine": f"{_O}.warmup_cosine_decay_schedule",
        "linear": f"{_O}.linear_schedule",
        "exponential": f"{_O}.exponential_decay",
        "warmup-exponential": f"{_O}.warmup_exponential_decay_schedule",
        "sgdr": f"{_O}.sgdr_schedule",
        "piecewise": f"{_O}.piecewise_constant_schedule",
    },
}


def register(kind: str, name: str, target: str | Callable) -> None:
    _REGISTRIES.setdefault(kind, {})[name] = target


def lookup(kind: str, name: str) -> Callable:
    try:
        target = _REGISTRIES[kind][name]
    except KeyError:
        known = sorted(_REGISTRIES.get(kind, {}))
        raise KeyError(f"unknown {kind} {name!r}; known: {known}") from None
    if callable(target):
        return target
    module, attr = target.rsplit(".", 1)
    return getattr(importlib.import_module(module), attr)


def instantiate(kind: str, config: dict | str, **kwargs: Any):
    """Construct a registered component from a config dict with a ``_name_``
    key (the remaining keys become constructor keywords; call-site keywords
    win)."""
    if isinstance(config, str):
        config = {"_name_": config}
    cfg = dict(config)
    name = cfg.pop("_name_")
    return lookup(kind, name)(**{**cfg, **kwargs})
