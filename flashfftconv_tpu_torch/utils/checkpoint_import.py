"""Pretrained-checkpoint import: HyenaDNA, M2-BERT, GPT-2 and OPT state dicts -> the port's models.

The port's counterpart of the JAX package's ``utils/checkpoint_import.py``
(``normalize_state_dict``, ``hyenadna_to_flax``, ``merge_params``,
``ImportReport``): the reference HyenaDNA loader strips the ``model.``
prefix, undoes the ``.mixer.layer`` / ``.mlp.layer`` key injection of
gradient checkpointing and copies tensors by name. Here the same surgery
maps a HyenaDNA PyTorch state dict onto the parameter names of
``flashfftconv_tpu_torch.models.lm.ConvLMHeadModel`` (hyena mixer, built
with ``mixer_kwargs={"in_proj_bias": True}`` to take the checkpoint's
in-projection bias). Both sides are PyTorch, so ``nn.Linear`` weights keep
their (out, in) orientation; the depthwise ``nn.Conv1d`` weight (C, 1, K)
is squeezed to (C, K).

``import_m2_bert_state_dict`` maps the reference M2-BERT (a BertForMaskedLM
over Monarch Mixer sequence mixers) onto ``models.bert.M2BertForMaskedLM``
built with ``ref_structure=True`` (the reference layer has no residual or
LayerNorm around its mixer); ``blockdiag_to_dense_mlp`` turns block-diagonal
MLP weights into the dense weights of a ``mlp_nblocks=0`` model.

``import_gpt2_state_dict`` and ``import_opt_state_dict`` map HuggingFace's
``GPT2LMHeadModel`` and ``OPTForCausalLM`` keys onto
``models.gpt.GPTLMHeadModel``: GPT-2's ``Conv1D`` weights are (in, out) and
are transposed to (out, in); OPT's q, k and v projections are concatenated
(q; k; v) into ``qkv_proj``, and its position table drops the two offset
rows. The embedding table is zero-padded to the padded vocabulary.

No network access is assumed: callers pass a state-dict-like mapping (for
example from ``torch.load(path, map_location="cpu", weights_only=True)``).

Deliberate differences, as in the JAX package:
  - ``pos_emb.z`` / ``pos_emb.t`` are trainable in the reference but
    constants here with identical init values; they are reported in
    ``ImportReport.skipped``.
  - The LM head is weight-tied, so ``lm_head.weight`` is skipped in favour
    of the embedding table.
  - ``modulation.deltas`` is a constant of the port's filter unless it was
    built with ``learn_modulation``; a checkpoint's deltas then have no
    parameter to land in and are skipped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class ImportReport:
    """What happened to each source key during an import."""

    used: list[str] = dataclasses.field(default_factory=list)
    skipped: list[str] = dataclasses.field(default_factory=list)
    missing: list[str] = dataclasses.field(default_factory=list)  # parameters left at init


def _t(t) -> torch.Tensor:
    """torch.Tensor or array -> float32 CPU tensor (a copy)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(t, dtype=np.float32))


def strip_checkpointing_keys(key: str) -> str:
    """Undo the gradient-checkpointing key injection of the reference loader."""
    key = re.sub(r"\.mixer\.layer\.", ".mixer.", key)
    key = re.sub(r"\.mlp\.layer\.", ".mlp.", key)
    return key


def normalize_state_dict(state: Mapping[str, Any]) -> dict[str, Any]:
    """Unwrap {'state_dict': ...}, strip ``model.`` prefixes and
    checkpointing-injected segments."""
    if "state_dict" in state and isinstance(state["state_dict"], Mapping):
        state = state["state_dict"]
    out = {}
    for k, v in state.items():
        k = strip_checkpointing_keys(k)
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = v
    return out


# HyenaDNA key (below ``backbone.layers.{i}.``) -> port key (below
# ``backbone.blocks.{i}.``); the filter MLP's Sequential entries follow.
_BLOCK_KEYS = {
    "mixer.in_proj.weight": "mixer.in_proj",
    "mixer.in_proj.bias": "mixer.in_proj_b",
    "mixer.short_filter.weight": "mixer.short_filter.weights",
    "mixer.short_filter.bias": "mixer.short_filter.bias",
    "mixer.filter_fn.bias": "mixer.filter.bias",
    "mixer.filter_fn.modulation.deltas": "mixer.filter.modulation.deltas",
    "mixer.out_proj.weight": "mixer.out_proj.weight",
    "mixer.out_proj.bias": "mixer.out_proj.bias",
    "norm1.weight": "norm1.weight",
    "norm1.bias": "norm1.bias",
    "norm2.weight": "norm2.weight",
    "norm2.bias": "norm2.bias",
    "mlp.fc1.weight": "mlp.fc1.weight",
    "mlp.fc1.bias": "mlp.fc1.bias",
    "mlp.fc2.weight": "mlp.fc2.weight",
    "mlp.fc2.bias": "mlp.fc2.bias",
}
_TOP_KEYS = {
    "backbone.embeddings.word_embeddings.weight": "embeddings.weight",
    "backbone.ln_f.weight": "backbone.ln_f.weight",
    "backbone.ln_f.bias": "backbone.ln_f.bias",
}
_LAYER = re.compile(r"backbone\.layers\.(\d+)\.(.+)")
_FILTER_MLP = re.compile(r"mixer\.filter_fn\.implicit_filter\.(\d+)\.(weight|bias|freq)")


def _target(key: str, n_layer: int | None) -> str | None:
    """The port's parameter name for a normalized HyenaDNA key, or None."""
    if key in _TOP_KEYS:
        return _TOP_KEYS[key]
    m = _LAYER.match(key)
    if not m or (n_layer is not None and int(m.group(1)) >= n_layer):
        return None
    rest = m.group(2)
    sub = _BLOCK_KEYS.get(rest)
    if sub is None and (f := _FILTER_MLP.fullmatch(rest)):
        sub = f"mixer.filter.layers.{f.group(1)}.{f.group(2)}"
    return None if sub is None else f"backbone.blocks.{m.group(1)}.{sub}"


def hyenadna_state_dict(
    state: Mapping[str, Any], n_layer: int | None = None
) -> tuple[dict[str, torch.Tensor], ImportReport]:
    """Map a HyenaDNA state dict onto the port's parameter names.

    Returns (tensors, report): ``tensors`` holds only what the checkpoint
    has, as float32 CPU tensors under the names of ``ConvLMHeadModel``;
    layers at or beyond ``n_layer`` (when given) are skipped. Load them with
    :func:`load_into`, which leaves everything else at its init value.
    """
    report = ImportReport()
    out: dict[str, torch.Tensor] = {}
    for key, value in normalize_state_dict(state).items():
        target = _target(key, n_layer)
        if target is None:
            # pos_emb.z / .t (constants here), lm_head.weight (tied), task heads
            report.skipped.append(key)
            continue
        t = _t(value)
        if target.endswith("short_filter.weights"):
            t = t[:, 0, :].contiguous()  # depthwise Conv1d (C, 1, K) -> (C, K)
        out[target] = t
        report.used.append(key)
    return out, report


def load_into(
    model: nn.Module, tensors: Mapping[str, torch.Tensor], report: ImportReport | None = None
) -> None:
    """Copy ``tensors`` (by parameter name) into ``model``'s parameters.
    Parameters the mapping lacks keep their init values (recorded in
    ``report.missing``); a name the model has no parameter for is dropped; a
    shape mismatch raises ValueError."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = tensors.get(name)
            if t is None:
                if report is not None:
                    report.missing.append(name)
                continue
            if t.shape != p.shape:
                raise ValueError(
                    f"shape mismatch at {name}: checkpoint {tuple(t.shape)} "
                    f"vs model {tuple(p.shape)}"
                )
            p.copy_(t.to(p.device, p.dtype))


def import_hyenadna(model: nn.Module, state: Mapping[str, Any]) -> ImportReport:
    """Load a HyenaDNA state dict into a port ``ConvLMHeadModel`` in place.
    Source keys without a parameter in ``model`` (for example the filter's
    constant ``modulation.deltas``) are reported as skipped, not used."""
    n_layer = len(model.backbone.blocks)
    tensors, report = hyenadna_state_dict(state, n_layer=n_layer)
    params = {name for name, _ in model.named_parameters()}
    for key in list(report.used):
        if _target(key, n_layer) not in params:
            report.used.remove(key)
            report.skipped.append(key)
    load_into(model, tensors, report)
    return report


# --- M2-BERT (the reference's examples/bert) --------------------------------

_M2_TOP_KEYS = {
    "bert.embeddings.word_embeddings.weight": "bert.word_embeddings.weight",
    "bert.embeddings.position_embeddings.weight": "bert.position_embeddings.weight",
    "bert.embeddings.token_type_embeddings.weight": "bert.token_type_embeddings.weight",
    "bert.embeddings.LayerNorm.weight": "bert.embed_norm.weight",
    "bert.embeddings.LayerNorm.bias": "bert.embed_norm.bias",
    "cls.predictions.transform.dense.weight": "mlm_transform.weight",
    "cls.predictions.transform.dense.bias": "mlm_transform.bias",
    "cls.predictions.transform.LayerNorm.weight": "mlm_norm.weight",
    "cls.predictions.transform.LayerNorm.bias": "mlm_norm.bias",
    "cls.predictions.decoder.weight": "mlm_head.weight",
    "cls.predictions.bias": "mlm_head.bias",
}
# Reference key below ``bert.encoder.layer.{i}.`` -> port key below
# ``bert.layer.{i}.``; the implicit filters' Sequential entries follow.
_M2_LAYER_KEYS = {
    "attention.in_linear.weight": "mixer.in_linear",
    "attention.short_filter.weights": "mixer.short_filter.weights",
    "attention.short_filter.bias": "mixer.short_filter.bias",
    "attention.filter": "mixer.filter",  # inference mode: plain kernels
    "attention.filter2": "mixer.filter2",
    "attention.out_linear.weight": "mixer.out_linear.weight",
    "attention.out_linear.bias": "mixer.out_linear.bias",
    "mlp.layernorm.weight": "norm2.weight",
    "mlp.layernorm.bias": "norm2.bias",
    "mlp.gated_layers.weight": "mlp_fc1.weight",
    "mlp.gated_layers.bias": "mlp_fc1.bias",
    "mlp.wo.weight": "mlp_fc2.weight",
    "mlp.wo.bias": "mlp_fc2.bias",
}
_M2_LAYER = re.compile(r"bert\.encoder\.layer\.(\d+)\.(.+)")
# One reference HyenaFilter holds both MLPs of a bidirectional kernel
# (implicit_filter, implicit_filter_rev) and their shared bias and deltas;
# the port has a second filter module (``filter_rev``) for the reverse MLP.
_M2_FILTER = re.compile(
    r"attention\.(filter_fn2?)\.(?:(implicit_filter(?:_rev)?)\.(\d+)\.(weight|bias|freq)"
    r"|(bias|modulation\.deltas))")


def _m2_target(key: str, n_layer: int) -> str | None:
    """The port's parameter name for a normalized reference M2-BERT key, or
    None for the keys the JAX import skips too: the in-projection's bias
    (the reference's forward drops it), the inference kernels' unused
    biases, the filters' positional-embedding constants, the pooler and any
    task head."""
    if key in _M2_TOP_KEYS:
        return _M2_TOP_KEYS[key]
    m = _M2_LAYER.match(key)
    if not m or int(m.group(1)) >= n_layer:
        return None
    rest = m.group(2)
    sub = _M2_LAYER_KEYS.get(rest)
    if sub is None and (f := _M2_FILTER.fullmatch(rest)):
        ours = "filter" if f.group(1) == "filter_fn" else "filter2"
        if f.group(2) is None:  # the shared bias and deltas live on the forward filter
            sub = f"mixer.{ours}.{f.group(5)}"
        else:
            rev = "_rev" if f.group(2).endswith("_rev") else ""
            sub = f"mixer.{ours}{rev}.layers.{f.group(3)}.{f.group(4)}"
    return None if sub is None else f"bert.layer.{m.group(1)}.{sub}"


def import_m2_bert_state_dict(
    state: Mapping[str, Any], n_layer: int | None = None
) -> tuple[dict[str, torch.Tensor], ImportReport]:
    """Map a reference M2-BERT state dict onto the parameter names of
    ``M2BertForMaskedLM(ref_structure=True)`` (its per-layer LayerNorm is the
    reference's post-MLP one, ``norm2``). Linear weights keep their (out, in)
    orientation and block-diagonal MLP weights their (nblocks, q, p) shape;
    convert the latter with ``blockdiag_to_dense_mlp`` for a dense-MLP model.
    ``n_layer`` defaults to the number of layers the checkpoint holds.
    Returns (tensors, report); load the tensors with :func:`load_into`."""
    state = normalize_state_dict(state)
    if n_layer is None:
        ids = {int(m.group(1)) for k in state if (m := _M2_LAYER.match(k))}
        n_layer = max(ids) + 1 if ids else 0
    report = ImportReport()
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        target = _m2_target(key, n_layer)
        if target is None:
            report.skipped.append(key)
            continue
        out[target] = _t(value)
        report.used.append(key)
    return out, report


def blockdiag_to_dense_mlp(tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every block-diagonal weight (nblocks, q, p) among ``tensors`` as the
    equivalent dense (nblocks * q, nblocks * p) weight, the others as they
    are: a Monarch-MLP checkpoint then loads into a dense-MLP model."""
    return {name: torch.block_diag(*t.unbind(0)) if t.ndim == 3 else t
            for name, t in tensors.items()}


# --- GPT-2 and OPT (HuggingFace transformers) --------------------------------

def _pad_rows(table: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-table.shape[0]) % multiple
    return torch.cat([table, table.new_zeros(pad, table.shape[1])]) if pad else table


def import_gpt2_state_dict(
    state: Mapping[str, Any], n_layer: int, pad_vocab_size_multiple: int = 8
) -> tuple[dict[str, torch.Tensor], ImportReport]:
    """Map a ``GPT2LMHeadModel`` state dict onto ``GPTLMHeadModel``'s
    parameter names. ``lm_head.weight`` (tied) and the attention mask buffers
    are skipped. Returns (tensors, report); load with :func:`load_into`."""
    report = ImportReport()
    state = {k.removeprefix("transformer."): v for k, v in normalize_state_dict(state).items()}
    out: dict[str, torch.Tensor] = {}

    def take(key: str) -> torch.Tensor:
        report.used.append(key)
        return _t(state[key])

    def copy(src: str, dst: str, conv1d: bool = False) -> None:
        for leaf in ("weight", "bias"):
            t = take(f"{src}.{leaf}")
            out[f"{dst}.{leaf}"] = t.T.contiguous() if conv1d and leaf == "weight" else t

    out["embeddings.weight"] = _pad_rows(take("wte.weight"), pad_vocab_size_multiple)
    out["pos_embeddings"] = take("wpe.weight")
    copy("ln_f", "ln_f")
    for i in range(n_layer):
        src, dst = f"h.{i}.", f"blocks.{i}."
        copy(src + "ln_1", dst + "norm1")
        copy(src + "ln_2", dst + "norm2")
        copy(src + "attn.c_attn", dst + "mixer.qkv_proj", conv1d=True)
        copy(src + "attn.c_proj", dst + "mixer.out_proj", conv1d=True)
        copy(src + "mlp.c_fc", dst + "mlp.fc1", conv1d=True)
        copy(src + "mlp.c_proj", dst + "mlp.fc2", conv1d=True)
    used = set(report.used)
    report.skipped = [k for k in state if k not in used]
    return out, report


def import_opt_state_dict(
    state: Mapping[str, Any], n_layer: int, pad_vocab_size_multiple: int = 8
) -> tuple[dict[str, torch.Tensor], ImportReport]:
    """Map an ``OPTForCausalLM`` state dict onto ``GPTLMHeadModel``'s
    parameter names (build it with ``mlp_activation="relu"`` and, where
    ``word_embed_proj_dim`` differs from the hidden size, ``embed_dim``).
    ``lm_head.weight`` (tied) is skipped. Returns (tensors, report)."""
    report = ImportReport()
    state = {k.removeprefix("decoder."): v for k, v in normalize_state_dict(state).items()}
    out: dict[str, torch.Tensor] = {}

    def take(key: str) -> torch.Tensor:
        report.used.append(key)
        return _t(state[key])

    def copy(src: str, dst: str) -> None:
        for leaf in ("weight", "bias"):
            if f"{src}.{leaf}" in state:
                out[f"{dst}.{leaf}"] = take(f"{src}.{leaf}")

    out["embeddings.weight"] = _pad_rows(take("embed_tokens.weight"), pad_vocab_size_multiple)
    # OPTLearnedPositionalEmbedding's offset: rows 0 and 1 are never addressed
    out["pos_embeddings"] = take("embed_positions.weight")[2:].contiguous()
    copy("final_layer_norm", "ln_f")
    for proj in ("project_in", "project_out"):
        copy(proj, proj)
    for i in range(n_layer):
        src, dst = f"layers.{i}.", f"blocks.{i}."
        copy(src + "self_attn_layer_norm", dst + "norm1")
        copy(src + "final_layer_norm", dst + "norm2")
        for leaf in ("weight", "bias"):
            out[f"{dst}mixer.qkv_proj.{leaf}"] = torch.cat(
                [take(f"{src}self_attn.{n}_proj.{leaf}") for n in "qkv"])
        copy(src + "self_attn.out_proj", dst + "mixer.out_proj")
        copy(src + "fc1", dst + "mlp.fc1")
        copy(src + "fc2", dst + "mlp.fc2")
    used = set(report.used)
    report.skipped = [k for k in state if k not in used]
    return out, report
