"""Carry a flax parameter tree over to the port's modules.

``from_jax_params`` maps the params of the JAX package's ``ConvLMHeadModel``
(hyena mixer), given as a nested dict with numpy leaves, onto the state dict
of ``flashfftconv_tpu_torch.models.lm.ConvLMHeadModel``;
``hyena_operator_state_dict`` does the same for one ``HyenaOperator``. Flax
``Dense`` kernels are (in, out) and are transposed to ``nn.Linear``'s
(out, in); ``in_proj`` is already (out, in); LayerNorm ``scale`` becomes
``weight``. The blocks come as ``backbone/block_{i}`` or, from a flax model
built with ``scan_blocks=True``, as one ``backbone/blocks`` tree whose leaves
have a leading n_layer axis. The result loads with
``load_state_dict(..., strict=True)``.

The map takes any tree shaped like the params: ``from_jax_params`` of a
``jax.grad`` tree gives each gradient under the port's parameter name,
transposed as the weights are, to compare with the port's ``.grad``.
``flax_paths`` is the map's inverse: the flax path of every parameter of a
port model, from the modules' types (the optimizer's labels read it).

``m2_bert_state_dict`` does the same for the JAX package's
``M2BertForMaskedLM``: the mixer's ``in_linear`` is already (out, in), a
``BlockdiagLinear`` weight (nblocks, q, p) carries over 1:1, Dense kernels
are transposed, and with ``tie_mlm_head`` the top-level ``word_embeddings``
table lands in ``bert.word_embeddings``.

``h3_operator_state_dict``, ``long_conv_state_dict`` and
``long_conv_operator_state_dict`` carry one ``H3Operator``, ``LongConv`` or
``LongConvOperator`` (their kernel generators' parameters keep the flax
names); ``from_jax_params`` takes a ``ConvLMHeadModel`` with any mixer of
the registry (``hyena``, ``m2``, ``h3``, ``long-conv``, ``mha``) and a
dense or block-diagonal MLP; ``long_conv_model_state_dict`` takes a
``LongConvModel`` and ``sequence_model_state_dict`` a ``SequenceModel``.

``gpt_state_dict`` does the same for the JAX package's ``GPTLMHeadModel``
(``embeddings``, ``pos_embeddings``, ``block_i/{norm1, norm2, mixer/{qkv_proj,
out_proj}, mlp/{fc1, fc2}}``, ``ln_f`` and OPT's ``project_in`` and
``project_out``), and ``mha_state_dict`` for one ``MHAOperator``;
``from_jax_params`` takes a ``ConvLMHeadModel`` with the ``"mha"`` mixer too.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from flashfftconv_tpu_torch.models.layers import Dense, Embed, LayerNorm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(tree, prefix: str) -> dict[str, torch.Tensor]:
    out = {f"{prefix}.weight": _t(tree["kernel"]).T.contiguous()}
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])
    return out


def _norm(tree, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(tree["scale"]), f"{prefix}.bias": _t(tree["bias"])}


def hyena_filter_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """flax HyenaFilter params -> port HyenaFilter state dict."""
    out = {f"{prefix}bias": _t(tree["bias"])}
    for name, sub in tree.items():
        if name.startswith("layers_"):
            i = int(name.split("_")[1])
            if "freq" in sub:
                out[f"{prefix}layers.{i}.freq"] = _t(sub["freq"])
            else:
                out.update(_dense(sub, f"{prefix}layers.{i}"))
        elif name == "mixer":  # linear_mixer=True: the one Dense, unnamed in the port
            out.update(_dense(sub, f"{prefix}layers.0"))
        elif name == "modulation":
            out[f"{prefix}modulation.deltas"] = _t(sub["deltas"])
    return out


def hyena_operator_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """flax HyenaOperator params -> port HyenaOperator state dict."""
    out = {f"{prefix}in_proj": _t(tree["in_proj"])}
    if "in_proj_b" in tree:
        out[f"{prefix}in_proj_b"] = _t(tree["in_proj_b"])
    sf = tree["short_filter"]
    out[f"{prefix}short_filter.weights"] = _t(sf["weights"])
    out[f"{prefix}short_filter.bias"] = _t(sf["bias"])
    out.update(hyena_filter_state_dict(tree["filter"], f"{prefix}filter."))
    out.update(_dense(tree["out_proj"], f"{prefix}out_proj"))
    return out


def mha_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """flax MHAOperator params -> port MHAOperator state dict."""
    return {**_dense(tree["qkv_proj"], f"{prefix}qkv_proj"),
            **_dense(tree["out_proj"], f"{prefix}out_proj")}


def _leaves(tree, prefix: str) -> dict[str, torch.Tensor]:
    """Every leaf of a flax subtree under its own name (nested by '.')."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_leaves(sub, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = _t(sub)
    return out


def h3_operator_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """flax H3Operator params -> port H3Operator state dict: the four Dense
    layers transposed, the kernel generators (``k_kernel``, ``kernel``) and
    the skips ``k_D`` and ``D`` leaf for leaf."""
    out = {}
    for name in ("q_proj", "k_proj", "v_proj", "output_linear"):
        out.update(_dense(tree[name], prefix + name))
    for name in ("k_kernel", "kernel"):
        out.update(_leaves(tree[name], f"{prefix}{name}."))
    out[f"{prefix}k_D"] = _t(tree["k_D"])
    out[f"{prefix}D"] = _t(tree["D"])
    return out


def long_conv_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """flax LongConv params -> port LongConv state dict."""
    return {f"{prefix}kernel": _t(tree["kernel"]), f"{prefix}D": _t(tree["D"]),
            **_dense(tree["output_linear"], prefix + "output_linear")}


def long_conv_operator_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """flax LongConvOperator params -> port LongConvOperator state dict."""
    return long_conv_state_dict(tree["conv"], prefix + "conv.")


def long_conv_model_state_dict(params) -> dict[str, torch.Tensor]:
    """flax LongConvModel params -> port ``models.long_conv.LongConvModel``
    state dict (``layer_i`` -> ``layer.i``, ``norm_i`` -> ``norm.i``)."""
    out = {**_dense(params["encoder"], "encoder"), **_dense(params["decoder"], "decoder")}
    for name, sub in params.items():
        kind, _, i = name.rpartition("_")
        if kind == "layer":
            out.update(long_conv_state_dict(sub, f"layer.{i}."))
        elif kind == "norm":
            out.update(_norm(sub, f"norm.{i}"))
    return out


def _mixer_state_dict(tree, prefix: str) -> dict[str, torch.Tensor]:
    """A flax mixer of the lm registry, told apart by its parameters."""
    if "qkv_proj" in tree:
        return mha_state_dict(tree, prefix)
    if "q_proj" in tree:
        return h3_operator_state_dict(tree, prefix)
    if "in_linear" in tree:
        return m2_mixer_state_dict(tree, prefix)
    if "conv" in tree:
        return long_conv_operator_state_dict(tree, prefix)
    return hyena_operator_state_dict(tree, prefix)


def _block_state_dict(block, prefix: str) -> dict[str, torch.Tensor]:
    """One flax lm.Block (any mixer of the registry, a dense or
    block-diagonal MLP) -> port state dict."""
    return {**_norm(block["norm1"], prefix + "norm1"), **_norm(block["norm2"], prefix + "norm2"),
            **_mixer_state_dict(block["mixer"], prefix + "mixer."),
            **_m2_linear(block["mlp"]["fc1"], prefix + "mlp.fc1"),
            **_m2_linear(block["mlp"]["fc2"], prefix + "mlp.fc2")}


def gpt_state_dict(params) -> dict[str, torch.Tensor]:
    """flax GPTLMHeadModel params -> port ``models.gpt.GPTLMHeadModel`` state dict."""
    out = {"embeddings.weight": _t(params["embeddings"]["embedding"]),
           "pos_embeddings": _t(params["pos_embeddings"])}
    out.update(_norm(params["ln_f"], "ln_f"))
    for name in ("project_in", "project_out"):
        if name in params:
            out.update(_dense(params[name], name))
    for name, block in params.items():
        if name.startswith("block_"):
            out.update(_block_state_dict(block, f"blocks.{name.split('_')[1]}."))
    return out


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """flax ConvLMHeadModel params (hyena or mha mixer, tied head) -> port state dict."""
    out = {"embeddings.weight": _t(params["embeddings"]["embedding"])}
    backbone = params["backbone"]
    out.update(_norm(backbone["ln_f"], "backbone.ln_f"))
    blocks = {int(name.split("_")[1]): block for name, block in backbone.items()
              if name.startswith("block_")}
    if "blocks" in backbone:  # scan_blocks=True: one tree, leaves stacked over the layers
        def layer(tree, i):
            return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

        stacked = backbone["blocks"]
        leaf = stacked["norm1"]["scale"]
        blocks.update({i: layer(stacked, i) for i in range(leaf.shape[0])})
    for i, block in blocks.items():
        out.update(_block_state_dict(block, f"backbone.blocks.{i}."))
    return out


def m2_mixer_state_dict(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """flax MonarchMixerSequenceMixing params -> port mixer state dict."""
    out = {f"{prefix}in_linear": _t(tree["in_linear"]),
           f"{prefix}short_filter.weights": _t(tree["short_filter"]["weights"]),
           f"{prefix}short_filter.bias": _t(tree["short_filter"]["bias"])}
    for name in ("filter", "filter_rev", "filter2", "filter2_rev"):
        if name in tree:
            sub = tree[name]
            if isinstance(sub, dict):
                out.update(hyena_filter_state_dict(sub, f"{prefix}{name}."))
            else:  # inference mode: the kernel is a plain weight
                out[f"{prefix}{name}"] = _t(sub)
    out.update(_dense(tree["out_linear"], f"{prefix}out_linear"))
    return out


def _m2_linear(tree, prefix: str) -> dict[str, torch.Tensor]:
    if "weight" in tree:  # BlockdiagLinear (nblocks, q, p)
        out = {f"{prefix}.weight": _t(tree["weight"])}
        if "bias" in tree:
            out[f"{prefix}.bias"] = _t(tree["bias"])
        return out
    return _dense(tree, prefix)


def m2_bert_state_dict(params) -> dict[str, torch.Tensor]:
    """flax M2BertForMaskedLM params -> port ``models.bert.M2BertForMaskedLM``
    state dict (any parameter the tree lacks, such as token-type embeddings
    the flax model never used, is left out)."""
    out = {}
    bert = params["bert"]
    words = params["word_embeddings"] if "word_embeddings" in params else bert["word_embeddings"]
    out["bert.word_embeddings.weight"] = _t(words["embedding"])
    for name in ("position_embeddings", "token_type_embeddings"):
        if name in bert:
            out[f"bert.{name}.weight"] = _t(bert[name]["embedding"])
    out.update(_norm(bert["embed_norm"], "bert.embed_norm"))
    for name, layer in bert.items():
        if not name.startswith("layer_"):
            continue
        p = f"bert.layer.{name.split('_')[1]}."
        out.update(m2_mixer_state_dict(layer["mixer"], p + "mixer."))
        for norm in ("norm1", "norm2"):
            if norm in layer:
                out.update(_norm(layer[norm], p + norm))
        out.update(_m2_linear(layer["mlp_fc1"], p + "mlp_fc1"))
        out.update(_m2_linear(layer["mlp_fc2"], p + "mlp_fc2"))
    out.update(_dense(params["mlm_transform"], "mlm_transform"))
    out.update(_norm(params["mlm_norm"], "mlm_norm"))
    if "mlm_head" in params:
        out.update(_dense(params["mlm_head"], "mlm_head"))
    if "mlm_bias" in params:
        out["mlm_bias"] = _t(params["mlm_bias"])
    return out


def sequence_model_state_dict(params) -> dict[str, torch.Tensor]:
    """flax SequenceModel params -> port ``models.sequence.SequenceModel``
    state dict: ``encoder_i``, ``block_i``, ``pool_i``, ``ln_f`` and the
    decoder (``proj``, or a retrieval head's ``fc1`` and ``fc2``)."""
    out = _norm(params["ln_f"], "ln_f")
    for name, sub in params.items():
        kind, _, i = name.rpartition("_")
        if kind == "encoder":
            if "embed" in sub:
                out[f"encoder.{i}.embed.weight"] = _t(sub["embed"]["embedding"])
            elif "patch" in sub:
                out[f"encoder.{i}.patch_kernel"] = _t(sub["patch"]["kernel"])
                out[f"encoder.{i}.patch_bias"] = _t(sub["patch"]["bias"])
            elif "proj" in sub:
                out.update(_dense(sub["proj"], f"encoder.{i}.proj"))
        elif kind == "block":
            out.update(_block_state_dict(sub, f"blocks.{i}."))
        elif kind == "pool" and "proj" in sub:
            out.update(_dense(sub["proj"], f"pool.{i}.proj"))
    for name, sub in params.get("decoder", {}).items():
        out.update(_dense(sub, f"decoder.{name}"))
    return out


def flax_paths(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """{port parameter name: flax path} for a port model (or any submodule
    the maps above cover): ``blocks.i`` is ``block_i``, ``layers.j`` is
    ``layers_j`` (``mixer`` in a linear-mixer filter), and a Dense, LayerNorm
    or Embed ``weight`` is flax's ``kernel``, ``scale`` or ``embedding``. In an
    M2-BERT with a tied MLM head the word embeddings sit at the top of the
    flax tree, beside ``bert``."""
    leaf_names = {Dense: "kernel", LayerNorm: "scale", Embed: "embedding"}
    modules = dict(model.named_modules())
    out = {}
    for name, _ in model.named_parameters():
        *mods, leaf = name.split(".")
        path: list[str] = []
        for i, part in enumerate(mods):
            if not part.isdigit():
                path.append(part)
            elif path[-1] == "blocks":
                path[-1] = f"block_{part}"
            elif getattr(modules[".".join(mods[: i - 1])], "linear_mixer", False):
                path[-1] = "mixer"
            else:
                path[-1] = f"{path[-1]}_{part}"
        owner = modules[".".join(mods)]
        if leaf == "weight" and type(owner) in leaf_names:
            leaf = leaf_names[type(owner)]
        out[name] = (*path, leaf)
    if getattr(model, "tie_mlm_head", False):
        out["bert.word_embeddings.weight"] = ("word_embeddings", "embedding")
    return out
