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


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """flax ConvLMHeadModel params (hyena mixer, tied head) -> port state dict."""
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
        p = f"backbone.blocks.{i}."
        out.update(_norm(block["norm1"], p + "norm1"))
        out.update(_norm(block["norm2"], p + "norm2"))
        out.update(hyena_operator_state_dict(block["mixer"], p + "mixer."))
        out.update(_dense(block["mlp"]["fc1"], p + "mlp.fc1"))
        out.update(_dense(block["mlp"]["fc2"], p + "mlp.fc2"))
    return out


def flax_paths(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """{port parameter name: flax path} for a port model (or any submodule
    the maps above cover): ``blocks.i`` is ``block_i``, ``layers.j`` is
    ``layers_j`` (``mixer`` in a linear-mixer filter), and a Dense, LayerNorm
    or Embed ``weight`` is flax's ``kernel``, ``scale`` or ``embedding``."""
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
    return out
