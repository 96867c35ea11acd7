"""Device-mesh parallelism (DP / TP / ZeRO) on ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py``. There a sharding is an
annotation (``NamedSharding(mesh, P(...))``) and GSPMD inserts the
collectives. Here every rank holds only its shard of each tensor a sharding
splits, and the collectives are explicit:

  - ``make_mesh`` builds a ``DeviceMesh`` with named dimensions over the
    process group's ranks (``init_device_mesh``);
  - a ``Sharding`` is the counterpart of a ``NamedSharding``: for each dim of
    a tensor, in the port's layout, the mesh dimension it is split over or
    None; ``placements`` gives the same as ``Shard(d)`` / ``Replicate()`` per
    mesh dimension, and ``local(t)`` cuts this rank's shard out of a whole
    tensor, as ``jax.device_put`` places one;
  - ``batch_sharding``, ``sequence_sharding``, ``param_shardings`` (the
    Megatron rules of ``DEFAULT_TP_RULES``, matched on each parameter's flax
    path), ``zero1_shardings`` and ``zero2_shardings`` give the JAX
    functions' specs;
  - ``shard_parameters`` keeps each rank's shard of every parameter its
    sharding splits and makes the modules that own them compute on shards:
    a Dense layer whose (out, in) weight is split on ``out`` is column-
    parallel (its input enters with ``copy_to``, its output is gathered),
    one split on ``in`` is row-parallel (its input is scattered, its output
    summed by ``reduce_from``), an MLP whose fc1 is column- and fc2
    row-parallel keeps its hidden activation split between the two (one
    collective each way, as Megatron's pair; a ``ChunkedMlp`` runs its
    L-chunked Function on the shards inside the same pair, with fc2's bias
    added after the sum), and a ``LongConv`` whose kernel
    and skip are split on the channels convolves this rank's channels alone
    (the long conv is independent per channel) and gathers them after the
    skip. Every other part of the model runs replicated, on every rank.

A flax Dense kernel is (in, out) and the port's weight (out, in): a
column-parallel ``(None, "tp")`` on the kernel is ``("tp", None)``, a
``Shard(0)``, on the weight. ZeRO (``zero1_shardings`` for the optimizer's
moments, ``zero2_shardings`` for the gradients) is applied by
``utils.train.make_train_step``.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from flashfftconv_tpu_torch.parallel.comm import copy_to, gather_from, reduce_from, scatter_to


def make_mesh(axis_sizes: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("dp", "tp"), device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of the given sizes and dimension names over every rank
    of the default process group (which must exist, or be creatable from
    torchrun's environment). With ``axis_sizes=None`` every rank goes to the
    first dimension and the others get size 1. Raises ValueError when the
    sizes' product is not the world size."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} do not cover {n} devices")
    device = torch.device(device)
    return init_device_mesh(device.type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def mesh_axes(mesh: DeviceMesh) -> dict[str, int]:
    """{dimension name: size}, as a JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on ``mesh``: ``spec[d]`` is the mesh dimension that
    splits dim d of the tensor (in the port's layout), or None."""

    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        """``Shard(d)`` or ``Replicate()`` for each mesh dimension."""
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, s in enumerate(self.spec) if s == name]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def sharded_dims(self) -> list[tuple[int, str]]:
        return [(d, s) for d, s in enumerate(self.spec) if s is not None]

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor t (a contiguous copy)."""
        for d, name in self.sharded_dims():
            group = self.mesh.get_group(name)
            p, r = dist.get_world_size(group), dist.get_rank(group)
            if t.shape[d] % p:
                raise ValueError(f"dim {d} of size {t.shape[d]} does not split over the {p} "
                                 f"ranks of {name!r}")
            t = t.chunk(p, dim=d)[r]
        return t.contiguous()


def _spec(ndim: int, entries: dict[int, str]) -> tuple:
    return tuple(entries.get(d) for d in range(ndim))


def batch_sharding(mesh: DeviceMesh, ndim: int, batch_axis: int = 0,
                   dp_axis: str = "dp") -> Sharding:
    """Only the batch dimension split over ``dp_axis``."""
    return Sharding(mesh, _spec(ndim, {batch_axis % ndim: dp_axis}))


def sequence_sharding(mesh: DeviceMesh, ndim: int, seq_axis: int = -1,
                      sp_axis: str = "tp") -> Sharding:
    """Megatron-style sequence parallelism for pointwise blocks: the sequence
    dimension split over ``sp_axis`` (the conv itself is never split on it)."""
    return Sharding(mesh, _spec(ndim, {seq_axis % ndim: sp_axis}))


# The JAX package's rules, verbatim: regexes on the flattened flax path, specs
# in flax's layout. Dense kernels column-parallel, long-conv kernels and skips
# split on their channels H, and Megatron's attention/MLP pairs (qkv and fc1
# column-parallel, out_proj and fc2 row-parallel).
DEFAULT_TP_RULES: tuple[tuple[str, tuple[str | None, ...]], ...] = (
    (r".*output_linear.*kernel$", (None, "tp")),   # Dense (in, out) -> column-parallel
    (r".*layer_\d+/kernel$", (None, "tp", None)),  # long-conv kernel (C, H, 2L)
    (r".*layer_\d+/D$", (None, "tp")),             # skip weights (C, H)
    (r".*mixer/qkv_proj/kernel$", (None, "tp")),
    (r".*mixer/qkv_proj/bias$", ("tp",)),
    (r".*mixer/out_proj/kernel$", ("tp", None)),
    (r".*mlp/fc1/kernel$", (None, "tp")),
    (r".*mlp/fc1/bias$", ("tp",)),
    (r".*mlp/fc2/kernel$", ("tp", None)),
)


def _flax_layouts(model: nn.Module) -> dict[str, tuple[str, int, bool]]:
    """{parameter name: (flax path, the flax leaf's ndim, whether the flax
    leaf is the transpose of the port's)}. A Dense weight is flax's (in, out)
    kernel. In an LM built with ``scan_blocks`` the flax blocks are one
    ``blocks`` subtree whose leaves carry a leading layer axis."""
    from flashfftconv_tpu_torch.models.layers import Dense
    from flashfftconv_tpu_torch.models.lm import LMBackbone
    from flashfftconv_tpu_torch.utils.jax_weights import flax_paths

    modules = dict(model.named_modules())
    scanned = {name for name, m in modules.items()
               if isinstance(m, LMBackbone) and getattr(m, "scan_blocks", False)}
    paths, out = flax_paths(model), {}
    for name, p in model.named_parameters():
        path, ndim = list(paths[name]), p.ndim
        owner = modules[name.rpartition(".")[0]]
        transposed = isinstance(owner, Dense) and name.endswith(".weight")
        if any(name.startswith(f"{s}.blocks." if s else "blocks.") for s in scanned):
            i = next(j for j, part in enumerate(path) if part.startswith("block_"))
            path[i] = "blocks"
            ndim += 1
        out[name] = ("/".join(path), ndim, transposed)
    return out


def param_shardings(mesh: DeviceMesh, model: nn.Module, rules=DEFAULT_TP_RULES
                    ) -> dict[str, Sharding]:
    """{parameter name: Sharding}: the first rule whose regex matches the
    parameter's flax path and whose spec has the flax leaf's ndim, in the
    port's layout; replicated where none does (the JAX function's
    ``len(spec) == leaf.ndim`` test, which leaves the stacked blocks of a
    scanned LM replicated)."""
    out = {}
    for name, (path, ndim, transposed) in _flax_layouts(model).items():
        spec = next((s for pattern, s in rules if re.match(pattern, path) and len(s) == ndim),
                    None)
        local_ndim = dict(model.named_parameters())[name].ndim
        if spec is None:
            out[name] = Sharding(mesh, (None,) * local_ndim)
            continue
        if ndim != local_ndim:  # a stacked leaf: its first axis is the layer
            if spec[0] is not None:
                raise NotImplementedError(f"{name}: a rule splits the layer axis of {path}")
            spec = spec[1:]
        out[name] = Sharding(mesh, tuple(reversed(spec)) if transposed else tuple(spec))
    return out


def _zero_one(mesh: DeviceMesh, t, dp_axis: str) -> Sharding:
    if not isinstance(t, torch.Tensor) or t.ndim == 0:
        return Sharding(mesh, ())
    dp = mesh_axes(mesh)[dp_axis]
    for d in range(t.ndim):
        if t.shape[d] % dp == 0 and t.shape[d] >= dp:
            return Sharding(mesh, _spec(t.ndim, {d: dp_axis}))
    return Sharding(mesh, (None,) * t.ndim)


def zero1_shardings(mesh: DeviceMesh, tree, dp_axis: str = "dp"):
    """ZeRO-1: each optimizer-state tensor split over ``dp_axis`` on its first
    dimension that the dp size divides; scalars and indivisible tensors
    replicated. ``tree`` is a module (whose parameters' shapes the moments
    take: {parameter name: Sharding}) or a (nested) mapping of tensors, such
    as an optimizer's ``state_dict()["state"]``, mapped leaf by leaf. The
    shapes read are this rank's (after ``shard_parameters``)."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        return {k: zero1_shardings(mesh, v, dp_axis) for k, v in tree.items()}
    return _zero_one(mesh, tree, dp_axis)


def zero2_shardings(mesh: DeviceMesh, tree, dp_axis: str = "dp"):
    """ZeRO-2: the gradients split as ZeRO-1 splits the moments. Passed to
    ``make_train_step(grad_shardings=...)``, the step reduce-scatters each
    such gradient over dp instead of all-reducing it, and each rank keeps its
    shard of the gradient and of the moments through the update."""
    return zero1_shardings(mesh, tree, dp_axis=dp_axis)


# --- applying parameter shardings ---------------------------------------------


class TensorParallelLinear:
    """The tensor-parallel form of ``F.linear(x, w, b)`` on a Dense layer's
    shard: column-parallel (w split on out) or row-parallel (w split on in),
    over ``group``. ``gather_output`` (column) and ``input_split`` (row) are
    False and True inside a Megatron pair, whose hidden activation stays
    split."""

    def __init__(self, group, column: bool, bias_split: bool = False):
        self.group, self.column, self.bias_split = group, column, bias_split
        self.gather_output, self.input_split = True, False

    def __call__(self, x, w, b):
        if self.column:
            if b is not None and not self.bias_split:
                b = scatter_to(b, 0, self.group)
            y = torch.nn.functional.linear(copy_to(x, self.group), w, b)
            return gather_from(y, -1, self.group) if self.gather_output else y
        if not self.input_split:
            x = scatter_to(x, -1, self.group)
        y = reduce_from(torch.nn.functional.linear(x, w), self.group)
        return y if b is None else y + b


def _dense_plan(name, w, b, mesh):
    """The TensorParallelLinear of a Dense layer whose weight has spec w and
    bias b (None without a bias), or None when neither is split."""
    out_axis, in_axis = w
    bias_axis = b[0] if b else None
    if out_axis is None and in_axis is None and bias_axis is None:
        return None
    if out_axis is not None and in_axis is None and bias_axis in (None, out_axis):
        return TensorParallelLinear(mesh.get_group(out_axis), True, bias_axis is not None)
    if in_axis is not None and out_axis is None and bias_axis is None:
        return TensorParallelLinear(mesh.get_group(in_axis), False)
    raise NotImplementedError(f"{name}: no tensor-parallel Dense for weight {w}, bias {b}")


def shard_parameters(model: nn.Module, shardings: Mapping[str, Sharding]) -> nn.Module:
    """Keep this rank's shard of every parameter ``shardings`` splits (each
    parameter's data becomes ``Sharding.local`` of it; every rank must hold
    the same whole weights when this is called) and make the modules that
    own split parameters compute on shards (module docstring). The sharding
    stays on the parameter as ``param.sharding``. Returns the model.

    Supported owners of split parameters: Dense (column- or row-parallel),
    ``LongConv`` (kernel and skip split on the channels), ``MoEMlp``
    (experts split over the ``ep_axis`` of its mesh) and ``ChunkedMlp``
    (fc1's weight and bias column- and fc2 row-parallel over one group, as
    ``DEFAULT_TP_RULES`` make them; any other split of the two raises);
    any other raises NotImplementedError."""
    from flashfftconv_tpu_torch.models.layers import Dense
    from flashfftconv_tpu_torch.models.lm import ChunkedMlp, Mlp
    from flashfftconv_tpu_torch.models.long_conv import LongConv
    from flashfftconv_tpu_torch.models.moe import MoEMlp

    params = dict(model.named_parameters())
    split = {n: s for n, s in shardings.items() if n in params and s.sharded_dims()}
    specs = {n: s.spec for n, s in split.items()}
    mesh = next(iter(split.values())).mesh if split else None
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        own = {f"{prefix}{n}" for n, _ in module.named_parameters(recurse=False)}
        if not own & split.keys():
            continue
        if isinstance(module, Dense):
            module.tp = _dense_plan(mname, specs.get(f"{prefix}weight", (None, None)),
                                    specs.get(f"{prefix}bias") if module.bias is not None
                                    else None, mesh)
        elif isinstance(module, LongConv):
            axis = specs.get(f"{prefix}kernel", (None,) * 3)[1]
            if (axis is None or module.seq_mesh is not None
                    or specs.get(f"{prefix}kernel") != (None, axis, None)
                    or specs.get(f"{prefix}D") != (None, axis)):
                raise NotImplementedError(f"{mname}: LongConv splits kernel and D together on "
                                          f"the channels, without a seq mesh")
            module.tp = mesh.get_group(axis)
        elif isinstance(module, MoEMlp):
            if module.mesh is None or any(
                    specs[n][0] != module.ep_axis or any(specs[n][1:])
                    for n in own & split.keys()):
                raise NotImplementedError(f"{mname}: MoEMlp splits its experts over the "
                                          f"ep_axis of its mesh only")
        else:
            raise NotImplementedError(f"{mname}: no sharded forward for "
                                      f"{type(module).__name__} ({sorted(own & split.keys())})")
    for mname, module in model.named_modules():
        if isinstance(module, Mlp) and not module.nblocks:
            fc1, fc2 = module.fc1.tp, module.fc2.tp
            pair = fc1 and fc2 and fc1.column and not fc2.column and fc1.group == fc2.group
            if pair:
                fc1.gather_output, fc2.input_split = False, True
            if isinstance(module, ChunkedMlp) and (fc1 or fc2) and not (pair and fc1.bias_split):
                raise NotImplementedError(f"{mname}: ChunkedMlp splits fc1 (weight and bias) "
                                          f"column- and fc2 row-parallel over one group only")
    with torch.no_grad():
        for name, s in split.items():
            p = params[name]
            p.data = s.local(p.data)
    for name, p in params.items():
        p.sharding = shardings.get(name)
    return model


__all__ = ["make_mesh", "mesh_axes", "Sharding", "batch_sharding", "sequence_sharding",
           "DEFAULT_TP_RULES", "param_shardings", "zero1_shardings", "zero2_shardings",
           "shard_parameters", "TensorParallelLinear"]
