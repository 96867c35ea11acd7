"""What the benchmark takes from the program under test, by name.

A configuration names its model's entry point (``"module:attribute"``)
under ``program``, with its keyword arguments: ``kwargs``, and the
configuration's own keys that ``kwargs_from`` lists; a cell names the
train step's and the optimizer's, or the scoring entry's. They are looked
up when called, so the program's own module attributes are what runs. Only the port
(``flashfftconv_tpu_torch``) is reached from here, never the JAX package.
"""

from __future__ import annotations

import importlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def resolve(path: str):
    """``"package.module:attr"`` -> the attribute."""
    module, _, attr = path.partition(":")
    if not module.startswith("flashfftconv_tpu_torch.") and module != "flashfftconv_tpu_torch":
        raise ValueError(f"{path!r} is not in the port's package")
    return getattr(importlib.import_module(module), attr)


def build_kernels(names) -> None:
    """Build the port's CUDA libraries ``names`` at once (nvcc in parallel),
    where the program keeps them (``flashfftconv_tpu_torch/_build`` in the
    checkout); a library already built for the current sources is reused."""
    if names:
        resolve("flashfftconv_tpu_torch.ops._build:build_all")(tuple(names))


def build_model(cfg: dict, device, levers: dict | None = None) -> torch.nn.Module:
    """The configuration's model on ``device``, with the cell's memory
    levers. Its own initial draws run on the device (a generator there);
    the benchmark overwrites every parameter with ``load_weights``."""
    spec = cfg["program"]
    kwargs = {**{k: cfg[k] for k in spec.get("kwargs_from", ())}, **spec.get("kwargs", {}),
              **(levers or {})}
    kwargs = {k: DTYPES.get(v, v) if k.endswith("dtype") else v for k, v in kwargs.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.device(device):
        return resolve(spec["entry"])(**kwargs, device=device, generator=gen)


def load_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into every parameter of ``model``; the
    names and shapes have to match one for one."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(weights) - set(params)), sorted(set(params) - set(weights))
        raise ValueError(f"the model's parameters differ from the reference's: not in the "
                         f"model {missing[:5]}, not in the reference {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: model {tuple(p.shape)}, reference "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
