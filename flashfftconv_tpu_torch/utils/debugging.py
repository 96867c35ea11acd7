"""Numerics debugging helpers (PyTorch).

Port of the JAX package's ``utils/debugging.py``. ``debug_nans`` is the
counterpart of ``jax_debug_nans``: a ``TorchDispatchMode`` that looks at the
output of every aten op run inside it, forward and backward alike, and
raises ``FloatingPointError`` naming the op on the first floating output
that holds a NaN (``torch.autograd.detect_anomaly`` checks only the
backward). ``checked`` is the counterpart of checkify's ``float_checks``:
the same NaN check, plus a raise on an inf that a division makes.

A CUDA kernel called through ctypes (every kernel of ``ops/``) is invisible
to the dispatcher: a NaN it writes is caught at the next aten op that reads
it, and the error then names that op, not the kernel. Each check reads a
flag back from the device, so the mode synchronises once an op.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_DIVISIONS = {"div", "div_", "reciprocal", "reciprocal_", "remainder", "fmod", "floor_divide"}


def _floating(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())


class _FloatChecks(TorchDispatchMode):
    def __init__(self, div_checks: bool = False):
        super().__init__()
        self.div_checks = div_checks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        base = func.overloadpacket.__name__
        for t in tree_leaves(out):
            if not _floating(t) or t.numel() == 0:
                continue
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.div_checks and base in _DIVISIONS and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"inf from a division in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Raise on the first NaN an aten op produces inside the context."""
    if not enabled:
        yield
        return
    with _FloatChecks():
        yield


def checked(fn: Callable) -> Callable:
    """Wrap fn so that a NaN from any op, or an inf from a division, raises
    ``FloatingPointError`` naming the op."""

    def wrapper(*args, **kwargs):
        with _FloatChecks(div_checks=True):
            return fn(*args, **kwargs)

    return wrapper


def _named_leaves(tree, prefix: str = ""):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first non-finite tensor of a
    module's ``state_dict`` or of a nested dict, list or tuple of tensors."""
    for path, t in _named_leaves(tree):
        if _floating(t) and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}:{path}")


def causality_leakage(f, x: torch.Tensor, positions=None) -> dict[int, float]:
    """Gradient leakage forward in time: for a causal y = f(x), dy[:, t] /
    dx[:, s] must vanish for every s > t.

    f maps (B, L, D) -> (B, L, ...). Returns {t: max |d sum(y[:, t]) / dx[:, s]|
    over s > t} at the checked positions (default L//4, L//2, 3L//4)."""
    length = x.shape[1]
    if positions is None:
        positions = sorted({length // 4, length // 2, (3 * length) // 4})
    leaks = {}
    for t in positions:
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(f(xg)[:, t].float().sum(), xg)
        leaks[t] = float(g[:, t + 1 :].abs().max()) if t + 1 < length else 0.0
    return leaks
