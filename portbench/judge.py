"""The comparisons that decide ``correct``: gaps between the program's
readings and the plain reference's."""

from __future__ import annotations

import statistics

import torch

# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone (a bias under a normalisation): its
# change is not compared.
MOVED_SHARE = 1e-3


def as_numbers(out: dict) -> dict:
    """Device scalars of a reference's readings as floats."""
    return {k: ([float(x) for x in v] if isinstance(v, list)
                else {n: float(x) for n, x in v.items()}) for k, v in out.items()}


def norm_gap(prog: dict[str, float], ref: dict[str, float], keep=None) -> tuple[float, str]:
    """(worst gap, its leaf) over the leaves in ``keep`` (all by default):
    |prog norm - ref norm| over the larger of the leaf's reference norm and
    the median leaf's. A leaf missing from ``prog`` reads as infinitely far."""
    names = sorted(ref if keep is None else keep)
    median = statistics.median(ref[n] for n in ref)
    worst = (0.0, "")
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) if n in prog else float("inf")
        worst = max(worst, (gap, n))
    return worst


def moved_leaves(ref_grads: dict[str, float]) -> list[str]:
    """The leaves whose reference gradient is at least MOVED_SHARE of the
    median leaf's."""
    median = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= MOVED_SHARE * median]


def logp_gap(prog_logits: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """The widest gap between two sets of log-probabilities over the last
    dimension (float32)."""
    a = torch.log_softmax(prog_logits.float(), dim=-1)
    b = torch.log_softmax(ref_logits.float(), dim=-1)
    return float((a - b).abs().max())
