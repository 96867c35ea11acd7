"""The yardstick's arithmetic: published peaks of the card and the
algorithmic operation count of one FFT convolution.

Frozen copies, so that the benchmark does not move with the program:
``PEAKS`` is the H100 row of ``peak_flops``'s table and
``fftconv_algo_flops`` the function of the same name, both from
``flashfftconv_tpu_torch/utils/benchmarking.py``.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: dense tensor-core bf16 and f16, CUDA-core f32,
# HBM3 bandwidth. Rates at the full 700 W power limit.
PEAKS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The row of ``PEAKS`` whose key is in the card's name; None for any
    other device (no share of a peak is read there)."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    return None


def fftconv_algo_flops(seqlen: int, b: int, h: int, gated: bool = False) -> float:
    """Algorithmic FLOPs of one FFT convolution over (b, h) channels: 3
    complex FFTs at 5 N log2 N real FLOPs each, the 6N pointwise complex
    product and 4N more with gates."""
    n = float(seqlen)
    per_channel = 15.0 * n * math.log2(n) + 6.0 * n + (4.0 * n if gated else 0.0)
    return per_channel * b * h


def linear_flops(m: int, n: int, k: int) -> float:
    """A product of an (m, k) and a (k, n) matrix."""
    return 2.0 * m * n * k
