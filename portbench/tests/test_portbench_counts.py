"""The yardstick's counts at a small shape, against a count by hand."""

from __future__ import annotations

import math

import pytest
from conftest import tiny_config

from portbench import flops, harness


def test_fftconv_algo_flops_by_hand():
    # N = 16: 3 FFTs at 5 * 16 * 4 = 320 each, 96 for the product, per channel
    assert flops.fftconv_algo_flops(16, 2, 3) == (3 * 320 + 96) * 6
    assert flops.fftconv_algo_flops(16, 1, 1, gated=True) == 3 * 320 + 96 + 64


def test_peaks_by_name():
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bfloat16"] == 989e12
    assert flops.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert flops.peaks("cpu") is None


@pytest.mark.parametrize("train", [False, True])
def test_hyena_work_by_hand(train):
    cfg = tiny_config(harness.config("hyena-125m"), "bfloat16")  # d 16, 2 layers, l_max 256
    b, length = 2, 128
    w = harness.reference(cfg).work(cfg, b, length, train=train)
    rows, d, v = b * length, 16, 64  # vocab 61 padded to 64
    in_proj, out_proj, mlp = 2 * rows * 48 * 16, 2 * rows * 16 * 16, 2 * 2 * rows * 64 * 16
    filt = 2 * length * (3 * 64 + 2 * 64 * 64 + 64 * 16)
    conv = (15 * 512 * 9 + 6 * 512) * b * d
    head = 2 * rows * d * v
    forward = 2 * (in_proj + out_proj + mlp + filt + conv) + head
    assert w["model_flops"] == (3 if train else 1) * forward
    fwd_bytes = 2 * (b * d * length * 2) + d * length * 4
    bwd_bytes = 3 * (b * d * length * 2) + 2 * d * length * 4
    expect = [{"phase": "forward", "bytes": fwd_bytes, "flops": conv}]
    if train:
        expect.append({"phase": "backward", "bytes": bwd_bytes, "flops": 2 * conv})
    assert w["convs"] == expect * 2


def test_dna_work_at_full_size_matches_the_issue_estimate():
    cfg = harness.config("hyenadna-1m")
    w = harness.reference(cfg).work(cfg, 1, cfg["l_max"], train=True)
    assert math.isclose(w["model_flops"], 4.4e13, rel_tol=0.03)


def test_window_feed_gives_lm_batches_windows():
    import numpy as np
    import torch

    from portbench import data

    tokens = data.synthetic_genome(5, 5000).astype(np.int64)
    feed = data.WindowFeed(torch.from_numpy(tokens), 3, 100, seed=9, units=4)
    batches = data.lm_batches(tokens, 3, 100, np.random.default_rng(9))
    for i in range(4):
        x, y = next(batches)
        fx, fy = feed(i)
        assert np.array_equal(fx.numpy(), x) and np.array_equal(fy.numpy(), y)
