"""Shared set-up of the benchmark's own tests: the repository's root on
the import path and tiny versions of the cells for the CPU."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("hyena-125m.train", "hyenadna-1m.train", "hyenadna-1m.score", "hyena-125m.score")


def tiny_config(cfg: dict, dtype: str) -> dict:
    """The configuration at d_model 16, 2 layers, l_max 256, in ``dtype``."""
    cfg = copy.deepcopy(cfg)
    cfg.update(d_model=16, n_layer=2, d_inner=64, l_max=256, act_dtype=dtype)
    prog = cfg["program"]
    if prog["entry"].endswith(":ConvLMHeadModel"):
        cfg["vocab_size"] = 61
    else:  # a HyenaDNA preset, resized through build_model's overrides
        prog["kwargs"] = {**prog["kwargs"], "name": "tiny-1k", "d_model": 16, "n_layer": 2,
                          "l_max": 256}
    prog["kwargs"] = {**prog["kwargs"], "dtype": dtype}
    return cfg


def tiny_workload(cell: dict) -> dict:
    cell = copy.deepcopy(cell)
    p = cell["params"]
    p.update(seq_len=128, batch=min(p["batch"], 2))
    p["tokens"] = ({"kind": "uniform", "vocab": 61, "length": 4096}
                   if p["tokens"]["kind"] == "uniform" else {"kind": "genome", "length": 4096})
    if p.get("check_requests"):
        p.update(sample_within=2, check_requests=1)
    if p.get("check_positions"):
        p["check_positions"] = 8
    cell["trace_units"] = 1
    return cell


@pytest.fixture
def tiny(monkeypatch):
    """Returns a function that makes the harness read tiny versions of the
    cells' files, with the program in ``dtype``."""
    from portbench import harness

    config, workload = harness.config, harness.workload

    def use(dtype="float32"):
        monkeypatch.setattr(harness, "config", lambda name: tiny_config(config(name), dtype))
        monkeypatch.setattr(harness, "workload", lambda name: tiny_workload(workload(name)))
        return harness

    return use
