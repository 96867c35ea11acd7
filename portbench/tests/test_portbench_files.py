"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps
to the contract's names, units and limits."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_one_line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).exists()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_and_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _one_line(entry["why"]) and _one_line(entry["source"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg and key in cfg["assumed"]
        assert not key.endswith(("_dim", "_rank")) and key not in ("d_model", "d_inner")
    assert (ROOT / "portbench" / "reference" / f"{cfg['reference']}.py").exists()
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_entry_and_file(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and entry["chips"] == 1
    assert _one_line(entry["why"])
    cell = json.loads((ROOT / "portbench" / "workloads" / f"{entry['name']}.json").read_text())
    for key in ("name", "config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    assert (ROOT / "portbench" / "traffic" / f"{entry['traffic']}.py").exists()
    assert all(v > 0 for v in cell["limits"].values())
    reported = [m for m in BENCH["end_to_end"] if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(entry["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_names_are_unique():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    from portbench import harness

    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed and NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert callable(harness.reader(metric["name"]).read)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert _one_line(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", cells)
