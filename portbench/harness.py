"""The benchmark's run: set-up, the measured window, the traced stretch,
the metrics and the output check, for one cell of ``BENCHMARK.json``.

Everything specific lives in files found by name: the cell in
``workloads/<cell>.json``, its configuration in ``configs/<config>.json``
with the plain reference ``reference/<reference>.py`` it names, the
closed loop of its traffic kind in ``traffic/<kind>.py`` and each metric's
reader in ``metrics/<metric>.py`` (or the file of the metric's name up to
its first dot, which reads every split of it, such as ``copy_ms.train``
and ``copy_ms.score``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules that no run may load, compared by their whole top-level name: the
# port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "flashfftconv_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """Import the Python file at ``path`` as a module of its own."""
    name = "portbench_file_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def reference(cfg: dict):
    return load_file(HERE / "reference" / f"{cfg['reference']}.py")


def traffic(kind: str):
    return load_file(HERE / "traffic" / f"{kind}.py")


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, else the file of
    its name up to the first dot."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return load_file(path)
    raise FileNotFoundError(f"no reader for metric {metric!r} under {HERE / 'metrics'}")


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The entries of ``section`` that ``cell`` reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


class Clock:
    """Stamps on the device's stream (CUDA events), read after a
    synchronisation; on the CPU, which only the tests use, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def device_info(device: torch.device, count: int) -> dict:
    """The card's name, the count used and its power limit."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30).stdout
        info["power_limit"] = out.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def _window(job, clock: Clock, start_unit: int, until: float,
            t_window: float) -> tuple[list, list]:
    """Units from ``start_unit`` on, dispatched without a host wait, until
    the host clock passes ``until`` seconds after ``t_window``. Returns the
    outputs and the stamps (one before each unit and one after the last)."""
    outputs, stamps = [], [clock.stamp()]
    i = start_unit
    while time.perf_counter() - t_window < until:
        outputs.append(job.unit(i))
        stamps.append(clock.stamp())
        i += 1
    return outputs, stamps


def run(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_process: float | None = None) -> dict:
    """One run of a cell; returns the result line's object."""
    t_process = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    bench, cell = benchmark(), workload(cell_name)
    cfg = config(cell["config"])
    job = traffic(cell["traffic"]).Job(cfg, cell, seed, device, reference(cfg))
    clock = Clock(device)
    clock.sync()
    setup_s = time.perf_counter() - t_process
    log(f"{cell_name}: set-up {setup_s:.2f} s, seed {seed}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    first = job.first_window_unit
    t_window = time.perf_counter()
    profiled = []
    if not trace:
        outputs, stamps = _window(job, clock, first, seconds, t_window)
        phases = [stamps]
    else:
        # Two profiled stretches of trace_units whole units each, between
        # unprofiled parts of the window: the device's timeline under the
        # CUDA activity alone (busy and idle time, the breakdown), then the
        # host ranges too, which tie each operation to the call that
        # launched it (their cost on the host would read as device idle).
        from torch.profiler import ProfilerActivity, profile

        outputs, phases, profs = [], [], []
        for k, acts in enumerate(([ProfilerActivity.CUDA],
                                  [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
            out, st = _window(job, clock, first + len(outputs), seconds * (k + 1) / 3, t_window)
            outputs += out
            phases.append(st)
            clock.sync()
            with profile(activities=acts if clock.cuda else [ProfilerActivity.CPU]) as prof:
                start = first + len(outputs)
                profiled += [job.unit(start + j) for j in range(cell["trace_units"])]
                outputs += profiled[-cell["trace_units"]:]
                clock.sync()
            profs.append(prof)
        out, st = _window(job, clock, first + len(outputs), seconds, t_window)
        outputs += out
        phases.append(st)
    clock.sync()
    unit_seconds = [clock.seconds(s[i], s[i + 1]) for s in phases for i in range(len(s) - 1)]
    window_s = sum(clock.seconds(s[0], s[-1]) for s in phases)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    failed = job.failed(outputs)
    n_units = len(outputs)
    log(f"{cell_name}: {n_units} units in {window_s:.3f} s of device time "
        f"({len(profiled)} profiled), peak {peak / 2**30:.3f} GiB")

    ctx = {"kind": cell["traffic"], "cell": cell_name, "setup_s": setup_s,
           "peak_bytes": peak, "units": n_units, "unit_seconds": unit_seconds,
           "window_s": window_s, "tokens_per_unit": job.tokens_per_unit, "work": job.work,
           "device_name": device_info(device, cell["chips"])["kind"]}
    result_device = device_info(device, cell["chips"])
    result_device["memory_peak_bytes"] = peak
    breakdown = None
    if trace:
        from portbench import trace as tr

        timeline, _ = tr.device_ops(profs[0])
        ops, attributed = tr.device_ops(profs[1])
        del profs
        busy = tr.busy_intervals(timeline)
        span_s = (busy[-1][1] - busy[0][0]) * 1e-9 if busy else 0.0
        busy_s = sum(b - a for a, b in busy) * 1e-9
        units = cell["trace_units"]
        ctx.update({"ops": ops, "profiled_units": units, "busy_s": busy_s, "span_s": span_s})
        result_device.update({"busy_s": busy_s, "window_s": span_s})
        breakdown = {"device_ops": [[n, s] for n, s in tr.top_ops(timeline)],
                     "idle_gaps": [[n, s] for n, s in tr.idle_gaps(timeline)[:10]]}
        busy_ranges = tr.busy_intervals(ops)
        log(f"{cell_name}: timeline of {units} units: {len(timeline)} device operations over "
            f"{span_s:.6f} s, busy {busy_s:.6f} s; with host ranges: {len(ops)} operations, "
            f"busy {sum(b - a for a, b in busy_ranges) * 1e-9:.6f} s of "
            f"{(busy_ranges[-1][1] - busy_ranges[0][0]) * 1e-9 if busy_ranges else 0.0:.6f} s, "
            f"{attributed:.4f} of their time tied to a launch")
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell_name, section):
        value = reader(m["name"]).read({**ctx, "metric": m["name"]})
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del outputs, profiled
    ctx.clear()

    job.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = job.check()
    log(f"{cell_name}: output check in {time.perf_counter() - t_check:.2f} s")
    correct = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks)
    result = {"correct": correct, "attempted": n_units, "failed": failed, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result
