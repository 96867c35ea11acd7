"""The readings that a cell's limits are set from, on the card at the
cell's own size, all seeds in one process:

- the program: the cell's set-up (the train step's checked steps, or the
  scoring requests up to the last one sampled, through the same calls as
  the window), then the output check against the float32 reference;
- the control: the reference in float8 (``Fp8Rounding``) put in the
  program's place, against the float32 reference;
- for a train cell, the fault "half of the batch left out, the mean taken
  over the rest": the reference on half the rows (on the first half of the
  positions when a batch has one row), against the whole batch.

    python3 portbench/calibrate.py --workload hyena-125m.train --seeds 1 2 3 --control-seeds 1 2 3

Prints one JSON line per reading and a summary (the largest program
reading and the smallest control and fault reading of each number), and
writes them to ``--out`` when given. The limits themselves are set by hand
in the cell's file, between the two, as ``PERF.md`` records.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _numbers(checks: list[dict]) -> dict:
    out = {c["name"]: c["value"] for c in checks}
    for c in checks:
        if "steps" in c:  # each step's loss gap, beside the compared one
            out["loss_gap_by_step"] = c["steps"]
    return out


def program_reading(harness, cell_name: str, seed: int, device) -> dict:
    cell = harness.workload(cell_name)
    cfg = harness.config(cell["config"])
    job = harness.traffic(cell["traffic"]).Job(cfg, cell, seed, device, harness.reference(cfg))
    if job.kind == "score":
        for i in range(job.first_window_unit, max(job.sampled) + 1):
            job.unit(i)
    job.release()
    _free()
    checks = job.check()
    return {"checks": _numbers(checks), "leaves": {c["name"]: c.get("leaf") for c in checks}}


def control_readings(harness, cell_name: str, seed: int, device) -> dict:
    """The float8 control and, for a train cell, the half-batch fault, each
    against the float32 reference; the program is built only for its feed
    and sampled requests, and dropped first."""
    cell = harness.workload(cell_name)
    cfg = harness.config(cell["config"])
    ref = harness.reference(cfg)
    job = harness.traffic(cell["traffic"]).Job(cfg, cell, seed, device, ref)
    job.release()
    _free()
    out = {}
    if job.kind == "train":
        exact = job.reference_run()
        out["control"] = _numbers(job.compare(job.reference_run(ref.Fp8Rounding()), exact))
        _free()
        full = job.feed

        def half(i):
            x, y = full(i)
            if x.shape[0] > 1:
                return x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            return x[:, : x.shape[1] // 2], y[:, : y.shape[1] // 2]

        job.feed = half
        out["fault_half_batch"] = _numbers(job.compare(job.reference_run(), exact))
        job.feed = full
    else:
        exact = {i: job.reference_answers(i) for i in job.sampled}
        _free()
        fp8 = {i: job.reference_answers(i, ref.Fp8Rounding()) for i in job.sampled}
        out["control"] = _numbers(job.compare(fp8, exact))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    # the repository's root, not this directory, so that portbench's module
    # names (trace, data) do not shadow others
    sys.path[:] = [str(ROOT)] + [q for q in sys.path if Path(q or '.').resolve() != ROOT / 'portbench']
    import torch

    from portbench import harness

    device = torch.device("cuda")
    info = harness.device_info(device, 1)
    rows = []

    def emit(row):
        row.update(device=info["kind"], power_limit=info.get("power_limit"))
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        r = program_reading(harness, args.workload, seed, device)
        emit({"what": "program", "seed": seed, **r, "s": time.perf_counter() - t})
        _free()
    for seed in args.control_seeds:
        t = time.perf_counter()
        r = control_readings(harness, args.workload, seed, device)
        emit({"what": "control", "seed": seed, **r, "s": time.perf_counter() - t})
        _free()
    summary = {}
    for row in rows:
        if row["what"] == "program":
            for k, v in row["checks"].items():
                if isinstance(v, list):
                    continue
                summary.setdefault(k, {}).setdefault("program_max", v)
                summary[k]["program_max"] = max(summary[k]["program_max"], v)
        else:
            for kind in ("control", "fault_half_batch"):
                for k, v in row.get(kind, {}).items():
                    if isinstance(v, list):
                        continue
                    key = f"{kind}_min"
                    summary.setdefault(k, {})[key] = min(summary[k].get(key, v), v)
    print(json.dumps({"summary": summary, "workload": args.workload}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"JAX or the JAX package was loaded: {forbidden[:20]}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
