"""``mixer_ms``: device time per unit of the operations launched inside the
program's ``mixer`` span or its backward ``mixer.bwd`` (recomputations
under ``remat`` included), in ms, from the third profiled stretch
(``portbench/spans.py``). Prints each ``mixer.*`` site's device and copy
time (copies by the kernel names of ``copy_ms.json``) and the recompute's
share."""

import json
import sys
from pathlib import Path

from portbench import spans

COPY_NAMES = tuple(json.loads((Path(__file__).parent / "copy_ms.json").read_text())["names"])


def _site(op) -> str:
    """The innermost ``mixer.*`` span at the launch, ``.bwd`` kept."""
    names = [s["name"] for s in op.spans if s["name"].startswith("mixer")]
    return names[-1]


def read(ctx: dict):
    pt = spans.context(ctx)
    ops = [op for op in pt["program_ops"] if op.within("mixer")] if pt else []
    if not ops:
        return None
    units = pt["program_units"]
    sites: dict[str, list[float]] = {}
    for op in ops:
        row = sites.setdefault(_site(op), [0.0, 0.0])
        row[0] += op.seconds
        row[1] += op.seconds if any(n in op.name for n in COPY_NAMES) else 0.0
    total = sum(op.seconds for op in ops)
    again = sum(op.seconds for op in ops if op.recompute)
    rows = ", ".join(f"{name} {dev / units * 1e3:.4f} (copies {cp / units * 1e3:.4f})"
                     for name, (dev, cp) in sorted(sites.items(), key=lambda kv: -kv[1][0]))
    print(f"[portbench] {ctx['metric']}: ms a unit by site: {rows}; recomputed "
          f"{again / total * 100:.2f}% of the mixer's device time", file=sys.stderr)
    return spans.per_unit_ms(ops, units)
