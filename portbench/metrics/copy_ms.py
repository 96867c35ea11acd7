"""``copy_ms``: device time per step or request of the copy, cast and
layout operations, matched by the rules of ``copy_ms.json``, in ms."""

import json
from pathlib import Path

RULES = json.loads((Path(__file__).parent / "copy_ms.json").read_text())


def is_copy(op) -> bool:
    aten = [r for r in op.chain if r.startswith("aten::")]
    return bool(aten and aten[-1] in RULES["ops"]) or any(n in op.name for n in RULES["names"])


def read(ctx: dict):
    if not ctx["profiled_units"]:
        return None
    ops = [op for op in ctx["ops"] if is_copy(op)]
    if not ops:
        return None
    return sum(op.seconds for op in ops) / ctx["profiled_units"] * 1e3
