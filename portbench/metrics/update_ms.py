"""``update_ms``: device time per step of the operations launched inside
the program's ``step.update`` spans (``zero_grad``, the global-norm clip,
the optimizer and the schedule), in ms, from the third profiled stretch
(``portbench/spans.py``). Prints the clip's, the optimizer's and the
schedule's parts."""

import sys

from portbench import spans

PARTS = ("step.clip", "step.optimizer", "step.schedule")


def read(ctx: dict):
    pt = spans.context(ctx)
    ops = [op for op in pt["program_ops"] if op.within("step.update")] if pt else []
    if not ops:
        return None
    units = pt["program_units"]
    parts = {p: spans.per_unit_ms([op for op in ops if op.within(p)], units) for p in PARTS}
    parts["zero_grad and the rest"] = spans.per_unit_ms(ops, units) - sum(parts.values())
    print(f"[portbench] {ctx['metric']}: ms a step: "
          + ", ".join(f"{p} {v:.4f}" for p, v in parts.items()), file=sys.stderr)
    return spans.per_unit_ms(ops, units)
