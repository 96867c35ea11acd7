"""``optimizer_ms``: device time per step of the operations launched inside
the optimizer's own profiler range (``Optimizer.step#AdamW.step``), ms."""

from portbench import trace


def read(ctx: dict):
    ops = trace.in_ranges(ctx["ops"], "Optimizer.step#")
    if not ops or not ctx["profiled_units"]:
        return None
    return sum(op.seconds for op in ops) / ctx["profiled_units"] * 1e3
