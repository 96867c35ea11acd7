"""``device_allocs``: the program's ``device_allocs`` counter per unit, the
caching allocator's ``cudaMalloc`` and ``cudaFree`` calls over each unit's
root span, from the third profiled stretch (``portbench/spans.py``)."""

from portbench import spans


def read(ctx: dict):
    pt = spans.context(ctx)
    if not pt:
        return None
    counts = [c["device_allocs"] for c in pt["program_counters"].values() if "device_allocs" in c]
    if not counts:
        return None
    return sum(counts) / pt["program_units"]
