"""``idle_in_program_ms``: device-idle time per unit of the third profiled
stretch (``portbench/spans.py``) during which the host was inside a unit's
program spans, in ms; the rest of the idle time fell between units, in the
harness. Prints the idle time by the innermost span open at the launch
that ended each gap, and the stretch's idle share beside the CUDA-only
stretch's (``device_idle``): what the program's tracing costs the host."""

import sys

from portbench import spans


def read(ctx: dict):
    pt = spans.context(ctx)
    if not pt or not pt["program_ops"]:
        return None
    units = pt["program_units"]
    by_span: dict[str, float] = {}
    inside = outside = 0
    for label, in_ns, out_ns in spans.idle(pt["program_ops"], pt["program_spans"]):
        by_span[label] = by_span.get(label, 0.0) + in_ns * 1e-6 / units
        inside, outside = inside + in_ns, outside + out_ns
    top = sorted(((n, v) for n, v in by_span.items() if v > 0), key=lambda kv: -kv[1])[:12]
    share = ((pt["program_span_s"] - pt["program_busy_s"]) / pt["program_span_s"] * 100
             if pt["program_span_s"] else 0.0)
    first = (ctx["span_s"] - ctx["busy_s"]) / ctx["span_s"] * 100 if ctx.get("span_s") else 0.0
    print(f"[portbench] {ctx['metric']}: idle ms a unit by innermost span: "
          + ", ".join(f"{n} {v:.4f}" for n, v in top)
          + f"; between units {outside * 1e-6 / units:.4f}; stretch idle {share:.3f}% "
          f"(CUDA-only stretch {first:.3f}%), unit {pt['program_span_s'] / units * 1e3:.3f} ms "
          f"(CUDA-only {ctx['span_s'] / ctx['profiled_units'] * 1e3:.3f})", file=sys.stderr)
    return inside * 1e-6 / units
