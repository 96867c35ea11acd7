"""``conv_roofline``: the least time of the long convolutions' required
work over the device time of every operation launched inside their ranges
(``conv_roofline.json``), in %. Each call's least time is the larger of its
bytes at the card's HBM rate and its ``fftconv_algo_flops`` at the bf16
peak; the calls per unit come from the configuration's reference
(``work``). Attribution is by the launching call's range, so the copies
inside the ranges count as the kernels do."""

import json
import sys
from pathlib import Path

from portbench import flops, trace

RANGES = tuple(json.loads((Path(__file__).parent / "conv_roofline.json").read_text())["ranges"])


def read(ctx: dict):
    calls = ctx["work"]["convs"]
    ops = trace.in_ranges(ctx["ops"], *RANGES)
    peak = flops.peaks(ctx["device_name"])
    if not calls or not ops or not ctx["profiled_units"] or peak is None:
        return None
    t_bytes = sum(c["bytes"] for c in calls) / peak["hbm_bytes_per_s"]
    t_ops = sum(c["flops"] for c in calls) / peak["bfloat16"]
    least = sum(max(c["bytes"] / peak["hbm_bytes_per_s"], c["flops"] / peak["bfloat16"])
                for c in calls)
    device = sum(op.seconds for op in ops) / ctx["profiled_units"]
    print(f"[portbench] {ctx['metric']}: least {least * 1e3:.4f} ms a unit (bytes "
          f"{t_bytes * 1e3:.4f}, operations {t_ops * 1e3:.4f}: bound by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}), device time in the ranges "
          f"{device * 1e3:.4f} ms", file=sys.stderr)
    return least / device * 100
