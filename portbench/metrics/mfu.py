"""``mfu``: the model's FLOPs per unit (counted from the shapes by the
configuration's reference, ``work``) times the units of the traced run
outside its profiled stretch, over their seconds of device time, as a
share of the card's published dense bf16 peak, in %."""

from portbench import flops


def read(ctx: dict):
    secs, peak = sum(ctx["unit_seconds"]), flops.peaks(ctx["device_name"])
    if not secs or peak is None:
        return None
    return ctx["work"]["model_flops"] * len(ctx["unit_seconds"]) / secs / peak["bfloat16"] * 100
