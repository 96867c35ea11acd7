"""``train_step_ms_p90``: the 90th percentile of every step of the window,
a step from its start event to the next step's, so that a stall anywhere
counts; milliseconds."""

import statistics


def read(ctx: dict):
    steps = ctx["unit_seconds"]
    if ctx["kind"] != "train" or len(steps) < 10:
        return None
    return statistics.quantiles(steps, n=10, method="inclusive")[-1] * 1e3
