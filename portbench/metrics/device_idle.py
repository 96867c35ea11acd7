"""``device_idle``: the share of the profiled stretch, from its first
device operation's start to its last one's end, in which no operation ran
on the card (the complement of the union of their intervals), in %."""


def read(ctx: dict):
    if not ctx["span_s"]:
        return None
    return (ctx["span_s"] - ctx["busy_s"]) / ctx["span_s"] * 100
