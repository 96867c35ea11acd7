"""``score_tokens_per_s``: tokens of every scoring request finished in the
window over the window's seconds of device time."""


def read(ctx: dict):
    if ctx["kind"] != "score" or not ctx["units"]:
        return None
    return ctx["units"] * ctx["tokens_per_unit"] / ctx["window_s"]
