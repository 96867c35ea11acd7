"""``train_tokens_per_s``: tokens of every train step finished in the
window over the window's seconds of device time (CUDA events on the
stream from the first step's start to the last step's end)."""


def read(ctx: dict):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    return ctx["units"] * ctx["tokens_per_unit"] / ctx["window_s"]
