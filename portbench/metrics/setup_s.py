"""``setup_s``: process start to the window's start (imports, kernel
builds, the model, the weights, the warm-up and checked units), seconds."""


def read(ctx: dict):
    return ctx["setup_s"]
