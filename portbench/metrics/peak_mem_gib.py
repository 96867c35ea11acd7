"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the window,
the peak reset after set-up, in GiB."""


def read(ctx: dict):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
