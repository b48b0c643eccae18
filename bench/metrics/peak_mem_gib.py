"""torch.cuda.max_memory_allocated() over the window, reset at its
opening, in GiB."""


def read(ctx):
    if not ctx.cuda:
        return None
    return ctx.peak_window_bytes / 2 ** 30
