"""Real (unpadded) nodes of every batch whose step finished inside the
window, over the window's seconds (host clock; the window closes with a
synchronise)."""


def read(ctx):
    if not ctx.window_s:
        return None
    return ctx.window_nodes / ctx.window_s
