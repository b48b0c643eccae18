"""Process start to the window's opening: imports, the graph and the
partition made or loaded, the experiment built, the kernels loaded and
the warm-up steps run."""


def read(ctx):
    return ctx.setup_s
