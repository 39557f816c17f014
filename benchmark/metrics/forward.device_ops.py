"""Device operations one graphed() forward launches (kernels, copies and
memsets in its trace, per forward)."""


def read(ctx):
    return len(ctx["forward"].device) / ctx["forwards"]
