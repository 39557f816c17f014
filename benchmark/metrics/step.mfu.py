"""% of the chip's peaks the whole step reaches: the step's least time,
the frozen bounds of the kernel launches a traced replayed step makes,
over the step's time measured untraced in the same run (the window's
seconds over its steps)."""

from bm.kernels import matcher


def read(ctx):
    least = sum(ctx["blocks"].time_us(matcher(k))[1] * b
                for k, b in ctx["bounds"].items()) / ctx["steps"]
    return 100.0 * least / ctx["step_s"] if least > 0 else None
