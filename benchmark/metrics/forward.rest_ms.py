"""Device ms of a traced graphed() forward outside the fused kernels (the
profiles, the radii, the rows, the assembly and the bands)."""

from bm.kernels import KERNELS, matcher


def read(ctx):
    tf = ctx["forward"]
    kern = sum(tf.time_us(matcher(k))[0] for k in KERNELS)
    return (tf.busy_us() - kern) / ctx["forwards"] * 1e-3
