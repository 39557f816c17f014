"""% of the traced window of whole replayed blocks (the draws, the
replays and the host copies) in which no operation ran on the device."""


def read(ctx):
    tb = ctx["blocks"]
    return 100.0 * (1.0 - tb.busy_us() / tb.window_us)
