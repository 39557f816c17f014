"""Device ms a step of the sampler, the likelihood and the block's draws
take beside the forward: the device-busy ms of a traced replayed block per
step, less that of a traced graphed() forward."""


def read(ctx):
    step = ctx["blocks"].busy_us() / ctx["steps"]
    fwd = ctx["forward"].busy_us() / ctx["forwards"]
    return (step - fwd) * 1e-3
