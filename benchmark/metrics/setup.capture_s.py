"""Seconds of the sampler's set-up: its initial state and its first block
(the step's warm-up, its capture as a CUDA graph and 100 replays), the
harness's span around them, ended by a synchronise."""


def read(ctx):
    return ctx["spans"].get("setup.capture")
