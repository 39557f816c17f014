"""Device resolution, the float32 precision pin and CUDA graph capture.

The JAX package pins ``Precision.HIGHEST`` on every chi^2-sensitive
contraction (bart_tpu/rt/fused.py:140,198, obs/bands.py:99,
rt/forward.py:566).  PyTorch's counterpart is to keep TF32 off: a
float32 matmul on the card then runs in full float32, and cuDNN (whose
TF32 default is on) is pinned the same way.  ``resolve_device`` sets
both flags, so every path that resolves a device runs at full float32.

``graph_capture`` is the one way the package captures a CUDA graph
(samplers.StepGraph, ForwardModel.graphed).
"""

from __future__ import annotations

import contextlib
import gc

import torch

__all__ = ["resolve_device", "graph_capture"]


def resolve_device(device: str | torch.device) -> torch.device:
    """An explicit device -> ``torch.device``.

    ``"cuda"`` without a visible GPU raises: the port never falls back
    to the CPU behind the caller's back.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False")
    return dev


@contextlib.contextmanager
def graph_capture(graph: torch.cuda.CUDAGraph):
    """``torch.cuda.graph(graph)`` with Python's cyclic garbage collector
    run just before and kept off until the capture ends.  A graph that is
    reachable only through a reference cycle is destroyed whenever the
    collector runs; destroying a graph is not permitted while a stream
    captures, and it invalidates the capture under way."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()
