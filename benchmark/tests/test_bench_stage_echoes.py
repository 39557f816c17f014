"""The existing per-layer readers on synthetic traces with and without
the program's ``stage:`` spans: their device echoes and their host ranges
leave every reading unchanged."""

import types

import pytest

from benchtools import HERE  # noqa: F401  (puts bm on the path)
from bm import manifest
from bm.trace import Trace


class _Event:
    def __init__(self, name, s, e, cuda):
        from torch.autograd import DeviceType

        self.name = name
        self.time_range = types.SimpleNamespace(start=s, end=e)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU


def _trace(monkeypatch, events):
    """Trace.record over a stand-in profiler that yields ``events``."""
    import torch
    import torch.profiler

    class Prof:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return Trace.record(lambda: None)


EXISTING = ["setup.table_s", "setup.capture_s", "sampler.device_ms",
            "forward.rest_ms", "forward.device_ops", "fused_eclipse_roofline",
            "fused_eclipse_folded_roofline", "device.idle_share", "step.mfu"]


@pytest.mark.parametrize("metric", EXISTING)
def test_existing_readers_ignore_stage_echoes(monkeypatch, metric):
    """The nine existing readers read the same with and without the
    device echoes of the program's ``stage:`` spans in the traces."""
    block = [_Event("rand", 0, 2, True), _Event("fused_eclipse_kernel",
                                                3, 20, True),
             _Event("fused_eclipse_folded_mma_kernel", 21, 60, True),
             _Event("add", 62, 63, True), _Event("cudaGraphLaunch", 1, 5,
                                                 False)]
    fwd = [_Event("fused_eclipse_kernel", 0, 17, True),
           _Event("mul", 18, 19, True), _Event("cudaGraphLaunch", 0, 1,
                                                False)]
    # the echoes on the device, and a span's own range on the host
    # inside the traced call's operations
    echoes = [_Event("stage:forward", -5, 90, True),
              _Event("stage:forward.spectrum", 1, 70, True),
              _Event("stage:forward.rows", 1.5, 4.5, False)]
    read = manifest.reader(metric)
    got = []
    for extra in ([], echoes):
        ctx = {"spans": {"setup.table": 1.5, "setup.capture": 2.0},
               "blocks": _trace(monkeypatch, block + extra),
               "forward": _trace(monkeypatch, fwd + extra),
               "steps": 2, "forwards": 1, "step_s": 4e-5, "chains": 512,
               "bounds": {"fused_eclipse": 2e-6,
                          "fused_eclipse_folded": 1e-5}}
        got.append(read(ctx))
    assert got[0] is not None and got[0] == got[1]
