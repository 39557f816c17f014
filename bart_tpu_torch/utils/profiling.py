"""Stage timing and device tracing (port of bart_tpu/utils/profiling.py).

* ``stage_timer``: wall time per pipeline stage, appended to a
  JSON-lines file.  With ``device`` a CUDA device, the stage's end waits
  for the card (``torch.cuda.synchronize``), so a stage's seconds include
  the device work it queued;
* ``device_trace``: a ``torch.profiler`` trace of the run (host and,
  on a card, device activity) written to a directory as a Chrome trace,
  the counterpart of bart_tpu's ``jax.profiler`` trace (``--profile
  <dir>`` on the CLI).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["stage_timer", "device_trace"]


@contextlib.contextmanager
def stage_timer(name: str, logfile: str | None = None, verbose: bool = True,
                device: torch.device | None = None):
    t0 = time.time()
    try:
        yield
    finally:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        rec = {"stage": name, "wall_s": round(dt, 3), "ts": time.time()}
        if verbose:
            print(f"[bart_tpu_torch] stage {name}: {dt:.2f}s")
        if logfile:
            with open(logfile, "a") as f:
                f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device: torch.device | None = None):
    """A torch.profiler trace of the block, written to
    ``trace_dir/trace.json`` (no-op when trace_dir is None).  The CUDA
    activity is recorded when ``device`` is a CUDA device."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
