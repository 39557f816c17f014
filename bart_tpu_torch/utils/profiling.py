"""The program's tracing: spans around its layers, counters, each sampler
block's device timeline, stage timing and device traces (port of
bart_tpu/utils/profiling.py, extended).

* ``span(name)``: a context manager around one layer's work, and
  ``spanned(name)`` the same as a decorator.  Off by default: with no
  torch profiler recording and the recorder off it returns a shared null
  context.  Under a profiler it is a ``record_function`` range named
  ``stage:<name>``, on the device trace's clock; with the recorder on
  (``recording(True)``) it adds its ``time.perf_counter()`` duration to
  the recorder's count and total for ``name``.  It never synchronises:
  spans open inside CUDA-graph captures.
* ``count(name, n)`` / ``counters()``: integer counters, always counted
  (``graphs.captures``, ``kernels.builds``, ``kernels.loads``).
* ``block_mark(device, k)``: with the recorder on, a sampler block
  marks its entry (k = 0), the moment just before its first replay (1)
  and just after its last (2).  On the host clock the marks give the
  recorder's spans ``sampler.draws`` (0 to 1) and ``sampler.replays``
  (1 to 2), which open no range under a profiler; on a card each mark
  is also a timing event on the device's current stream, and the
  recorder turns a block's events into three device stretches (the
  draws, the replays and the gap since the previous block's end) once
  they have completed, never by a synchronise of its own.
* ``stage_timer``: wall time per pipeline stage (the stage's method
  opens its span), appended to a JSON-lines file.  With ``device`` a
  CUDA device, the stage's end waits for the card
  (``torch.cuda.synchronize``), so a stage's seconds include the device
  work it queued.
* ``device_trace``: a ``torch.profiler`` trace of the run (host and, on a
  card, device activity) written to a directory as a Chrome trace, with
  the recorder on and its summary beside it (``--profile <dir>`` on the
  CLI).

Spans (the layer each times): ``pressure``, ``abundances``,
``atmosphere``, ``linelist``, ``opacity``, ``forward_setup`` (the
pipeline's stages); ``kernels.load`` (a kernel's build and load);
``sampler.init``, ``sampler.capture``, ``forward.capture`` (the state and
the graphs' warm-ups and captures); ``sampler.step`` (one step as a graph
captures it); ``forward`` with ``forward.profiles`` (holding
``forward.radii``), ``forward.rows``, ``forward.spectrum`` and
``forward.bands`` inside it; ``sampler.draws`` and ``sampler.replays``
(a block's two parts, from its marks: on the host clock only).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import time

import torch
from torch.profiler import record_function

__all__ = ["span", "spanned", "recording", "count", "counters",
           "block_mark", "recorder", "Recorder", "stage_timer",
           "device_trace"]

#: the resolved blocks kept
KEEP = 4096
#: the host-clock spans between a block's marks 0-1 and 1-2
_BLOCK_SPANS = ("sampler.draws", "sampler.replays")
_NULL = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled


class Recorder:
    """What the program recorded while the recorder was on: per span name
    [count, total seconds on the ``time.perf_counter`` clock]; the
    counters (counted always); the blocks' device stretches, ``blocks``:
    (draws ms, replays ms, ms since the previous block's end or None) of
    the last KEEP resolved blocks, ``nblocks`` resolved in all."""

    def __init__(self):
        self.on = False
        self.spans: dict[str, list] = {}
        self.counts: collections.Counter = collections.Counter()
        self.blocks: collections.deque = collections.deque(maxlen=KEEP)
        self.nblocks = 0
        self._open: list | None = None     # the open block's marks
        self._pending: collections.deque = collections.deque()
        self._last = None                   # the last resolved block's end

    def add(self, name: str, t0: float, t1: float) -> None:
        rec = self.spans.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += t1 - t0

    def mark(self, k: int, t: float, event) -> None:
        """Mark ``k`` of a block (0 entry, 1 first replay, 2 last replay
        done) at ``t`` on the host clock, with its timing event (None off
        a card); a mark out of that order is dropped."""
        if k == 0:
            self.resolve()
            self._open = [(t, event)]
        elif self._open is not None and len(self._open) == k:
            self.add(_BLOCK_SPANS[k - 1], self._open[-1][0], t)
            self._open.append((t, event))
            if k == 2:
                if event is not None:
                    self._pending.append(tuple(e for _, e in self._open))
                self._open = None

    def resolve(self) -> None:
        """Turn the blocks whose events have all completed into their
        stretches, in order; a block still running waits."""
        while self._pending and self._pending[0][2].query():
            a, b, c = self._pending.popleft()
            gap = None if self._last is None else self._last.elapsed_time(a)
            self.blocks.append((a.elapsed_time(b), b.elapsed_time(c), gap))
            self.nblocks += 1
            self._last = c

    def snapshot(self) -> dict:
        """{"spans": {name: (count, total s)}, "counters": {name: n},
        "blocks": [(draws, replays, between ms)], "nblocks": n}, the
        blocks resolved first."""
        self.resolve()
        return {"spans": {k: tuple(v) for k, v in self.spans.items()},
                "counters": dict(self.counts), "blocks": list(self.blocks),
                "nblocks": self.nblocks}

    def clear(self) -> None:
        """Forget the spans and blocks (the counters stay)."""
        self.spans.clear()
        self.blocks.clear()
        self.nblocks = 0
        self._open, self._last = None, None
        self._pending.clear()


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process's recorder."""
    return _RECORDER


def recording(on: bool | None = None) -> bool:
    """Switch the recorder on or off (``on`` None: leave it); returns
    whether it was on before."""
    was = _RECORDER.on
    if on is not None:
        _RECORDER.on = bool(on)
    return was


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, rf):
        self.name, self.rf = name, rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _RECORDER.add(self.name, self.t0, t1)
        return False


def span(name: str):
    """The span ``name`` (see the module's docstring)."""
    prof = _profiler_on()
    if not _RECORDER.on:
        return record_function("stage:" + name) if prof else _NULL
    return _Span(name, record_function("stage:" + name) if prof else None)


def spanned(name: str):
    """Decorator: the function's calls inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _RECORDER.counts[name] += n


def counters() -> dict:
    """{name: n} of every counter."""
    return dict(_RECORDER.counts)


def block_mark(device: torch.device, k: int) -> None:
    """With the recorder on, mark ``k`` of a sampler block (0 at its
    entry, 1 before its first replay, 2 after its last): the host clock's
    time and, with ``device`` a CUDA device, a timing event on its
    current stream."""
    if not _RECORDER.on:
        return
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
    _RECORDER.mark(k, time.perf_counter(), event)


@contextlib.contextmanager
def stage_timer(name: str, logfile: str | None = None, verbose: bool = True,
                device: torch.device | None = None):
    """Time the stage ``name`` (its method opens the span)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        rec = {"stage": name, "wall_s": round(dt, 3), "ts": time.time()}
        if verbose:
            print(f"[bart_tpu_torch] stage {name}: {dt:.2f}s")
        if logfile:
            with open(logfile, "a") as f:
                f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device: torch.device | None = None):
    """A torch.profiler trace of the block, written to
    ``trace_dir/trace.json``, with the recorder on and its totals written
    to ``trace_dir/spans.json`` ({"spans": {name: [count, seconds]},
    "counters", "blocks": [[draws, replays, between ms]]}); a no-op when
    trace_dir is None.  The CUDA activity is recorded when ``device`` is
    a CUDA device."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    was = recording(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        recording(was)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    snap = _RECORDER.snapshot()
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump({"spans": snap["spans"],
                   "counters": snap["counters"], "blocks": snap["blocks"]},
                  f, indent=1)
