"""Device intervals from a torch.profiler trace: which events ran on the
card, the length of their union and the idle gaps between its pieces (the
arithmetic of ``chip_smoke.py``'s ``is_device_event`` and
``busy_and_gaps``, copied), and the breakdown the result line carries."""

from __future__ import annotations

import collections


def busy_and_gaps(intervals):
    """(busy time, [(gap start, gap end)]) of device intervals
    [(start, end)]: the length of their union and the idle stretches
    between its pieces, in the intervals' unit."""
    busy, gaps = 0.0, []
    cur_s, cur_e = None, None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


class Trace:
    """The events of one traced stretch: ``device`` [(name, start_us,
    end_us)] of the operations that ran on the card, ``host`` the same of
    the host's operations, ``window_us`` from the first event's start to
    the last one's end."""

    def __init__(self, device, host):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        ends = [e for ev in (device, host) for e in ev]
        self.window_us = (max(e[2] for e in ends) - min(e[1] for e in ends)
                          if ends else 0.0)

    @classmethod
    def record(cls, fn):
        """Trace ``fn()`` and a synchronise with torch.profiler (host and
        CUDA activity)."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev, host = [], []
        for e in prof.events():
            rec = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith("stage:"):
                    dev.append(rec)
            else:
                host.append(rec)
        return cls(dev, host)

    def busy_us(self) -> float:
        return busy_and_gaps([(s, e) for _, s, e in self.device])[0]

    def gaps(self):
        return busy_and_gaps([(s, e) for _, s, e in self.device])[1]

    def time_us(self, match) -> tuple[float, int]:
        """(device us, count) of the operations whose name ``match``
        accepts."""
        sel = [e - s for name, s, e in self.device if match(name)]
        return sum(sel), len(sel)

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the n operations that took most device
        time, summed by name."""
        by = collections.Counter()
        for name, s, e in self.device:
            by[name[:120]] += (e - s) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def top_gaps(self, n: int = 10):
        """[[host activity, seconds]] of the n longest idle gaps, each
        named by the innermost host operation running at its middle."""
        out = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            live = [h for h in self.host if h[1] <= mid <= h[2]]
            name = max(live, key=lambda h: h[1])[0] if live else "host idle"
            out.append([name[:120], (b - a) * 1e-6])
        return out
