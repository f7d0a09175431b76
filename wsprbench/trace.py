"""The traced part of a ``--trace 1`` run: a torch.profiler trace over a
fixed number of requests, kept in memory and reduced to device intervals.

``Tracer.boundary(i)`` is called by a driver before request i of the
window; the trace covers requests [start, start + n). Its wall interval is
a ``record_function`` range around them, so host and device events share
one clock. Device events (kernels, copies, sets) are clipped to it.
Copy sizes are read only where a reader asks (``TraceView.copy_bytes``):
the in-memory events of the installed PyTorch carry none, so they come
from the trace's export.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

RANGE = "wsprbench.traced"


@dataclass
class DeviceEvent:
    name: str
    start: int          # ns, the trace's clock
    end: int

    @property
    def kind(self) -> str:
        n = self.name.lower()
        if n.startswith("memcpy"):
            return "memcpy"
        if n.startswith("memset"):
            return "memset"
        return "kernel"


@dataclass
class TraceView:
    """What a per-layer reader reads: the device events inside the traced
    wall interval, that interval, the requests and channel-windows it
    covers, and the host's ops (for labelling gaps)."""
    t0: int
    t1: int
    requests: int
    windows: int
    events: list = field(default_factory=list)
    host: list = field(default_factory=list)      # (name, start, end)
    prof: object = field(default=None, repr=False)
    _copy_bytes: dict | None = field(default=None, repr=False)

    def copy_bytes(self) -> dict:
        """Bytes by copy kind (the event's name) of the copies that start
        inside the traced range."""
        if self._copy_bytes is None:
            self._copy_bytes = _copy_bytes_from_export(self.prof)
        return self._copy_bytes

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def kernels(self, pattern: str | None = None) -> list:
        rx = re.compile(pattern) if pattern else None
        return [e for e in self.events if e.kind == "kernel"
                and (rx is None or rx.search(e.name))]

    def busy_s(self) -> float:
        """Seconds in which some device event ran (union of intervals)."""
        total, cur_s, cur_e = 0, None, None
        for e in sorted(self.events, key=lambda e: e.start):
            if cur_e is None or e.start > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = e.start, e.end
            else:
                cur_e = max(cur_e, e.end)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def gaps(self) -> list:
        """(start, end) of every idle interval inside the window."""
        out, last = [], self.t0
        for e in sorted(self.events, key=lambda e: e.start):
            if e.start > last:
                out.append((last, e.start))
            last = max(last, e.end)
        if self.t1 > last:
            out.append((last, self.t1))
        return out

    def breakdown(self) -> dict:
        by = {}
        for e in self.events:
            key = e.name if e.kind == "kernel" else e.name.split(" (")[0]
            by[key] = by.get(key, 0) + (e.end - e.start)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        labelled = []
        for a, b in gaps:
            mid = (a + b) // 2
            cover = [h for h in self.host if h[1] <= mid <= h[2]
                     and h[0] != RANGE]
            name = min(cover, key=lambda h: h[2] - h[1])[0] if cover \
                else "no host op"
            labelled.append([name, (b - a) / 1e9])
        return {"device_ops": [[_short(k), v / 1e9] for k, v in ops],
                "idle_gaps": labelled}


def _short(name: str) -> str:
    """A kernel's name without its namespace prefix and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def _copy_bytes_from_export(prof) -> dict:
    """Bytes by copy kind inside the traced range, from the trace's export
    (written to a temporary file in TMPDIR and removed at once)."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    rng = [e for e in events if e.get("name") == RANGE
           and e.get("cat") != "gpu_user_annotation"]
    if not rng:
        return {}
    t0 = float(rng[0]["ts"])
    t1 = t0 + float(rng[0].get("dur", 0))
    out = {}
    for e in events:
        if (e.get("cat") == "gpu_memcpy" and "bytes" in e.get("args", {})
                and t0 <= float(e["ts"]) < t1):
            out[e["name"]] = out.get(e["name"], 0) + int(e["args"]["bytes"])
    return out


class Tracer:
    """Profiles requests [start, start + n) of a window when enabled."""

    def __init__(self, enabled: bool, start: int, n: int):
        self.enabled, self.start, self.n = enabled, start, n
        self.prof = None
        self.rng = None
        self.view: TraceView | None = None
        self.windows_per_request = 0

    def prime(self, sync) -> None:
        """Start and stop the profiler once in set-up: its first start
        takes seconds, which the window must not pay."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            sync()

    def boundary(self, i: int, sync) -> None:
        if not self.enabled or self.view is not None:
            return
        if i == self.start and self.prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            sync()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.rng = torch.profiler.record_function(RANGE)
            self.rng.__enter__()
        elif self.prof is not None and i == self.start + self.n:
            self.stop(sync, self.n)

    def stop(self, sync, requests: int) -> None:
        """End the trace after ``requests`` requests (the window may close
        before start + n)."""
        if self.prof is None or self.view is not None:
            return
        self.rng.__exit__(None, None, None)
        sync()
        self.prof.__exit__(None, None, None)
        self.view = self._reduce(requests)
        self.prof = None

    def _reduce(self, requests: int) -> TraceView:
        from torch.autograd import DeviceType
        evs = self.prof.profiler.kineto_results.events()
        t0 = t1 = None
        dev, host = [], []
        for e in evs:
            name = e.name()
            s, d = int(e.start_ns()), int(e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if name != RANGE:          # its device-side annotation
                    dev.append(DeviceEvent(name, s, s + d))
            else:
                if name == RANGE:
                    t0, t1 = s, s + d
                host.append((name, s, s + d))
        if t0 is None:
            raise RuntimeError("the traced range is missing from the trace")
        clipped = [DeviceEvent(e.name, max(e.start, t0), min(e.end, t1))
                   for e in dev if e.end > t0 and e.start < t1]
        return TraceView(t0, t1, requests, requests * self.windows_per_request,
                         clipped, host, self.prof)
