"""The profiler's trace of a few requests or steps, reduced to what the
per-layer metrics and the result's `breakdown` read.

Device records are taken straight from Kineto's events (as
`chip_smoke.py::device_events` does): `key_averages()` builds a Python
event for every host record first, some 20 s for a request of 24
thousand launches.  The window is the `bench.window` host range that the
loop opens around the traced work; busy time is the union of the device
operations' intervals inside it (`costs.idle`)."""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from benchmark.costs import idle

WINDOW = "bench.window"


@dataclasses.dataclass
class DeviceTrace:
    window: tuple[float, float]  # ns, host clock of the profiler
    ops: list  # (start_ns, end_ns, name) of every device operation in the window
    host: list  # (start_ns, end_ns, name) of the harness's host ranges
    units: int  # requests or steps inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return idle.busy([(s, e) for s, e, _ in self.ops], *self.window) / 1e9

    def kernel_s(self, match) -> float:
        """Seconds of the device operations whose name `match` accepts."""
        return sum(e - s for s, e, n in self.ops if match(n)) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name in self.ops:
            by[name[:120]] += (e - s) / 1e9
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_by_host(self, n: int = 10) -> list:
        """Idle device time summed by the innermost host range that covers
        each gap's middle ('outside' where none does), the longest first."""
        by = defaultdict(float)
        for s, e in idle.gaps([(a, b) for a, b, _ in self.ops], *self.window):
            mid = (s + e) / 2
            inside = [(b - a, name) for a, b, name in self.host
                      if a <= mid <= b and name != WINDOW]
            by[min(inside)[1] if inside else "outside"] += (e - s) / 1e9
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def read(torch, prof, units: int) -> DeviceTrace:
    """The DeviceTrace of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    ops, host, window, names = [], [], None, {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        raw = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            if raw not in names:
                names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), names[raw]))
        elif e.is_user_annotation():
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), raw)
            if raw == WINDOW:
                window = span[:2]
            host.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    ops = [o for o in ops if o[1] > window[0] and o[0] < window[1]]
    return DeviceTrace(window=window, ops=ops, host=host, units=units)
