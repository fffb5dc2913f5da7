"""Host spans and device timers that the harness puts around the calls it
makes into the program.

`Spans.span(name)` times a host stretch by the host clock; while a profile
is being taken it also marks it as a `record_function` range, so that the
trace can say what the host was doing during an idle gap.  `DeviceTimers`
wraps a method of one object with CUDA events on the current stream: the
device time between the method's first and last launch, read after the
window.  Neither changes what the program computes."""

from __future__ import annotations

import contextlib
import functools
import statistics
import time
from collections import defaultdict


class Spans:
    def __init__(self) -> None:
        self.ms: dict[str, list[float]] = defaultdict(list)
        self.annotate = False  # record_function ranges too (during a profile)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function

            ctx = record_function(name)
        t = time.perf_counter()
        with ctx:
            yield
        self.ms[name].append((time.perf_counter() - t) * 1e3)

    def median(self, name: str):
        vals = self.ms.get(name)
        return statistics.median(vals) if vals else None


class DeviceTimers:
    """CUDA-event timers around methods, while `enabled`; `ms(name)` lists
    the device ms of each timed call, in call order (read after a
    synchronize).  Each call is also a host span of `spans` under `name`."""

    def __init__(self, torch, spans: Spans) -> None:
        self.torch = torch
        self.spans = spans
        self.events: dict[str, list] = defaultdict(list)
        self.enabled = False
        self._undo = []

    def wrap(self, obj, method: str, name: str) -> None:
        """Time `obj.method` under `name` (an attribute on the instance, which
        shadows the class's method; `restore` removes it)."""
        inner = getattr(obj, method)
        torch = self.torch

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            with self.spans.span(name):
                if not self.enabled:
                    return inner(*args, **kwargs)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = inner(*args, **kwargs)
                b.record()
            self.events[name].append((a, b))
            return out

        setattr(obj, method, timed)
        self._undo.append((obj, method))

    def restore(self) -> None:
        for obj, method in self._undo:
            delattr(obj, method)
        self._undo.clear()

    def ms(self, name: str) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]
