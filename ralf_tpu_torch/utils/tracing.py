"""Spans and counters at the port's layer boundaries, on the profiler's clock.

    with tracing.span("ar.decode"):
        ...
    tracing.count("h2d.pageable_bytes", n)

Tracing is on while `enable()` is in force or while a torch profiler is
recording (`profiler_recording`).  Off, `span` returns one shared no-op
context and `count` returns at once: no clock is read, nothing is allocated
and no `record_function` is opened.

On, a span keeps a `Record` in a bounded in-memory store (`LIMIT` records;
past it they are counted in `dropped`, not kept): its name, its id, its
parent's and its root's id (the stack of open spans is per thread: the
loader's producer is a thread), and its start and end in ns on the host
clock that Kineto stamps its host events with (`time.time_ns`, the Unix
epoch).  Under a profiler each span is also a `record_function(name)` range,
so that the trace shows it on the device operations' clock; the span's own
start and end are read outside that range.  `device=True` (given by a
caller whose work runs on the card) also records a pair of CUDA events on
the current stream around the span, read lazily (`Record.device_ms`, after
a synchronize).

The spans (README.md lists where each lives): `gen.condition`,
`gen.encode` (device), `ar.decode` with `ar.decode.layers` and
`ar.decode.sample` a step, `zoo.denoise` with `zoo.denoise.decoder` and
`zoo.denoise.posterior` a step (both device), `eval.violations`,
`data.loader_wait`, `data.retrieval`, `train.forward`, `train.backward`,
`train.clip`, and the roots `infer.batch` and `train.step`.  The counters:
`h2d.pageable_bytes` and `h2d.pinned_bytes` (`count_h2d`, the request path's
host-to-device copies), `attn.cross.plain` (an eval-mode cross-attention
with S != M that K10 does not take: `models.nn.MultiHeadAttention.attend`)
and `bn.eval.plain` (an eval-mode BatchNorm that K11 does not take:
`models.resnet.BatchNorm`).
`counters()` adds the port's existing counters read where they live: each
kernel wrapper's `.launches` (`launches.<wrapper>`) and
`parallel.mesh.COLLECTIVES` (`collectives.<kind>`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
import json
import os
import threading
import time
import types
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import profiler as _autograd_profiler

LIMIT = 100_000  # records kept; later ones are counted in `dropped`
SUMMARY_FILE = "trace_summary.json"  # what the CLIs' --trace writes

# (module, wrapper) of every kernel wrapper that counts its `.launches`
LAUNCH_COUNTERS = (
    ("ralf_tpu_torch.ops.encoder_attention", "encoder_attention"),
    ("ralf_tpu_torch.ops.encoder_attention", "encoder_self_attention"),
    ("ralf_tpu_torch.ops.encoder_ffn", "fused_ffn"),
    ("ralf_tpu_torch.ops.decode_attention", "decode_shared_attention"),
    ("ralf_tpu_torch.ops.decode_attention", "decode_shared_attention_q8"),
    ("ralf_tpu_torch.ops.decode_attention", "decode_shared_attention_q8mxu"),
    ("ralf_tpu_torch.ops.decode_attention", "decode_attention"),
    ("ralf_tpu_torch.ops.decode_attention", "decode_attention_q8"),
    ("ralf_tpu_torch.ops.assignment", "batched_lsa"),
    ("ralf_tpu_torch.ops.stream_sum", "stream_sum"),
    ("ralf_tpu_torch.ops.cross_attention", "cross_attention"),
    ("ralf_tpu_torch.ops.batchnorm_act", "batchnorm_act"),
)


# torch's own module flag, which `torch.profiler.profile` sets on entering or
# `start()` and clears on leaving or `stop()`; a torch without it never
# counts as profiling
_PROFILER = (_autograd_profiler if hasattr(_autograd_profiler, "_is_profiler_enabled")
             else types.SimpleNamespace(_is_profiler_enabled=False))


def profiler_recording() -> bool:
    """Whether a torch profiler is recording."""
    return _PROFILER._is_profiler_enabled


@dataclasses.dataclass
class Record:
    name: str
    id: int
    parent: Optional[int]  # the enclosing span's id on the same thread
    root: int  # the outermost enclosing span's id (its own for a root)
    start_ns: int  # host clock, Unix epoch (Kineto's)
    end_ns: int = 0
    events: Optional[tuple] = None  # (start, end) CUDA events of a device span

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Device time between the span's events (None without them); the
        events must have completed (read after a synchronize)."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


class Tracer:
    """The store behind the module's functions: records, counts, the
    per-thread stacks of open spans and the `enable()` flag."""

    def __init__(self, limit: int = LIMIT) -> None:
        self.limit = limit
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._records: list[Record] = []
            self._counts: dict[str, int] = defaultdict(int)
            self._ids = itertools.count(1)
            self.dropped = 0

    def on(self) -> bool:
        return self.enabled or _PROFILER._is_profiler_enabled

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str) -> Record:
        stack = self.stack()
        parent = stack[-1] if stack else None
        with self._lock:
            rid = next(self._ids)
        rec = Record(name, rid, parent.id if parent else None, parent.root if parent else rid,
                     time.time_ns())
        stack.append(rec)
        return rec

    def close(self, rec: Record) -> None:
        rec.end_ns = time.time_ns()
        self.stack().pop()
        with self._lock:
            if len(self._records) < self.limit:
                self._records.append(rec)
            else:
                self.dropped += 1

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self._counts[name] += n

    def records(self) -> list[Record]:
        with self._lock:
            return list(self._records)

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


TRACER = Tracer()


class _Span:
    """An open span while tracing is on; see the module docstring."""

    __slots__ = ("name", "device", "record", "range")

    def __init__(self, name: str, device: bool) -> None:
        self.name, self.device, self.range = name, device, None

    def __enter__(self) -> Record:
        self.record = rec = TRACER.open(self.name)
        if profiler_recording():
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        if self.device:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        if rec.events is not None:
            rec.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        TRACER.close(rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A context over one phase: a `Record` while tracing is on, else a
    shared no-op context.  `device`: also time it with CUDA events (the
    phase's work runs on the card)."""
    if TRACER.enabled or _PROFILER._is_profiler_enabled:  # TRACER.on(), inlined: the off path
        return _Span(name, device)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while tracing is on."""
    if TRACER.on():
        TRACER.add(name, int(n))


def count_h2d(x) -> None:
    """While tracing is on, count the bytes of `x`, about to be handed from
    host memory to the device: a numpy array (or anything numpy reads) as
    `h2d.pageable_bytes`, a CPU tensor as `h2d.pinned_bytes` when it is
    pinned and else as pageable; a tensor already on a device counts
    nothing.  Counted whatever the destination, so that the CPU path counts
    what the card's copies."""
    if not TRACER.on():
        return
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            return
        kind, n = ("pinned" if x.is_pinned() else "pageable"), x.numel() * x.element_size()
    else:
        kind, n = "pageable", np.asarray(x).nbytes
    TRACER.add(f"h2d.{kind}_bytes", n)


def enable() -> None:
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


def reset() -> None:
    """Drop every record and count kept so far."""
    TRACER.reset()


def records() -> list[Record]:
    return TRACER.records()


def counters() -> dict[str, int]:
    """The counts kept here, with each kernel wrapper's `.launches`
    (`launches.<wrapper>`) and the collectives issued (`collectives.<kind>`),
    read where they live."""
    out = TRACER.counts()
    for module_name, attr in LAUNCH_COUNTERS:
        out[f"launches.{attr}"] = getattr(importlib.import_module(module_name), attr).launches
    from ralf_tpu_torch.parallel import mesh

    out.update({f"collectives.{k}": v for k, v in mesh.COLLECTIVES.items()})
    return out


def summary() -> dict:
    """{'spans': {name: count, host ms median and p95, device ms median where
    the span has events}, 'counters': counters(), 'dropped': records not
    kept}.  Synchronizes first when a record holds CUDA events."""
    recs = records()
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    host, device = defaultdict(list), defaultdict(list)
    for r in recs:
        host[r.name].append(r.host_ms)
        if r.events is not None:
            device[r.name].append(r.device_ms)
    spans = {}
    for name, ms in host.items():
        spans[name] = {"count": len(ms), "host_ms_median": float(np.median(ms)),
                       "host_ms_p95": float(np.percentile(ms, 95))}
        if device[name]:
            spans[name]["device_ms_median"] = float(np.median(device[name]))
    return {"spans": spans, "counters": counters(), "dropped": TRACER.dropped}


def write_summary(directory: str) -> None:
    """`summary()` as `<directory>/trace_summary.json`, written by rank 0
    alone in a process group (a process outside one writes it)."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    with open(os.path.join(directory, SUMMARY_FILE), "w") as f:
        json.dump(summary(), f, indent=1, sort_keys=True)


@contextlib.contextmanager
def traced(on: bool = True):
    """An operator's traced run: with `on`, the store emptied and tracing
    enabled inside the block, disabled after it; nothing without."""
    if not on:
        yield
        return
    reset()
    enable()
    try:
        yield
    finally:
        disable()
