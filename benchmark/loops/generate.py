"""The `generate` window: one client in a closed loop sends requests of
`batch` canvases back to back, each with a fresh sampling seed, through the
calls `cli/inference.py` makes per batch:

    cond, _       = gen.build_condition(batch, rng, task)
    layout, seq   = gen.sample(cond, sampling, generator, return_tokens=True)
    torch.cuda.synchronize()
    calculate_violation(cond, seq, layout, tokenizer), tokens and layouts to host

A request runs from the canvases (in host memory) being handed to
`build_condition` until its layouts and violation counts are in host memory.
Every `greedy_every`-th request decodes greedily, so that the served tokens
of those requests can be judged against the plain reference after the
window.  The requests cycle over the pool's batches; nothing else runs
between them.  The window closes with the first request that ends
`seconds` or more after the window opened.

With `--trace 1` the window also times the family's phases with CUDA
events, and after it `trace_requests` more requests run under
torch.profiler for the device metrics and the breakdown."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.lib import manifest, trace as trace_mod
from benchmark.lib.spans import DeviceTimers, Spans
from benchmark.lib.weights import subseed


@dataclasses.dataclass
class Record:
    index: int
    batch: int  # index into the program's batches
    greedy: bool
    seconds: float
    tokens: np.ndarray  # [B, L]
    layout: dict  # {key: [B, S]}
    violations: dict
    states: np.ndarray | None = None  # what the family captured of a greedy request


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: str
    config: dict
    traffic: dict
    records: list
    window_s: float
    setup_s: float
    spans: Spans
    timers: DeviceTimers
    flops_per_layout: dict
    trace: object = None  # trace.DeviceTrace of the profiled requests
    launches: dict = dataclasses.field(default_factory=dict)  # kernel -> recorded calls
    info: dict = dataclasses.field(default_factory=dict)  # printed beside the checks

    @property
    def layouts(self) -> int:
        return sum(r.tokens.shape[0] for r in self.records)


def request(torch, prog, i: int, greedy: bool, seed: int, spans: Spans) -> Record:
    """One request of the window; see the module docstring."""
    from ralf_tpu_torch.eval.violations import calculate_violation

    b = i % len(prog.batches)
    batch = prog.batches[b]
    sampling = prog.greedy if greedy else prog.sampling
    rng = np.random.default_rng(subseed(seed, f"condition{i}"))
    generator = torch.Generator(device=prog.device).manual_seed(subseed(seed, f"sample{i}"))
    with prog.capture(greedy) as captured:
        t = time.perf_counter()
        with spans.span("condition"):
            cond, _ = prog.gen.build_condition(batch, rng, task=prog.task)
        with spans.span("sample"):
            layout, seq = prog.gen.sample(cond, sampling, generator, return_tokens=True,
                                          **prog.sample_kwargs)
        with spans.span("sync"):
            sync(torch, prog.device)
        with spans.span("violations"):
            tokens = seq.cpu().numpy()
            arrays = layout.numpy()
            v = calculate_violation(cond, tokens, layout, prog.tok)
        seconds = time.perf_counter() - t
    states = None if captured is None else torch.stack(captured).cpu().numpy()
    return Record(i, b, greedy, seconds, tokens, arrays, v, states)


def is_greedy(traffic: dict, i: int) -> bool:
    k = traffic.get("greedy_every", 0)
    return k > 0 and i % k == k - 1


def run(torch, cell, seed: int, seconds: float, traced: bool, device, t_start: float):
    """(Run, the numbers compared, the device's peak memory) of one run."""
    config, traffic = cell.config, cell.traffic
    fam = manifest.family(config["family"])
    prog = fam.build(torch, config, traffic, seed, device)
    spans = Spans()
    timers = DeviceTimers(torch, spans)
    for obj, method, name in fam.timed_methods(prog):
        timers.wrap(obj, method, name)
    modes = {False} | ({True} if traffic.get("greedy_every", 0) else set())
    for greedy in sorted(modes):  # every shape and path the window takes, built and warm
        request(torch, prog, -1, greedy, seed, Spans())
    sync(torch, device)
    setup_s = time.perf_counter() - t_start

    timers.enabled = traced and device.type == "cuda"  # CUDA events exist on the card only
    records, t0 = [], time.perf_counter()
    while True:
        i = len(records)
        records.append(request(torch, prog, i, is_greedy(traffic, i), seed, spans))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    timers.enabled = False
    sync(torch, device)
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    result = Run(cell.name, config, traffic, records, window_s, setup_s, spans, timers,
                 fam.flops_per_layout(config))
    if traced:
        timers.spans = Spans()
        timers.spans.annotate = True
        result.trace, result.launches = profile(torch, prog, fam, traffic, seed, len(records),
                                                timers.spans)
    timers.restore()
    info, checks = fam.check(torch, prog, records, seed)
    result.info = {"request_ms": [round(r.seconds * 1e3, 1) for r in records], **info}
    return result, checks, memory


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(torch, prog, fam, traffic: dict, seed: int, first: int, spans: Spans):
    """(DeviceTrace, recorded kernel calls) of `trace_requests` more requests
    under torch.profiler; `spans` annotates the host's phases."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    n = traffic.get("trace_requests", 2)
    with fam.recorded_launches(prog) as launches:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace_mod.WINDOW):
                for i in range(first, first + n):
                    with spans.span("request"):
                        request(torch, prog, i, is_greedy(traffic, i), seed, spans)
    return trace_mod.read(torch, prof, n), launches
