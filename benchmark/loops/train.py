"""The `train` window: the training step of a configuration's family
(`families/<family>_train.py`) driven as `Trainer.fit` drives it, one batch
of the port's loader after another, through the family's `step`:

    batch          = next(loader)                 the loader's wait
    inputs, target = gen.preprocess(batch, rng)
    trainer.train_step(state, inputs, target)     forward, backward, clip, AdamW

Set-up builds the one trainer and drives it through the first
`checked_steps` steps with the window's own call and feed, recording what
the comparison needs (the family's `recording`, `first_gradient`,
`change`), then `warm_steps` more; the window then runs steps until
`seconds` have passed since it opened and closes with a synchronize, so
that its rate is the samples stepped over all the window's time.

With `--trace 1`, `trace_steps` more steps run under torch.profiler after
the window, for the device metrics, the optimizer's own record and the
breakdown."""

from __future__ import annotations

import dataclasses
import time

from benchmark.lib import manifest, trace as trace_mod
from benchmark.lib.spans import Spans


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: str
    config: dict
    traffic: dict
    steps: int
    samples: int
    window_s: float
    setup_s: float
    spans: Spans
    flops_per_sample: float
    trace: object = None  # trace.DeviceTrace of the profiled steps
    info: dict = dataclasses.field(default_factory=dict)  # printed beside the checks

    @property
    def records(self) -> range:
        return range(self.steps)


def family(config: dict):
    return manifest.family(f"{config['family']}_train")


def run(torch, cell, seed: int, seconds: float, traced: bool, device, t_start: float):
    """(Run, the numbers compared, the device's peak memory) of one run."""
    config, traffic = cell.config, cell.traffic
    fam = family(config)
    prog = fam.build(torch, config, traffic, seed, device)
    setup = Spans()
    rows, readings, masks = checked(torch, fam, prog, traffic, setup)
    for _ in range(traffic.get("warm_steps", 1)):
        fam.step(prog, setup)
    sync(torch, device)
    setup_s = time.perf_counter() - t_start

    spans, steps, t0 = Spans(), 0, time.perf_counter()
    while True:
        fam.step(prog, spans)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(torch, device)
    window_s = time.perf_counter() - t0
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    result = Run(cell.name, config, traffic, steps, steps * traffic["batch"], window_s,
                 setup_s, spans, fam.flops_per_sample(config))
    if traced:
        result.trace = profile(torch, prog, fam, traffic)
    info, checks = fam.check(torch, prog, readings, rows, masks)
    result.info = {"step_ms": round(window_s * 1e3 / steps, 2), **info}
    return result, checks, memory


def checked(torch, fam, prog, traffic: dict, spans: Spans):
    """(the steps' rows, the program's readings, the dropout masks) of the
    first `checked_steps` steps: their losses, the first step's clipped
    gradient and the change after the last."""
    rows, readings = [], {"loss": []}
    with fam.recording(torch, prog) as masks:
        for k in range(traffic["checked_steps"]):
            if k:
                fam.next_step(masks)
            rows.append(fam.step(prog, spans))
            readings["loss"].append(float(prog.metrics["loss"]))
            if k == 0:
                readings["grad"] = fam.first_gradient(torch, prog)
        readings["change"] = fam.change(torch, prog)
    return rows, readings, masks


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(torch, prog, fam, traffic: dict):
    """The DeviceTrace of `trace_steps` more steps under torch.profiler,
    the host's phases annotated."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    n = traffic.get("trace_steps", 3)
    spans = Spans()
    spans.annotate = True
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace_mod.WINDOW):
            for _ in range(n):
                fam.step(prog, spans)
            sync(torch, prog.device)
    return trace_mod.read(torch, prof, n)
