"""The readers of the program's own spans and counters (`lib/program.py` and
seven `metrics/*.py`): on a synthetic DeviceTrace and synthetic records
they give what their docstrings promise; on an untraced run, or a program
without `ralf_tpu_torch/utils/tracing.py`, they give nothing; and tiny
traced runs on the CPU report the host-side ones in their own cells."""

from __future__ import annotations

import sys
import time
import types

import pytest
import torch

from benchmark import run as brun
from benchmark.lib import manifest
from benchmark.lib.trace import DeviceTrace
from benchmark.tests.tiny import tiny_cell

ROOT = manifest.BENCH_DIR.parent
SEED = 2**31 + 11
NEW = {"decode_busy_share": "ralf-cgl.uncond-b1024", "decode_host_ms": "ralf-cgl.uncond-b1024",
       "h2d_pageable_mb": "ralf-cgl.uncond-b1024",
       "denoise_decoder_ms": "layoutdm-cgl.uncond-b1024",
       "denoise_posterior_ms": "layoutdm-cgl.uncond-b1024",
       "forward_ms.train": "ralf-cgl.train-b32", "backward_ms.train": "ralf-cgl.train-b32"}
MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def fresh_tracer():
    from ralf_tpu_torch.utils import tracing

    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.reset()


def read(name, run):
    return manifest.metric_reader(name).read(run)


def synthetic_run(units=2):
    """Device operations at [10, 30) and [60, 70) ms (two overlapping),
    decode spans at [5, 45) and [50, 80) ms, train spans of 2, 4, 9 ms and
    a harness range named like none of them."""
    ops = [(10 * MS, 20 * MS, "k"), (15 * MS, 30 * MS, "k"), (60 * MS, 70 * MS, "k")]
    host = [(0, 100 * MS, "bench.window"), (5 * MS, 45 * MS, "ar.decode"),
            (50 * MS, 80 * MS, "ar.decode"), (0, 90 * MS, "decode")]
    for i, ms in enumerate((2, 4, 9)):
        host.append((i * 10 * MS, (i * 10 + ms) * MS, "train.forward"))
        host.append((i * 10 * MS, (i * 10 + 2 * ms) * MS, "train.backward"))
    return types.SimpleNamespace(trace=DeviceTrace(window=(0, 100 * MS), ops=ops, host=host,
                                                   units=units))


def test_every_new_metric_is_registered_for_its_one_cell():
    m = manifest.Manifest(ROOT)
    entries = {e["name"]: e for e in m.data["per_layer"]}
    for name, cell in NEW.items():
        e, reader = entries[name], manifest.metric_reader(name)
        assert e["workloads"] == [cell]
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (e["layer"], e["unit"], e["moves"])
        for w in m.data["workloads"]:
            assert (name in {p["name"] for p in m.cell(w["name"]).per_layer}) == (w["name"] == cell)


def test_readers_of_the_trace_on_a_synthetic_device_trace():
    run = synthetic_run()
    # busy 20 ms of the first span, 10 of the second, over 70 ms of spans
    assert read("decode_busy_share", run) == pytest.approx(100.0 * 30 / 70)
    assert read("decode_host_ms", run) == pytest.approx(70 / 2)
    assert read("forward_ms.train", run) == pytest.approx(4.0)
    assert read("backward_ms.train", run) == pytest.approx(8.0)
    # the breakdown gives an idle gap to the innermost range: the program's span
    # inside the harness's own (gaps [0, 10), [30, 60) and [70, 100) ms)
    idle = {name: s * 1e3 for name, s in run.trace.idle_by_host()}
    assert idle == pytest.approx({"ar.decode": 40.0, "decode": 30.0})


class FakeEvent:
    def __init__(self, ms: float) -> None:
        self.ms = ms

    def elapsed_time(self, end: "FakeEvent") -> float:
        return end.ms - self.ms


def test_readers_of_the_programs_store_on_synthetic_records(fresh_tracer, monkeypatch):
    tracing = fresh_tracer
    Record = tracing.Record
    recs = [Record("zoo.denoise.decoder", i, None, i, 0, 1, (FakeEvent(0.0), FakeEvent(d)))
            for i, d in enumerate((3.0, 5.0, 4.0))]
    recs += [Record("zoo.denoise.posterior", 9, None, 9, 0, 1, (FakeEvent(1.0), FakeEvent(2.5))),
             Record("zoo.denoise.posterior", 10, None, 10, 0, 1)]  # no events: not read
    monkeypatch.setattr(tracing, "records", lambda: recs)
    run = synthetic_run(units=2)
    assert read("denoise_decoder_ms", run) == pytest.approx(12.0 / 2)
    assert read("denoise_posterior_ms", run) == pytest.approx(1.5 / 2)

    tracing.enable()
    tracing.count_h2d(torch.zeros(1000, dtype=torch.uint8).numpy())
    tracing.disable()
    assert read("h2d_pageable_mb", run) == pytest.approx(1000 / 2 / 1e6)


def test_no_trace_or_no_tracing_module_reads_nothing(monkeypatch):
    untraced = types.SimpleNamespace(trace=None)
    assert all(read(name, untraced) is None for name in NEW)
    empty = types.SimpleNamespace(trace=DeviceTrace((0, 1), [], [(0, 1, "bench.window")], 1))
    assert all(read(name, empty) is None for name in NEW)
    # the parent's program: no utils.tracing to import
    monkeypatch.setitem(sys.modules, "ralf_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(sys.modules["ralf_tpu_torch.utils"], "tracing")
    run = synthetic_run()
    for name in ("h2d_pageable_mb", "denoise_decoder_ms", "denoise_posterior_ms"):
        assert read(name, run) is None, name


def tiny_traced(config, traffic, **overrides):
    cell = tiny_cell(config, traffic, **overrides)
    real = manifest.Manifest(ROOT).cell(f"{config}.{traffic}")
    cell.end_to_end, cell.per_layer = real.end_to_end, real.per_layer
    return brun.execute(torch, cell, SEED, 0.3, True, torch.device("cpu"), time.perf_counter())


def test_tiny_traced_runs_report_the_host_side_readers_in_their_own_cells():
    """On the CPU the trace has no device operation and no CUDA event: the
    busy share and the denoising loop's device ms have nothing to read."""
    res = tiny_traced("ralf-cgl", "uncond-b1024")
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["decode_host_ms"]["value"] > 0 and "decode_busy_share" not in got
    B = 4  # tiny_cell's batch: canvases uint8 [B, 64, 48, 4] and more
    assert got["h2d_pageable_mb"]["value"] * 1e6 > B * 64 * 48 * 4
    assert not set(got) & {"denoise_decoder_ms", "forward_ms.train"}

    res = tiny_traced("layoutdm-cgl", "uncond-b1024")
    assert res["correct"], res["checks"]
    assert not set(res["metrics"]) & set(NEW)

    res = tiny_traced("ralf-cgl", "train-b32", canvases=8, batch=8)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["forward_ms.train"]["value"] > 0 and got["backward_ms.train"]["value"] > 0
    assert not set(got) & (set(NEW) - {"forward_ms.train", "backward_ms.train"})
