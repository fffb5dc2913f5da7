"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's file is `configs/<config>.json` (the manifest's `file`),
the traffic's `traffic/<traffic>.json`, and each per-layer metric's reader
`metrics/<metric>.py`.  The end-to-end metrics a cell reports are those
whose `workloads` list it, or that list none; the per-layer metrics the
same."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # manifest entries reported with --trace 0
    per_layer: list  # manifest entries reported with --trace 1


def load_module(path: Path, name: str):
    """A metric's file imported by its path (metric names hold dots)."""
    key = f"benchmark_file_{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module  # dataclasses look their module up while it runs
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Manifest:
    def __init__(self, root: Path) -> None:
        self.root = root
        self.data = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        found = [w for w in self.data["workloads"] if w["name"] == name]
        if not found:
            known = ", ".join(w["name"] for w in self.data["workloads"])
            raise SystemExit(f"benchmark: no workload {name!r} (known: {known})")
        w = found[0]
        conf = next(c for c in self.data["configs"] if c["name"] == w["config"])
        return Cell(
            name=name, config_name=w["config"], traffic_name=w["traffic"], chips=w["chips"],
            config=json.loads((self.root / conf["file"]).read_text()),
            traffic=json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text()),
            end_to_end=[m for m in self.data["end_to_end"] if reports(m, name)],
            per_layer=[m for m in self.data["per_layer"] if reports(m, name)],
        )


def metric_reader(name: str):
    """The module of `metrics/<name>.py`: LAYER, UNIT, MOVES and read(run)."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", name)


def family(name: str):
    """`families/<name>.py`, the model family of a configuration."""
    return importlib.import_module(f"benchmark.families.{name}")


def loop(kind: str):
    """`loops/<kind>.py`, the window loop of a traffic mix."""
    return importlib.import_module(f"benchmark.loops.{kind}")
