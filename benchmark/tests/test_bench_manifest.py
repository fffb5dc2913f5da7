"""`BENCHMARK.json` against the rules of its format (names, units, keys,
bounds, what each metric moves), and every file it names found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.lib import manifest

ROOT = manifest.BENCH_DIR.parent
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"[^\n\t]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(DATA["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in DATA["command"])
    assert 1 <= len(DATA["paths"]) <= 16
    for p in DATA["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert not p.startswith("/") and not p.endswith("_torch")
    files = [w for w in DATA["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in DATA["paths"]) for f in files)
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    everything = DATA["configs"] + DATA["workloads"] + DATA["end_to_end"] + DATA["per_layer"]
    for entry in everything:
        assert manifest.NAME.fullmatch(entry["name"]), entry["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in DATA[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.fullmatch(c["why"]) and LINE.fullmatch(c["source"])
        assert len(c["reduced"]) <= 16 and all(manifest.NAME.fullmatch(k) for k in c["reduced"])
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.fullmatch(w["why"])
        assert manifest.NAME.fullmatch(w["traffic"]) and manifest.NAME.fullmatch(w["config"])
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and LINE.fullmatch(m["layer"])
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert manifest.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    fours = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert fours <= max(1, len(DATA["workloads"]) // 4)


def test_every_moves_target_is_reported_where_the_metric_is():
    cells = [w["name"] for w in DATA["workloads"]]
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DATA["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert manifest.reports(target, cell), (m["name"], cell)
    for cell in cells:
        reported = [n for n, t in e2e.items() if manifest.reports(t, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(manifest.reports(m, cell) for m in DATA["per_layer"])
    layers = {}
    for m in DATA["per_layer"]:  # one metric's layer is spelled alike everywhere
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_config_and_traffic_files_found_by_name(cell):
    found = manifest.Manifest(ROOT).cell(cell)
    entry = next(c for c in DATA["configs"] if c["name"] == found.config_name)
    assert entry["file"].startswith("benchmark/configs/")
    assert found.config["source"] == entry["source"]
    assert found.config["reduced"] == entry["reduced"]
    assert (manifest.BENCH_DIR / "families" / f"{found.config['family']}.py").exists()
    assert (manifest.BENCH_DIR / "loops" / f"{found.traffic['kind']}.py").exists()
    assert found.end_to_end and found.per_layer


@pytest.mark.parametrize("metric", DATA["end_to_end"] + DATA["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    reader = manifest.metric_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert reader.MOVES == metric.get("moves")
    if "layer" in metric:
        assert reader.LAYER == metric["layer"]
    assert callable(reader.read)


def test_every_config_file_is_named_once():
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert (ROOT / f).exists() and any(f.startswith(p + "/") for p in DATA["paths"])
