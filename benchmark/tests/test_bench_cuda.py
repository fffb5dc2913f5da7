"""Each cell of `BENCHMARK.json` run briefly on the card through its command,
as the check runs it: the result's last line, its keys, the cell's metrics
and `correct`.  Needs a CUDA card; skips without one.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_cuda.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.lib import manifest

pytestmark = pytest.mark.cuda

ROOT = manifest.BENCH_DIR.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 11), "--seconds", "12", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"], result["checks"]
    found = manifest.Manifest(ROOT).cell(cell)
    want = found.per_layer if trace else found.end_to_end
    if not trace:
        assert {m["name"] for m in want} == set(result["metrics"])
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == found.chips
