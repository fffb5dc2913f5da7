"""The lower-precision control of each served cell, at a size a test run can
hold (CPU, tiny widths): the reference with fp8 operands, put in the
program's place and judged by the cell's own comparison against the cell's
own limits, comes out not correct where the sound program comes out
correct, and reads well above it on the number the cell compares.  On the
card at the cells' own sizes the same readings come from
`benchmark/controls/low_precision.py` (PERF.md gives them and the limits
they set)."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark.lib import manifest
from benchmark.tests.tiny import tiny_cell

sys.path.insert(0, str(manifest.BENCH_DIR / "controls"))
import low_precision  # noqa: E402

SEED = 2**31 + 3


@pytest.mark.parametrize("config", ["ralf-cgl", "layoutdm-cgl"])
def test_fp8_reference_reads_far_above_the_sound_program(config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    cell = tiny_cell(config, "uncond-b1024")
    readings = low_precision.readings(torch, cell, SEED, 1, torch.device("cpu"))
    assert readings["sound"]["correct"], readings["sound"]
    assert not readings["ref_fp8"]["correct"], readings["ref_fp8"]
    assert low_precision.verdict([readings]) == 0
    assert low_precision.verdict([{**readings, "ref_fp8": readings["sound"]}]) == 1
    for figure in cell.config["limits"]:
        sound, fp8 = readings["sound"][figure], readings["ref_fp8"][figure]
        assert fp8 > 0 and fp8 >= 3 * sound, (figure, readings)
