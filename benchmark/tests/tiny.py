"""Tiny cells for the CPU tests: the cells' own configurations and traffic
with widths, depths, canvases, pools and galleries cut so that a run fits a
test on the CPU.  The card's cells run only at their published sizes."""

from __future__ import annotations

import copy
import json

from benchmark.lib.manifest import BENCH_DIR, Cell

TINY_MODEL = {"d_model": 32, "nhead": 4, "num_encoder_layers": 1, "num_decoder_layers": 1,
              "dim_feedforward": 64}
TINY_DATA = {"image_h": 64, "image_w": 48, "gallery_size": 40}
TINY_TRAFFIC = {"batch": 4, "pool": 8, "greedy_every": 1, "check_rows": 3, "trace_requests": 1}


def tiny_cell(config_name: str, traffic_name: str, **traffic_overrides) -> Cell:
    config = json.loads((BENCH_DIR / "configs" / f"{config_name}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{traffic_name}.json").read_text())
    config = copy.deepcopy(config)
    config["model"].update(TINY_MODEL)
    config["dataset"].update(TINY_DATA)
    traffic.update(TINY_TRAFFIC, **traffic_overrides)
    return Cell(name=f"{config_name}.{traffic_name}", config_name=config_name,
                traffic_name=traffic_name, chips=1, config=config, traffic=traffic,
                end_to_end=[], per_layer=[])
