"""The control and the planted faults of a training cell, on the card at the
cell's own size, beside the sound readings of the same seeds:

    python3 benchmark/controls/train.py --workload ralf-cgl.train-b32 \\
        --seeds 11 12 13 [--ways sound tf32 half_batch unchanged]

For each seed and way it builds the cell's program as a run does, drives
it through the checked steps (`loops/train.py::checked`) with the way
applied, and judges it with the cell's own comparison against the cell's
own limits (the family's `check`: the float32 reference follows the same
steps).  No window runs.  The ways:

  sound       the program as the configuration states it (float32, TF32 off);
  tf32        the control: the program with its TF32 path on (cuDNN's
              convolutions and cuBLAS's float32 products in TF32);
  half_batch  a fault: half of each batch left out of the loss, the mean
              taken over the rest (the forward still sees every row);
  unchanged   a fault: a step that returns its state unchanged (the update
              left out).

It prints one JSON line a seed and way with the compared numbers and
`correct`, then each number's largest sound reading and each other way's
smallest.  It exits 1 when a sound run comes out not correct or another
way comes out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import env, manifest  # noqa: E402

WAYS = ("sound", "tf32", "half_batch", "unchanged")


def half(targets: dict, pad: int) -> dict:
    """The targets with the second half of the batch's rows padded out, so
    that the loss is the mean over the first half alone (the forward still
    runs over the whole batch)."""
    seq = targets["seq"].clone()
    seq[seq.shape[0] // 2 :] = pad
    return {**targets, "seq": seq}


def apply(torch, fam, prog, way: str) -> None:
    """Apply `way` to a freshly built program."""
    if way == "tf32":
        fam.set_tf32(torch, True)
    elif way == "half_batch":
        inner = prog.gen.loss
        pad = prog.gen.tokenizer.pad_id
        prog.gen.loss = lambda inputs, targets: inner(inputs, half(targets, pad))
    elif way == "unchanged":
        prog.state.optimizer.step = lambda: None


def reading(torch, cell, seed: int, way: str, device) -> dict:
    from benchmark.loops import train
    from benchmark.run import is_correct

    fam = train.family(cell.config)
    prog = fam.build(torch, cell.config, cell.traffic, seed, device)
    apply(torch, fam, prog, way)
    rows, readings, masks = train.checked(torch, fam, prog, cell.traffic, train.Spans())
    info, checks = fam.check(torch, prog, readings, rows, masks)
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"checks": {k: [c["value"], c["limit"]] for k, c in checks.items()},
            "losses": info["losses"], "correct": is_correct(checks)}


def verdict(rows: list) -> int:
    """1 when a sound reading is not correct or another way's is."""
    return int(any(r["correct"] != (r["way"] == "sound") for r in rows))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--ways", nargs="+", default=list(WAYS), choices=WAYS)
    args = p.parse_args()
    env.prepare(ROOT)
    cell = manifest.Manifest(ROOT).cell(args.workload)
    import torch

    env.require_devices(torch, cell.chips)
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        for way in args.ways:
            rows.append({"seed": seed, "way": way, **reading(torch, cell, seed, way, device)})
            print(json.dumps(rows[-1]), flush=True)
    for name in rows[0]["checks"]:
        values = {w: [r["checks"][name][0] for r in rows if r["way"] == w] for w in args.ways}
        print(json.dumps({name: {w + (" (largest)" if w == "sound" else " (smallest)"):
                                 (max(v) if w == "sound" else min(v))
                                 for w, v in values.items() if v}}))
    return verdict(rows)


if __name__ == "__main__":
    sys.exit(main())
