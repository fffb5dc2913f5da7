"""The lower-precision controls of a served cell, on the card at the cell's
own size, beside the sound readings of the same seeds:

    python3 benchmark/controls/low_precision.py --workload ralf-cgl.uncond-b1024 \\
        --seeds 11 12 13 [--requests 2]

For each seed it builds the cell's program as a run does, serves
`--requests` greedy requests, and judges each way with the cell's own
comparison, against the cell's own limits (`config['limits']`, the
family's `check` and `lib/serve.py::gap_checks`), on the rows a run
compares:

  sound      the program as the configuration states it (bfloat16);
  ref_fp8    the reference itself with fp8 (e4m3) operands in every
             matrix product and convolution, one scale a row
             (`references/blocks.py::fake_low`), put in the program's place
             at the same inputs: at each position (each step) it serves what
             it puts first (the family's `control_check`);
  ref_int8   the same with int8 operands;
  kv_int8    for a family with an int8 path of its own (RALF: the shared
             memory and the self-attention caches in int8, `kv_quant` and
             `self_quant`, K3), the program with that path on.

It prints one JSON line a seed with each way's gap figures (`mean_gap`,
`row_gap`, `max_gap`), its compared numbers and its `correct`, then for
each figure the sound readings' largest and each control's smallest.  It
exits 1 when a sound run comes out not correct or the fp8 control, the one
the limits are set against, comes out correct on any seed.
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

OWN_INT8 = {"ralf": {"kv_quant": True, "self_quant": True}}  # family -> its int8 path


def judged(info: dict, checks: dict) -> dict:
    """One way's reading: its gap figures, each compared number and `correct`."""
    from benchmark.lib import serve
    from benchmark.run import is_correct

    figures = {**info, **{k: c["value"] for k, c in checks.items()}}
    return {**{k: figures[k] for k in serve.gap_figures(None)},
            "checks": {k: [c["value"], c["limit"]] for k, c in checks.items()},
            "correct": is_correct(checks)}


def served(torch, fam, cell, seed: int, requests: int, device, kwargs: dict):
    from benchmark.loops import generate

    prog = fam.build(torch, cell.config, cell.traffic, seed, device)
    prog.sample_kwargs = kwargs
    records = [generate.request(torch, prog, i, True, seed, generate.Spans())
               for i in range(requests)]
    return prog, records, judged(*fam.check(torch, prog, records, seed))


def readings(torch, cell, seed: int, requests: int, device) -> dict:
    fam = manifest.family(cell.config["family"])
    prog, records, sound = served(torch, fam, cell, seed, requests, device, {})
    out = {"sound": sound}
    for low in ("fp8", "int8"):
        out[f"ref_{low}"] = judged(*fam.control_check(torch, prog, records, seed, low))
    del prog, records
    torch.cuda.empty_cache()
    own = OWN_INT8.get(cell.config["family"])
    if own:
        out["kv_int8"] = served(torch, fam, cell, seed, requests, device, own)[2]
        torch.cuda.empty_cache()
    return out


def verdict(rows: list) -> int:
    """1 when a sound reading is not correct or an fp8 control's is."""
    return int(any(not r["sound"]["correct"] or r["ref_fp8"]["correct"] for r in rows))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=2)
    args = p.parse_args()
    env.prepare(ROOT)
    cell = manifest.Manifest(ROOT).cell(args.workload)
    import torch

    env.require_devices(torch, cell.chips)
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        rows.append(readings(torch, cell, seed, args.requests, device))
        print(json.dumps({"seed": seed, **rows[-1]}), flush=True)
    for figure in ("mean_gap", "row_gap", "max_gap"):
        print(json.dumps({figure: {"sound (largest)": max(r["sound"][figure] for r in rows),
                                   **{k + " (smallest)": min(r[k][figure] for r in rows)
                                      for k in rows[0] if k != "sound"}}}))
    print(json.dumps({"correct": {k: [r[k]["correct"] for r in rows] for k in rows[0]}}))
    return verdict(rows)


if __name__ == "__main__":
    sys.exit(main())
