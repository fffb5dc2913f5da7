#!/usr/bin/env python3
"""Time the port's kernels in two trees on one CUDA card, in turns.

    python3 kernel_ab.py --other DIR [--names encoder_attention,decode_shared_attention]

DIR is another checkout of this repository (for example the parent commit,
unpacked with `git archive`).  Each turn is a fresh process that runs from
one tree's root, builds that tree's kernels and times every case of that
tree's `chip_smoke.kernel_cases` whose kernel is in --names: the median of
30 CUDA-event-timed calls of the kernel, its plain version and its library
call, as chip_smoke.py times them (on an idle card this includes the
wrapper's time on the host before the launch), and the device time alone
of the kernel and of the library call, from torch.profiler over 30 calls.  The turns run other, this, this, other,
and the table pairs the cases that both trees have by label and dtype.
It prints the card's name and power limit first and exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT_NAMES = "encoder_attention,decode_shared_attention"


def device_ms(torch, fn, iters: int = 30) -> float:
    """The summed CUDA kernel time of one call of fn, ms, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def worker(names: list[str]) -> int:
    """Run in a tree's root: one JSON line per timed case."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from ralf_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    for name, label, dn, kern, plain, lib, nbytes, ops, op_type, _ in \
            chip_smoke.kernel_cases(torch, dev):
        if name not in names:
            continue
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        row = {"name": name, "label": label, "dtype": dn,
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "ms": chip_smoke.time_ms(kern), "plain_ms": chip_smoke.time_ms(plain),
               "library_ms": None if lib is None else chip_smoke.time_ms(lib),
               "device_ms": device_ms(torch, kern),
               "library_device_ms": None if lib is None else device_ms(torch, lib)}
        row["bound_ms"], row["bound_by"] = chip_smoke.bound(nbytes, ops, op_type)
        print("ROW " + json.dumps(row), flush=True)
    return 0


def run_turn(tree: Path, names: str) -> list[dict]:
    proc = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), "--worker", "--names", names],
                          cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(line[4:]) for line in proc.stdout.splitlines() if line.startswith("ROW ")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--names", default=DEFAULT_NAMES, help="kernel names, comma-separated")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.names.split(",")
    if args.worker:
        return worker(names)
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("kernel_ab: needs a CUDA card and --other", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = [("other", args.other.resolve()), ("this", HERE), ("this", HERE),
             ("other", args.other.resolve())]
    times: dict[tuple, dict[str, list]] = {}
    for who, tree in turns:
        for row in run_turn(tree, args.names):
            key = (row["name"], row["label"], row["dtype"])
            times.setdefault(key, {}).setdefault(who, []).append(row)
            print(f"{who} {json.dumps(row)}", flush=True)
    print("kernel | case | dtype | other ms | this ms | this/other | library ms | "
          "device ms other, this | library device ms | bound ms")
    for (name, label, dn), by in times.items():
        o = [r["ms"] for r in by.get("other", [])]
        t = [r["ms"] for r in by.get("this", [])]
        lib = [r["library_ms"] for r in by.get("this", by.get("other", [])) if r["library_ms"]]
        ratio = f"{(sum(t) / len(t)) / (sum(o) / len(o)):.4f}" if o and t else "-"
        bnd = next(iter(by.values()))[0]["bound_ms"]
        dev = [f"{r['device_ms']:.4f}" for who in ("other", "this") for r in by.get(who, [])
               if "device_ms" in r]
        lib_dev = [f"{r['library_device_ms']:.4f}" for r in by.get("this", [])
                   if r.get("library_device_ms")]
        print(f"{name} | {label} | {dn} | {', '.join(f'{x:.4f}' for x in o) or '-'} | "
              f"{', '.join(f'{x:.4f}' for x in t) or '-'} | {ratio} | "
              f"{', '.join(f'{x:.4f}' for x in lib) or '-'} | {', '.join(dev) or '-'} | "
              f"{', '.join(lib_dev) or '-'} | {bnd:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
