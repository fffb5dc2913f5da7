#!/usr/bin/env python3
"""Time the port's kernels in two trees on one CUDA card, in turns.

    python3 kernel_ab.py --other DIR [--names encoder_attention,decode_shared_attention]

DIR is another checkout of this repository (for example the parent commit,
unpacked with `git archive`, or a copy of this tree with one change undone).
Each turn is a fresh process that runs from one tree's root, builds that
tree's kernels and times every case of that tree's `chip_smoke.kernel_cases`
whose kernel is in --names: the median of 30 CUDA-event-timed calls of the
kernel, its plain version and its library call, as chip_smoke.py times them
(on an idle card this includes the wrapper's time on the host before the
launch), and the device time alone of the kernel and of the library call,
from torch.profiler over 30 calls.  The turns run other, this, this, other,
and the table pairs the cases that both trees have by label and dtype.
To compare a variant as well, run the script once more with it as DIR.
A kernel that only this tree has (K11: `--names batchnorm_act`, at the
benchmark's two largest BatchNorm calls beside the unfused eval path it
replaced) gets rows from this tree's turns alone.
It prints the card's name and power limit first and exits non-zero
without CUDA.

    python3 kernel_ab.py --phases k6
    python3 kernel_ab.py --phases k5

time a kernel's parts apart in the same way: copies of this tree under
tmp/<k6|k5>_phases/ whose source has the bf16 tensor-core route cut by
exact text substitutions (`PHASES`).  K6 (csrc/encoder_attention.cu, S <=
384): the projection alone (no attention), the projection with no copy
issued (its mma on whatever the ring holds: what the loads of x and wqkv
cost), and the attention alone (no projection: Q_h, K_h, V_h are whatever
memory held).  K5 (csrc/encoder_ffn.cu): no weight chunk copied after the
ring's first fill (the products run on whatever the slots hold: what the
copies from L2 cost), h over half of E (8 of its 16 k-steps: what the
first product costs), and no second product (o is never formed, so g is
not packed either).  Turns: this tree, each variant, this tree; the
variants' outputs are wrong by design and only their times count.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT_NAMES = "encoder_attention,decode_shared_attention"
K6_CU = Path("ralf_tpu_torch/ops/csrc/encoder_attention.cu")
_K6_PHASE2 = "  rows_attention<DH>(out, q_s, k_s, v_s, w_s, dead, o_x, red_m, red_l, out, row0, S, E, col);\n"
_K6_PROLOGUE = "  for (int i = 0; i < kProjStages - 1; ++i) issue(i);\n"
_K6_ISSUE = "    issue(i + kProjStages - 1);\n"
_K6_STEPS = "steps = (s16 + kRows - 1) / kRows * ktiles;"
# phase 2 kept behind a test that never holds (S < 0), so that the compiler
# cannot drop the projection's K_h and V_h as unread
_K6_NO_PHASE2 = "  if (S < 0)" + _K6_PHASE2[1:]
K6_VARIANTS = {  # variant: (text of encoder_self_attention_rows_kernel, its replacement)
    "projection": [(_K6_PHASE2, _K6_NO_PHASE2)],
    "projection, no loads": [(_K6_PHASE2, _K6_NO_PHASE2), (_K6_PROLOGUE, ""), (_K6_ISSUE, "")],
    "attention": [(_K6_STEPS, "steps = 0;")],
}
K5_CU = Path("ralf_tpu_torch/ops/csrc/encoder_ffn.cu")
_K5_EXPECT = "        mbar_expect_tx(&full[s], kSlotBytes);\n"
_K5_O_LOOP = "      for (int kk = 0; kk < kChunk / 16; ++kk)\n        wgmma_m64n256k16_rs("
K5_VARIANTS = {  # variant: (text of fused_ffn_tc_kernel and its helpers, its replacement)
    "no reloads": [(_K5_EXPECT, "        if (i >= kSlots) {\n          mbar_arrive(&full[s]);\n"
                                "          continue;\n        }\n" + _K5_EXPECT)],
    "h over half of E": [("  for (int k = 0; k < kWidth / 16; ++k) {",
                          "  for (int k = 0; k < kWidth / 32; ++k) {")],
    "no second product": [(_K5_O_LOOP, _K5_O_LOOP.replace("kk < kChunk / 16", "kk < 0"))],
}
# kernel: (source, variants, the kernel's name, the names timed in the whole tree)
PHASES = {
    "k6": (K6_CU, K6_VARIANTS, "encoder_self_attention", "encoder_self_attention,encoder_attention"),
    "k5": (K5_CU, K5_VARIANTS, "fused_ffn", "fused_ffn"),
}


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


def variant_tree(kernel: str, name: str) -> Path:
    """A copy of this tree under tmp/<kernel>_phases/ whose kernel source has
    the substitutions of the variant, each made once."""
    cu, variants, _, _ = PHASES[kernel]
    tree = HERE / "tmp" / f"{kernel}_phases" / name.replace(",", "").replace(" ", "_")
    shutil.rmtree(tree, ignore_errors=True)
    tree.mkdir(parents=True)
    shutil.copytree(HERE / "ralf_tpu_torch", tree / "ralf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(HERE / "chip_smoke.py", tree / "chip_smoke.py")
    src = (tree / cu).read_text()
    for old, new in variants[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{kernel} variant {name!r}: {old.strip()!r} is not in {cu} once")
        src = src.replace(old, new)
    (tree / cu).write_text(src)
    return tree


def phases(kernel: str) -> int:
    """The kernel whole, then each variant, then whole again: per-call and device ms."""
    _, variants, name, whole = PHASES[kernel]
    runs = [("whole", run_turn(HERE, whole))]
    for variant in variants:  # built after the first turn: only the kernel's source is rebuilt
        runs.append((variant, run_turn(variant_tree(kernel, variant), name)))
    runs.append(("whole", run_turn(HERE, whole)))
    for who, rows in runs:
        for row in rows:
            print(f"{who} {json.dumps(row)}", flush=True)
    print("kernel | case | dtype | " + " | ".join(f"{who} ms (device ms)" for who, _ in runs))
    keys = dict.fromkeys((r["name"], r["label"], r["dtype"]) for _, rows in runs for r in rows)
    for key in keys:
        cells = []
        for _, rows in runs:
            r = next((r for r in rows if (r["name"], r["label"], r["dtype"]) == key), None)
            cells.append("-" if r is None else f"{r['ms']:.4f} ({r['device_ms']:.4f})")
        print(" | ".join(key) + " | " + " | ".join(cells), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other tree's root")
    ap.add_argument("--names", default=DEFAULT_NAMES, help="kernel names, comma-separated")
    ap.add_argument("--phases", choices=sorted(PHASES), help="time this kernel's parts apart")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.names.split(",")
    if args.worker:
        return worker(names)
    import torch

    if not torch.cuda.is_available() or (args.other is None and args.phases is None):
        print("kernel_ab: needs a CUDA card and --other or --phases", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.phases is not None:
        return phases(args.phases)
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
