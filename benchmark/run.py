"""Run one cell of the benchmark once, on the card, and print its result:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With --trace 0 the result's metrics are the
cell's end-to-end metrics of `BENCHMARK.json`; with --trace 1 its per-layer
metrics, read after a window whose phases are also timed on the device and
a few more requests or steps under torch.profiler.  The last line of standard output
is one JSON object: correct, attempted, failed, metrics, device, with
--trace 1 a breakdown, and last the numbers compared with their limits
(which also end standard error).  The run exits non-zero and prints no
result without CUDA or with fewer cards than the cell asks for, and if a
JAX module or the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import env, manifest  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def is_correct(checks: dict) -> bool:
    """Every compared number has a value at most its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def host_threads(config: dict) -> None:
    """The configuration's deployment setting `host_threads`, the CPU
    threads of the program's host operators (OpenMP, MKL and torch's
    intra-op pool), set before torch is imported; without it the program
    keeps its defaults."""
    n = config.get("host_threads")
    if n is not None:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[var] = str(n)


def metrics(entries: list, run) -> dict:
    """{name: {'value', 'unit'}} of the entries whose reader finds a value."""
    out = {}
    for m in entries:
        value = manifest.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(torch, cell, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> dict:
    """One run of the cell on `device`; returns the result object."""
    loop = manifest.loop(cell.traffic["kind"])
    run, checks, memory = loop.run(torch, cell, seed, seconds, traced, device, t_start)
    entries = cell.per_layer if traced else cell.end_to_end
    result = {
        "correct": is_correct(checks),
        "attempted": len(run.records),
        "failed": 0,
        "metrics": metrics(entries, run),
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory)},
    }
    missing = [m["name"] for m in cell.end_to_end if not traced and m["name"] not in
               result["metrics"]]
    if missing:
        raise RuntimeError(f"end-to-end metrics with no value: {missing}")
    if traced and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_by_host(10)}
    result["checks"] = checks
    result["info"] = run.info
    return result


def main(argv=None) -> int:
    args = parse(argv)
    env.prepare(ROOT)
    cell = manifest.Manifest(ROOT).cell(args.workload)
    host_threads(cell.config)
    import torch

    if cell.config.get("host_threads") is not None:
        torch.set_num_threads(cell.config["host_threads"])
    env.require_devices(torch, cell.chips)
    device = torch.device("cuda", 0)
    result = execute(torch, cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    loaded = env.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, value in result.pop("info").items():
        print(f"info {name} {value}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
