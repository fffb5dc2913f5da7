"""The harness end to end on the CPU at a tiny size (the look for a card
skipped): a sound run comes out correct, a run with a fault planted in the
timed path comes out not correct, nothing loads JAX or the JAX package, and
a checkout that holds only the benchmark cannot produce a result."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import textwrap
import time

import torch

from benchmark import run as brun
from benchmark.lib import env, manifest
from benchmark.tests.tiny import tiny_cell

ROOT = manifest.BENCH_DIR.parent
SEED = 2**31 + 5


def tiny_run(cell_config="ralf-cgl", traffic="uncond-b1024", seconds=0.5, traced=False,
             seed=SEED, dtype=None, **overrides):
    cell = tiny_cell(cell_config, traffic, **overrides)
    real = manifest.Manifest(ROOT).cell(f"{cell_config}.{traffic}")
    cell.end_to_end, cell.per_layer = real.end_to_end, real.per_layer
    if dtype:
        cell.config["dtype"] = dtype
    return brun.execute(torch, cell, seed, seconds, traced, torch.device("cpu"),
                        time.perf_counter())


def test_sound_run_is_correct_and_reports_its_metrics():
    res = tiny_run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"layouts_per_s", "request_ms_p95", "setup_s"}
    assert list(res)[-2:] == ["checks", "info"]  # run.py prints info and drops it
    assert all({"value", "limit"} == set(c) for c in res["checks"].values())
    json.dumps(res, allow_nan=False)


def test_traced_run_reports_host_metrics():
    res = tiny_run(traced=True)
    assert res["correct"], (res["checks"], res["info"])
    assert {"condition_ms", "violations_ms", "mfu.gen"} <= set(res["metrics"])
    assert "breakdown" in res and res["device"]["window_s"] > 0


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """Step 7 (a geometry slot) emits the legal token its logits rank last."""
    from ralf_tpu_torch.ops import decode_loop

    sample, step = decode_loop.sample, {"t": 0}

    def altered(logits, cfg, generator=None):
        tok = sample(logits, cfg, generator)
        step["t"] = step["t"] + 1
        if step["t"] % 50 == 8:
            legal = logits > torch.finfo(torch.float32).min
            tok = torch.where(legal, -logits, torch.finfo(torch.float32).min).argmax(-1)
        return tok

    monkeypatch.setattr(decode_loop, "sample", altered)
    res = tiny_run(dtype="float32")
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items() if k.endswith("_gap"))


def test_no_greedy_request_in_the_window_is_not_correct():
    cell = tiny_cell("ralf-cgl", "uncond-b1024", greedy_every=10_000)
    real = manifest.Manifest(ROOT).cell("ralf-cgl.uncond-b1024")
    cell.end_to_end = real.end_to_end
    res = brun.execute(torch, cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert not res["correct"] and res["checks"]["rows_missing"]["value"] > 0


def test_forbidden_modules_compare_whole_top_level_names():
    assert env.forbidden_modules(["ralf_tpu_torch", "ralf_tpu_torch.models", "jaxtyping"]) == []
    assert env.forbidden_modules(["ralf_tpu.models", "jax", "flax.linen"]) == [
        "flax.linen", "jax", "ralf_tpu.models"]


def test_benchmark_sources_import_neither_jax_nor_the_jax_package():
    for path in manifest.BENCH_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not env.forbidden_modules(names), (path, names)
        if path.name != "test_bench_run.py":  # nothing reads the JAX package's benchmark files
            assert "bench.py" not in path.read_text() and "BENCH_r" not in path.read_text()


def _child(code: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax_module():
    out = _child(f"""
        import sys, time, torch
        sys.path.insert(0, {str(ROOT)!r})
        torch.set_num_threads(2)
        from benchmark.tests.test_bench_run import tiny_run
        from benchmark.lib import env
        res = tiny_run(seconds=0.2)
        print("LOADED", env.forbidden_modules(), res["correct"])
    """, ROOT)
    assert "LOADED [] True" in out.stdout, out.stderr[-2000:]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "ralf-cgl.uncond-b1024", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "{" not in out.stdout


def test_a_checkout_with_only_the_benchmark_cannot_produce_a_result(tmp_path):
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _child(f"""
        import sys, time, torch
        sys.path.insert(0, {str(tmp_path)!r})
        from benchmark.tests.test_bench_run import tiny_run
        print(tiny_run(seconds=0.2))
    """, tmp_path)
    assert out.returncode != 0 and "ralf_tpu_torch" in out.stderr


def test_layoutdm_sound_run_is_correct():
    res = tiny_run("layoutdm-cgl", seconds=0.3, greedy_every=1)
    assert res["correct"], res["checks"]


def test_layoutdm_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """The last denoising step emits at position 7 (a height slot) another
    token of the same attribute than the one it drew."""
    from ralf_tpu_torch.models import diffusion

    inner = diffusion.MaskAndReplaceDiffusion.sample_single_step

    def altered(self, log_z, logits_fn, t, *args, **kwargs):
        out = inner(self, log_z, logits_fn, t, *args, **kwargs)
        if t == 0:
            idx = diffusion.log_onehot_to_index(out)
            first = self.tokenizer.geo_offset("height")
            idx[:, 7] = torch.where(idx[:, 7] == first, first + 1, first)
            out = diffusion.index_to_log_onehot(idx, self.V)
        return out

    monkeypatch.setattr(diffusion.MaskAndReplaceDiffusion, "sample_single_step", altered)
    res = tiny_run("layoutdm-cgl", seconds=0.3, greedy_every=1, dtype="float32")
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items() if k.endswith("_gap"))
