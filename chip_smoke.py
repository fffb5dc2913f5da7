#!/usr/bin/env python3
"""Drive the PyTorch port of the RALF sample path on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each of which must pass:

  1. device   the card's name and power limit; TF32 off for matmuls and convolutions
  2. build    nvcc builds every kernel of ralf_tpu_torch/ops/csrc (sm_90a), in parallel
  3. kernels  each kernel against its plain PyTorch version at the main path's
              shapes, in bf16 and fp32, with its time beside the plain version's,
              one PyTorch library call's and the least time the card could take
  4. check    the full-width RALF in fp32 on the card against the same weights on
              the CPU (plain versions): gallery features, encode_memory, greedy tokens
  5. slice    the full-width RALF in bf16 answers 3 requests of 128 canvases in
              each decode configuration (bf16 shared memory through K2, and
              kv_quant + self_quant through K3); the launch counters show K1, K2
              and K3 ran on the path; one more request per configuration under
              torch.profiler prints the device's busy share
  6. report   one JSON line of the kernels, the nvidia-smi line, and last
              {"ok": true, "device": {...}}

It exits non-zero, and prints no result line, when CUDA is absent or any
check fails.  It imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 FMA
TOL = {"bfloat16": (1e-3, 2**-7), "float32": (1e-5, 1e-4)}  # (atol, rtol) kernel vs plain

REPLACES = {
    "encoder_attention": "ralf_tpu/ops/pallas/encoder_attention.py:213",
    "decode_shared_attention": "ralf_tpu/ops/pallas/decode_attention.py:115",
    "decode_shared_attention_q8": "ralf_tpu/ops/pallas/decode_attention.py:198",
}
SOURCES = {
    "encoder_attention": "ralf_tpu_torch/ops/csrc/encoder_attention.cu",
    "decode_shared_attention": "ralf_tpu_torch/ops/csrc/decode_attention.cu",
    "decode_shared_attention_q8": "ralf_tpu_torch/ops/csrc/decode_attention.cu",
}
N_REQUESTS, BATCH, GALLERY = 3, 128, 256


class Failures(list):
    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.append(what)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times, ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(torch, dev):
    """(kernel name, case label, dtype, kernel call, plain call, library call or None, bytes, ops)."""
    import torch.nn.functional as F

    from ralf_tpu_torch.ops import decode_attention as da
    from ralf_tpu_torch.ops import encoder_attention as ea

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        for B, S, H, masked in ((128, 330, 8, False), (1, 330, 8, False), (128, 4, 8, True),
                                (256, 11, 4, True), (1, 11, 4, True)):
            E, Dh = 256, 256 // H
            q, k, v = (torch.randn(B, S, E, generator=g, device=dev) for _ in range(3))
            q = (q * Dh**-0.5).to(dtype)
            k, v = k.to(dtype), v.to(dtype)
            bias = None
            if masked:  # random key-padding masks; every 3rd row fully masked
                keep = torch.rand(B, S, generator=g, device=dev) > 0.3
                keep[::3] = False
                bias = torch.where(keep, 0.0, -1e9).float()
            q4, k4, v4 = (t.view(B, S, H, Dh).transpose(1, 2) for t in (q, k, v))
            m4 = None if bias is None else bias[:, None, None, :].to(dtype)
            lib = (lambda q4=q4, k4=k4, v4=v4, m4=m4:
                   F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=1.0))
            cases.append((
                "encoder_attention", f"B={B} S={S} H={H} Dh={Dh} mask={masked}", dn,
                lambda q=q, k=k, v=v, H=H, bias=bias: ea.encoder_attention(q, k, v, H, bias),
                lambda q=q, k=k, v=v, H=H, bias=bias: ea.encoder_attention_plain(q, k, v, H, bias),
                lib, 4 * B * S * E * isz + (4 * B * S if masked else 0), 4 * B * S * S * E,
            ))
        for M in (680, 677):
            B, H, E = 128, 8, 256
            qt = (torch.randn(B, H, E, generator=g, device=dev) / 16).to(dtype)
            memf = torch.randn(B, M, E, generator=g, device=dev)
            mem = memf.to(dtype)
            cases.append((
                "decode_shared_attention", f"B={B} M={M}", dn,
                lambda qt=qt, mem=mem: da.decode_shared_attention(qt, mem),
                lambda qt=qt, mem=mem: da.decode_shared_attention_plain(qt, mem),
                lambda qt=qt, mem=mem: F.scaled_dot_product_attention(
                    qt[:, None], mem[:, None], mem[:, None], scale=1.0),
                B * M * E * isz + 2 * B * H * E * isz, 4 * B * H * M * E,
            ))
            mi, ms = da.quantize_shared_memory(memf)
            cases.append((
                "decode_shared_attention_q8", f"B={B} M={M}", dn,
                lambda qt=qt, mi=mi, ms=ms: da.decode_shared_attention_q8(qt, mi, ms),
                lambda qt=qt, mi=mi, ms=ms: da.decode_shared_attention_q8_plain(qt, mi, ms),
                None, B * M * E + 4 * B * M + 2 * B * H * E * isz, 4 * B * H * M * E,
            ))
    return cases


def run_kernel_checks(torch, dev, fails: Failures) -> dict:
    """Check and time every case; returns the main-shape bf16 row of each kernel."""
    main_rows = {}
    for name, label, dn, kern, plain, lib, nbytes, ops in kernel_cases(torch, dev):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        atol, rtol = TOL[dn]
        ok = bool(torch.isfinite(out.float()).all()) and bool(
            (err <= atol + rtol * ref.float().abs()).all())
        row = {
            "max_abs_err": float(err.max()),
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": None if lib is None else time_ms(lib),
        }
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dn)
        fails.check(ok, f"{name} {label} {dn}: max_abs_err {row['max_abs_err']:.3e} "
                        f"(tol {atol} + {rtol}*|ref|)")
        print(f"  {name} {label} {dn}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']} ms, bound {row['bound_ms'] * 1e3:.2f} us "
              f"({row['bound_by']})", flush=True)
        if dn == "bfloat16" and name not in main_rows:
            main_rows[name] = row  # the first bf16 case is the main path's shape
    return main_rows


def build_gallery_and_batches(gen, dev, n_requests: int, batch: int, gallery_size: int,
                              image_dtype=np.uint8):
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    hw = gen.image_hw
    gallery = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=gallery_size,
                                     seed=1, image_hw=hw)
    retriever = Retriever.build(gallery, device=dev)
    feats = gen.precompute_retrieved_feats(retriever.layouts)
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=n_requests * batch,
                                seed=0, image_hw=hw)
    loader = RetrievalAugmentedLoader(
        BatchLoader(ds, batch, shuffle=False, image_dtype=image_dtype), retriever,
        top_k=gen.top_k, feats_table=feats)
    return retriever, feats, list(loader)


def reference_check(torch, tok, fails: Failures) -> None:
    """fp32 full-width RALF: kernels on the card vs plain versions on the CPU."""
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator

    t0 = time.perf_counter()
    cfg = GeneratorConfig(dtype=torch.float32)
    gens = {d: RALFGenerator(tok, cfg, "uncond", device=d, seed=0) for d in ("cuda", "cpu")}
    feats, conds, mems = {}, {}, {}
    for d, gen in gens.items():
        _, feats[d], batches = build_gallery_and_batches(gen, d, 1, 2, 64, np.float32)
        conds[d], _ = gen.build_condition(batches[0])
        mems[d] = gen.encode_memory(conds[d]).cpu()
    f_err = float(np.abs(feats["cuda"] - feats["cpu"]).max())
    fails.check(f_err < 1e-3, f"check: FIDNet gallery features card vs CPU max_abs_err {f_err:.3e} (tol 1e-3)")
    m_err = float((mems["cuda"] - mems["cpu"]).abs().max())
    fails.check(m_err < 1e-3, f"check: encode_memory card vs CPU max_abs_err {m_err:.3e} (tol 1e-3), "
                              f"memory {tuple(mems['cpu'].shape)}")
    greedy = SamplingConfig(name="deterministic")
    forced = build_forced_tokens(conds["cpu"], tok)
    for kvq, sq in ((False, False), (True, True)):
        toks = {d: gens[d].decode(mems["cpu"].to(d), forced, greedy, kv_quant=kvq,
                                  self_quant=sq).cpu() for d in gens}
        same = float((toks["cuda"] == toks["cpu"]).float().mean())
        fails.check(same == 1.0, f"check: greedy tokens card vs CPU kv_quant={kvq} "
                                 f"self_quant={sq}: {same:.4f} equal")
    print(f"  check phase {time.perf_counter() - t0:.1f} s", flush=True)


def run_slice(torch, tok, fails: Failures) -> dict:
    """Full-width bf16 RALF: 3 requests of 128 canvases per decode configuration."""
    from ralf_tpu_torch.core.conditioning import build_forced_tokens
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.ops import decode_attention as da
    from ralf_tpu_torch.ops import encoder_attention as ea

    t0 = time.perf_counter()
    gen = RALFGenerator(tok, GeneratorConfig(dtype=torch.bfloat16), "uncond", top_k=16,
                        device="cuda", seed=0)
    ea.encoder_attention.launches = 0
    _, feats, batches = build_gallery_and_batches(gen, "cuda", N_REQUESTS, BATCH, GALLERY)
    fails.check(ea.encoder_attention.launches == 4 and feats.shape == (GALLERY, 256)
                and bool(np.isfinite(feats).all()),
                f"slice: gallery table {feats.shape} from {ea.encoder_attention.launches} "
                "K1 launches (4 FIDNet layers)")
    print(f"  slice set-up {time.perf_counter() - t0:.1f} s", flush=True)
    sampling = SamplingConfig(name="top_p", top_p=0.9, temperature=1.0)
    token_mask = gen.token_mask
    L = tok.max_token_length
    counters = {"K1": ea.encoder_attention, "K2": da.decode_shared_attention,
                "K3": da.decode_shared_attention_q8}
    totals = {}
    for label, kvq, sq, cross in (("cli-default", False, False, "K2"),
                                  ("bench", True, True, "K3")):
        def request(batch, seed):
            cond, _ = gen.build_condition(batch)
            forced = build_forced_tokens(cond, tok)
            torch.cuda.synchronize()
            a = time.perf_counter()
            mem = gen.encode_memory(cond)
            torch.cuda.synchronize()
            b = time.perf_counter()
            toks = gen.decode(mem, forced, sampling,
                              torch.Generator(device="cuda").manual_seed(seed), kvq, sq)
            torch.cuda.synchronize()
            c = time.perf_counter()
            return mem, toks, tok.decode(toks), b - a, c - b

        request(batches[0], 99)  # warm-up, outside the counted run
        for c in counters.values():
            c.launches = 0
        outs = []
        for i, batch in enumerate(batches):
            before = {k: c.launches for k, c in counters.items()}
            mem, toks, layout, t_enc, t_dec = request(batch, i)
            n = {k: c.launches - before[k] for k, c in counters.items()}
            legal = bool(token_mask[torch.arange(L, device=toks.device)[None, :], toks].all())
            geo_ok = all(bool(torch.isfinite(layout.geo(k)).all()) for k in
                         ("center_x", "center_y", "width", "height"))
            fails.check(
                n["K1"] == 12 and n[cross] == 300 and legal and geo_ok
                and tuple(toks.shape) == (BATCH, L) and bool(torch.isfinite(mem.float()).all()),
                f"slice {label} request {i}: memory {tuple(mem.shape)}, launches {n}, "
                f"tokens legal={legal}, layouts decoded (finite={geo_ok}, "
                f"{int(layout.mask.sum())} elements)")
            print(f"  {label} request {i}: encode {t_enc * 1e3:.1f} ms, decode {t_dec * 1e3:.1f} ms, "
                  f"{BATCH / (t_enc + t_dec):.1f} layouts/s", flush=True)
            outs.append(toks.cpu().numpy().tobytes())
        fails.check(len(set(outs)) == N_REQUESTS, f"slice {label}: the {N_REQUESTS} requests "
                                                  "give distinct outputs")
        for k, c in counters.items():
            totals[k] = totals.get(k, 0) + c.launches
        profile_request(torch, label, lambda: request(batches[0], 7))
    print(f"  slice phase {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


def profile_request(torch, label: str, run) -> None:
    """One more request under torch.profiler: the summed CUDA kernel time
    against the host wall time (the device's busy share), and the kernels
    that take most of it.  For information; it checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]  # the kernels themselves, not the ops above them
    if not rows:
        print(f"  {label} profile: no device time recorded (busy share not measured)", flush=True)
        return
    busy = sum(r[0] for r in rows)
    print(f"  {label} profile: wall {wall_us / 1e3:.1f} ms, kernels {busy / 1e3:.1f} ms on the "
          f"device ({100 * busy / wall_us:.1f}% busy)", flush=True)
    for us, n, key in sorted(rows, reverse=True)[:8]:
        print(f"    {us / 1e3:8.2f} ms {n:6d}x {key[:90]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
    from ralf_tpu_torch.ops import _build

    t_start = time.perf_counter()
    fails = Failures()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t:.1f} s for {list(_build.SOURCES)}", flush=True)

    dev = torch.device("cuda")
    main_rows = run_kernel_checks(torch, dev, fails)
    tok = LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=10, num_bin=128))
    reference_check(torch, tok, fails)
    launches = run_slice(torch, tok, fails)

    ids = {"encoder_attention": "K1", "decode_shared_attention": "K2",
           "decode_shared_attention_q8": "K3"}
    kernels = [{"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
                "launches": launches[ids[n]], **main_rows[n]} for n in REPLACES]
    for k in kernels:
        fails.check(k["launches"] > 0, f"{k['name']} launched {k['launches']} times on the main path")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed: {fails}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi[0] if smi else name)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase that raised fails the run
        traceback.print_exc()
        sys.exit(1)
