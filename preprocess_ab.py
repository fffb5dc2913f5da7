#!/usr/bin/env python3
"""Where the dataset build's nets spend their time on one CUDA card, in fp32:

  1. each net's parameters and multiply-adds an image (forward hooks on its
     convolutions), then its batch (ISNet 4 x 1024^2, BASNet 4 x 256^2,
     big-lama 8 x 752x520) with cuDNN's heuristic algorithm choice and with
     its timed search (`cudnn.benchmark`), turns off, on, on, off, TF32 off;
  2. BASNet's convolutions one by one (CUDA events around each), cuDNN's
     TF32 off, then on;
  3. big-lama's kernels by name (torch.profiler), cuDNN's TF32 off, then on,
     and its Fourier units' torch.fft calls alone at the global branch's
     shape.

    python3 preprocess_ab.py

Random weights drawn to flax's laws (`models/towers.py::seeded`); it checks
nothing and exits non-zero without CUDA.  It imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time


def batch_ms(torch, net, args) -> tuple[float, float, float]:
    """(median ms of 5 calls after 2, the fastest, peak GiB)."""
    with torch.inference_mode():
        for _ in range(2):
            net(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            a = time.perf_counter()
            net(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - a) * 1e3)
    return statistics.median(times), min(times), torch.cuda.max_memory_allocated() / 2**30


def multiply_adds(torch, net, args) -> int:
    """The multiply-adds of one forward of `net` on `args` in its
    convolutions and transposed convolutions (the rest is elementwise)."""
    total = 0

    def count(m, inputs, out):
        nonlocal total
        taps = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, torch.nn.ConvTranspose2d):  # each input value scatters to its taps
            total += inputs[0].numel() * m.out_channels * taps // m.groups
        else:
            total += out.numel() * taps * m.in_channels // m.groups

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.inference_mode():
        net(*args)
    for h in hooks:
        h.remove()
    return total


def conv_ms(torch, net, x) -> list[tuple[float, str]]:
    """Each Conv2d's ms in the third of three forwards, largest first."""
    events, hooks = {}, []

    def pre(m, args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.setdefault(m, []).append([e])

    def post(m, args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events[m][-1].append(e)

    names = {}
    for n, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            names[m] = f"{n} {m.in_channels}->{m.out_channels} k{m.kernel_size[0]} d{m.dilation[0]}"
            hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    with torch.inference_mode():
        for _ in range(3):
            events.clear()
            net(x)
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return sorted(((a.elapsed_time(b), names[m]) for m, runs in events.items() for a, b in runs),
                  reverse=True)


def top_kernels(torch, label: str, run, n: int = 6) -> None:
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    rows = sorted(((e.device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_time_total > 0), reverse=True)
    print(f"{label}: {sum(r[0] for r in rows) / 1e3:.1f} device ms", flush=True)
    for us, count, key in rows[:n]:
        print(f"  {us / 1e3:8.2f} ms {count:5d}x {key[:100]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("preprocess_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from ralf_tpu_torch.models.towers import seeded
    from ralf_tpu_torch.preprocess.lama import BIG_LAMA, LamaGenerator
    from ralf_tpu_torch.preprocess.saliency_models import BASNet, ISNetDIS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    nets = {"isnet": (seeded(ISNetDIS), (4, 3, 1024, 1024)),
            "basnet": (seeded(BASNet), (4, 3, 256, 256)),
            "lama": (seeded(lambda: LamaGenerator(BIG_LAMA)), (8, 3, 752, 520))}
    args = {}
    for name, (net, shape) in nets.items():
        net.cuda().eval()
        x = torch.rand(shape, device="cuda")
        mask = (torch.rand(shape[0], 1, *shape[2:], device="cuda") > 0.7).float()
        args[name] = (x, mask) if name == "lama" else (x,)
        torch.backends.cudnn.allow_tf32 = False
        one = tuple(a[:1] for a in args[name])
        print(f"{name}: {sum(p.numel() for p in net.parameters()) / 1e6:.2f} M parameters, "
              f"{multiply_adds(torch, net, one) / 1e9:.2f} G multiply-adds an image at "
              f"{shape[2]}x{shape[3]}", flush=True)
        for bench in (False, True, True, False):
            torch.backends.cudnn.benchmark = bench
            ms, fastest, peak = batch_ms(torch, net, args[name])
            print(f"{name} {shape} benchmark={bench}: {ms:.2f} ms per batch (fastest "
                  f"{fastest:.2f}), peak {peak:.3f} GiB", flush=True)
        torch.backends.cudnn.benchmark = False
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = conv_ms(torch, nets["basnet"][0], args["basnet"][0])
        print(f"basnet convs, cudnn tf32={tf32}: {sum(t for t, _ in ms):.1f} ms in all; the "
              "largest:", flush=True)
        for t, n in ms[:8]:
            print(f"  {t:8.2f} ms {n}", flush=True)
        top_kernels(torch, f"lama, cudnn tf32={tf32}", lambda: nets["lama"][0](*args["lama"]))
    # the global branch at 1/8 of 752x520: [8, 192, 94, 65], 36 Fourier units
    xg = torch.rand(8, 192, 94, 65, device="cuda")
    top_kernels(torch, "36 x (rfft2 + irfft2) at [8, 192, 94, 65]", lambda: [
        torch.fft.irfft2(torch.fft.rfft2(xg, norm="ortho"), s=(94, 65), norm="ortho")
        for _ in range(36)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
