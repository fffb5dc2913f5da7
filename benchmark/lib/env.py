"""The run's environment: cache directories inside the checkout, the
modules that must never load, and the device check."""

from __future__ import annotations

import os
import sys
from pathlib import Path

# whole top-level module names; `ralf_tpu_torch` is not `ralf_tpu`
FORBIDDEN = ("jax", "jaxlib", "flax", "ralf_tpu")
CACHE_DIR = ".bench_cache"  # under the checkout's root, listed in .gitignore


def prepare(root: Path) -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds or compiles.  The port builds its nvcc libraries
    into `ralf_tpu_torch/_build/` inside the checkout by itself."""
    cache = root / CACHE_DIR
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_compute")):
        os.environ[var] = str(cache / sub)
        (cache / sub).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"  # keeps transformers, if anything loads it, from loading JAX


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def require_devices(torch, chips: int) -> None:
    """SystemExit (code 2) unless CUDA has at least `chips` cards."""
    if not torch.cuda.is_available():
        raise SystemExit("benchmark: CUDA is not available; the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: the cell needs {chips} card(s), "
                         f"{torch.cuda.device_count()} visible")
