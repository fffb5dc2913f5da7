"""Build and bind the port's CUDA kernels.

Each source `csrc/<name>.cu` compiles with nvcc into its own shared library
with a plain C interface, loaded with ctypes.  The build happens at first
use, into `ralf_tpu_torch/_build/` (listed in .gitignore), under a file name
keyed by a hash of the sources and flags, so an edited kernel is rebuilt and
an unchanged one is loaded as it is.  `build_all` starts one nvcc per source,
all together, and waits for them.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine may have no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("encoder_attention", "encoder_ffn", "decode_attention", "stream_sum", "assignment",
           "cross_attention", "batchnorm_act")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file


def build_all(names=SOURCES) -> None:
    """Compile every listed source that has no library yet, in parallel."""
    with _lock:
        jobs = [j for j in (_start(n) for n in names) if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if needed, with the
    ctypes `argtypes` of each function in `signatures` declared (restype is
    the int cudaError_t every entry point returns)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_handle() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    and none of them needs a gradient while grad is enabled: the tensor a
    kernel fills has no grad_fn, which would cut autograd silently.  K1, K5
    and K6 launch inside `RecomputedBackward.forward`, where grad is
    disabled and autograd records the Function instead; the other kernels
    are forward only, as their Pallas calls are (no VJP)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: all tensors must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel is forward only and an input requires "
                           "grad; call it under torch.no_grad() or torch.inference_mode()")


class RecomputedBackward(torch.autograd.Function):
    """A forward made differentiable as JAX's custom_vjps make K1, K5 and K6:
    `RecomputedBackward.apply(forward, reference, *inputs)` returns
    forward(*inputs) (the kernel on CUDA tensors, its plain version on CPU
    ones), and its backward recomputes reference(*inputs) on
    detached copies under enable_grad and returns torch.autograd.grad of
    it, as JAX's VJPs recompute their XLA references (there is no backward
    kernel).  Nothing outside `inputs` gets a gradient: K1's and K6's
    key_bias, bound into `forward` and `reference`, get none, as in JAX.
    Both run with autocast off: inside a bf16 train step the inputs come
    in the compute dtype, and the plain version and the reference compute
    in theirs as the kernel does."""

    @staticmethod
    def forward(ctx, forward, reference, *inputs):
        ctx.reference = reference
        ctx.save_for_backward(*inputs)
        with _no_autocast(inputs[0]):
            return forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad(), _no_autocast(grad):
            out = ctx.reference(*inputs)
        return (None, None, *torch.autograd.grad(out, inputs, grad))


def _no_autocast(t: torch.Tensor):
    """Autocast off on `t`'s device."""
    return torch.autocast(t.device.type, enabled=False) if t.device.type in ("cpu", "cuda") \
        else contextlib.nullcontext()


def require_aligned(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels
    that copy rows with 16-byte cp.async)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must start on a 16-byte boundary")
