"""ctypes bindings of the native C++ collator (`data/csrc/collate.cpp`), the
counterpart of `ralf_tpu/data/native.py`.

The library is built with `g++ -O3 -shared -fPIC` at first use, into
`ralf_tpu_torch/_build/` under a name keyed by a hash of the source, so an
edited source is rebuilt.  Unlike the JAX package, a failed build raises:
the numpy path is the plain version, and the loader takes it only when the
caller asks for it (`BatchLoader(use_native=False)`).

  * `collate_batch`: the instance transforms (sort_label, sort_lexicographic,
    shuffle by std::mt19937_64 from a seed), the padded tail zeroed, and the
    mask, for a whole batch in one call;
  * `gather_neighbors`: [B, K] gallery rows -> {key: [B, K, S]} in one call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "collate.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
TRANSFORM_FLAGS = {"shuffle": 1, "sort_label": 2, "sort_lexicographic": 4}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libralf_collate_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native collate: g++ not found; pass use_native=False to take the "
                           "numpy path")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native collate: g++ failed for {SRC.name}:\n{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ralf_collate_batch.argtypes = [
            i64p, f32p, f32p, f32p, f32p, u8p, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ]
        lib.ralf_collate_batch.restype = None
        lib.ralf_gather_neighbors.argtypes = [
            i64p, f32p, f32p, f32p, f32p, u8p, i64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i64p, f32p, f32p, f32p, f32p, u8p,
        ]
        lib.ralf_gather_neighbors.restype = None
        _lib = lib
        return _lib


def collate_batch(layout_arrays: dict, transforms, seed: int) -> dict:
    """Padded layout arrays [B, S] -> the transformed arrays and the mask
    rebuilt from each row's length (copies; the input is left as it is)."""
    lib = get_lib()
    flags = 0
    for t in transforms:
        flags |= TRANSFORM_FLAGS[t]
    label = np.array(layout_arrays["label"], np.int64, order="C")
    geo = [np.array(layout_arrays[k], np.float32, order="C")
           for k in ("center_x", "center_y", "width", "height")]
    lengths = np.ascontiguousarray(np.asarray(layout_arrays["mask"]).sum(axis=1), np.int32)
    B, S = label.shape
    mask = np.zeros((B, S), np.uint8)
    lib.ralf_collate_batch(label, *geo, mask, lengths, B, S, flags, np.uint64(seed))
    return {"label": label, "center_x": geo[0], "center_y": geo[1], "width": geo[2],
            "height": geo[3], "mask": mask.astype(bool)}


def gather_neighbors(gallery: dict, indices: np.ndarray) -> dict:
    """[B, K] gallery indices -> {key: [B, K, S]} in one native call."""
    lib = get_lib()
    g = [np.ascontiguousarray(gallery["label"], np.int64)]
    g += [np.ascontiguousarray(gallery[k], np.float32)
          for k in ("center_x", "center_y", "width", "height")]
    g.append(np.ascontiguousarray(gallery["mask"], np.uint8))
    idx = np.ascontiguousarray(indices, np.int64)
    B, K = idx.shape
    S = g[0].shape[1]
    out = {"label": np.empty((B, K, S), np.int64)}
    for k in ("center_x", "center_y", "width", "height"):
        out[k] = np.empty((B, K, S), np.float32)
    o_mask = np.empty((B, K, S), np.uint8)
    lib.ralf_gather_neighbors(
        *g, idx.reshape(-1), B, K, S,
        *(out[k].reshape(B * K, S) for k in ("label", "center_x", "center_y", "width", "height")),
        o_mask.reshape(B * K, S),
    )
    out["mask"] = o_mask.astype(bool)
    return out
