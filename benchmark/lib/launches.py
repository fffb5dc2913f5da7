"""Shapes of kernel calls, recorded during the profiled requests so that a
roofline reader can give each call its bound.  A recorder wraps the
module-level name that the program looks up at each call, passes every
argument through unchanged, and is removed on exit."""

from __future__ import annotations

import contextlib
import importlib


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


def k1_shape(q, k, v, nhead, key_bias):
    """(B, S, E, masked, dtype) of a K1 launch."""
    return (q.shape[0], q.shape[1], q.shape[2], key_bias is not None, _dtype(q))


def k2_shape(q_tilde, mem):
    """(B, M, H, E, dtype) of a K2 call."""
    return (mem.shape[0], mem.shape[1], q_tilde.shape[1], mem.shape[2], _dtype(mem))


# kernel id: (module, attribute the program calls through, shape of a call)
TARGETS = {
    "K1": ("ralf_tpu_torch.ops.encoder_attention", "_launch_encoder_attention", k1_shape),
    "K2": ("ralf_tpu_torch.models.nn", "decode_shared_attention", k2_shape),
}


@contextlib.contextmanager
def recorded(kernels):
    """{kernel id: [shape of each call]} for the calls made inside."""
    calls, undo = {k: [] for k in kernels}, []
    for kid in kernels:
        module_name, attr, shape = TARGETS[kid]
        module = importlib.import_module(module_name)
        inner = getattr(module, attr)

        def wrapper(*args, _inner=inner, _shape=shape, _calls=calls[kid]):
            _calls.append(_shape(*args))
            return _inner(*args)

        setattr(module, attr, wrapper)
        undo.append((module, attr, inner))
    try:
        yield calls
    finally:
        for module, attr, inner in undo:
            setattr(module, attr, inner)
