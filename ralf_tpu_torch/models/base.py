"""Generator configuration, the counterpart of `ralf_tpu/models/base.py`.

It holds every field of JAX's `GeneratorConfig`, with the same defaults, so
that a job dir's `config.json` written by either package loads in the
other.  `dropout` and `label_smoothing` are training fields; the sample
paths read neither.  `dtype` takes a torch dtype, None (float32), or the
text JAX's `json.dump(..., default=str)` writes for one ("bfloat16",
"<class 'jax.numpy.bfloat16'>", "float32", ...).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

_DTYPE_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}


def parse_dtype(value: Any) -> Optional[torch.dtype]:
    """None, a torch dtype, or a dtype's text -> a torch dtype (None stays None)."""
    if value is None or isinstance(value, torch.dtype):
        return value
    text = str(value)
    # "<class 'jax.numpy.bfloat16'>", "torch.bfloat16", "dtype('float32')", "bfloat16"
    found = [d for name, d in _DTYPE_NAMES.items() if re.search(rf"\b{name}\b", text)]
    if len(found) != 1:
        raise ValueError(f"model.dtype {value!r}: expected one of {sorted(_DTYPE_NAMES)} or None")
    return found[0]


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    d_model: int = 256
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 1024
    dropout: float = 0.1
    backbone: str = "resnet50"
    label_smoothing: float = 0.1
    dtype: Optional[torch.dtype] = None  # compute and parameter dtype; None -> float32

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", parse_dtype(self.dtype))
