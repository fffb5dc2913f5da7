"""Generator configuration, the counterpart of `ralf_tpu/models/base.py`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    d_model: int = 256
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 1024
    backbone: str = "resnet50"
    dtype: Optional[torch.dtype] = None  # compute and parameter dtype; None -> float32
