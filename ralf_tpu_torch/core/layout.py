"""Layout batch: the port's counterpart of `ralf_tpu/core/layout.py`.

A layout is up to S elements on a canvas, each with a class `label` and a
normalized geometry (center_x, center_y, width, height) in [0, 1].  Variable
length is a boolean `mask` over a statically shaped [B, S] batch.  Fields
are torch tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Canonical order of the geometry attributes; it fixes the per-attribute
# token-vocabulary offsets.
GEO_KEYS = ("center_x", "center_y", "width", "height")
FIELDS = ("label", *GEO_KEYS, "mask")


@dataclasses.dataclass
class Layout:
    """label int64 [B, S] (0 where masked), geometry float32 [B, S], mask bool [B, S]."""

    label: torch.Tensor
    center_x: torch.Tensor
    center_y: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    mask: torch.Tensor

    def geo(self, key: str) -> torch.Tensor:
        return getattr(self, key)

    def numpy(self) -> dict[str, np.ndarray]:
        return {k: getattr(self, k).cpu().numpy() for k in FIELDS}

    @classmethod
    def fromdict(cls, d: dict[str, Any], device=None) -> "Layout":
        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), device=device).to(dtype)

        return cls(
            label=t(d["label"], torch.int64),
            center_x=t(d["center_x"], torch.float32),
            center_y=t(d["center_y"], torch.float32),
            width=t(d["width"], torch.float32),
            height=t(d["height"], torch.float32),
            mask=t(d["mask"], torch.bool),
        )

