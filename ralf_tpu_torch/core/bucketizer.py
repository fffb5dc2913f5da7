"""Geometry quantizer, continuous [0, 1] coordinates <-> discrete bins.

Counterpart of `ralf_tpu/core/bucketizer.py` for the linear (uniform)
quantizer.  Encoding follows searchsorted(boundaries, x, side='left') after
clamping to [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch


class Bucketizer:
    """Quantizer defined by bin boundaries (right edges) and centers."""

    def __init__(self, boundaries: np.ndarray, centers: np.ndarray) -> None:
        assert boundaries.ndim == 1 and boundaries.shape == centers.shape
        self.boundaries = np.asarray(boundaries, np.float32)
        self.centers = np.asarray(centers, np.float32)

    @property
    def n_bins(self) -> int:
        return int(self.centers.shape[0])

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """float [...] in [0, 1] -> int64 bin index [...]."""
        edges = torch.as_tensor(self.boundaries, device=x.device)
        return torch.searchsorted(edges, x.float().clamp(0.0, 1.0).contiguous(), right=False)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        """int [...] bin index -> float32 bin center [...]."""
        centers = torch.as_tensor(self.centers, device=idx.device)
        return centers[idx.clamp(0, self.n_bins - 1)]


def linear_bucketizer(n_bins: int) -> Bucketizer:
    """Uniform quantization of [0, 1] into n_bins equal bins."""
    edges = np.arange(n_bins + 1, dtype=np.float64) / n_bins
    starts, ends = edges[:-1], edges[1:]
    return Bucketizer(boundaries=ends, centers=(starts + ends) / 2.0)
