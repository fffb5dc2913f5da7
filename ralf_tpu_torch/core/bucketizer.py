"""Geometry quantizer, continuous [0, 1] coordinates <-> discrete bins.

Counterpart of `ralf_tpu/core/bucketizer.py`: the linear (uniform)
quantizer and the k-means adaptive one defined by sorted cluster centers,
with `fit_kmeans_1d`, the plain-numpy Lloyd fit that builds such centers.
Encoding follows searchsorted(boundaries, x, side='left') after
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


def kmeans_bucketizer(cluster_centers: np.ndarray) -> Bucketizer:
    """Adaptive quantization from (unsorted) 1-d k-means cluster centers:
    boundaries are the midpoints between consecutive sorted centers, with
    1.0 as the last right edge."""
    centers = np.sort(np.asarray(cluster_centers, np.float64).reshape(-1))
    mids = (centers[:-1] + centers[1:]) / 2.0
    boundaries = np.concatenate([mids, np.ones((1,))])
    return Bucketizer(boundaries=boundaries, centers=centers)


def fit_kmeans_1d(values: np.ndarray, n_clusters: int, n_iters: int = 50,
                  seed: int = 0) -> np.ndarray:
    """1-d k-means (Lloyd's), initialised at spread quantiles with a 1e-6
    jitter from `seed`; returns the sorted centers [n_clusters]."""
    values = np.asarray(values, np.float64).reshape(-1)
    rng = np.random.default_rng(seed)
    qs = np.linspace(0.0, 1.0, n_clusters + 2)[1:-1]
    centers = np.quantile(values, qs)
    centers += rng.normal(0, 1e-6, size=centers.shape)  # break ties
    for _ in range(n_iters):
        assign = np.abs(values[:, None] - centers[None, :]).argmin(axis=1)
        for k in range(n_clusters):
            sel = values[assign == k]
            if sel.size:
                centers[k] = sel.mean()
    return np.sort(centers)
