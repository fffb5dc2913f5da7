"""Element-count distribution, the counterpart of
`ralf_tpu/core/seq_length.py`: a 0.999-EMA over the per-batch histogram of
element counts, sampled to give the element counts of non-autoregressive
generation.  Host-side numpy, drawing from the caller's numpy rng as the
JAX package does, so that one seed gives the same counts in both."""

from __future__ import annotations

import numpy as np


class SeqLengthDistribution:
    """EMA of the element-count histogram; counts are in [1, S]."""

    def __init__(self, max_seq_length: int, weight: float = 0.999) -> None:
        self.max_seq_length = max_seq_length
        self.weight = weight
        self.n_elements_prob = np.full((max_seq_length,), 1.0 / max_seq_length, np.float64)

    def update(self, mask: np.ndarray) -> None:
        """One EMA step from a [B, S] bool element mask; empty layouts fall out
        of the histogram, so its total mass shrinks, as in JAX."""
        mask = np.asarray(mask)
        if mask.ndim != 2:
            raise ValueError(f"mask must be [B, S], got {mask.shape}")
        S = self.max_seq_length
        n = mask.sum(1).astype(np.int64)
        batch_prob = np.bincount(n, minlength=S + 1)[1:S + 1] / mask.shape[0]
        self.n_elements_prob = self.weight * self.n_elements_prob + (1 - self.weight) * batch_prob

    def sample(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        """[batch_size] element counts in [1, S] drawn from the EMA histogram."""
        p = self.n_elements_prob / self.n_elements_prob.sum()
        return rng.choice(self.max_seq_length, size=batch_size, p=p) + 1
