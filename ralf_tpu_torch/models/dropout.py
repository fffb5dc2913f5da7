"""Dropout with an explicit generator, the counterpart of flax's `nn.Dropout`.

In train mode each element is kept with probability 1 - p and then divided
by 1 - p (flax: `where(keep, x / keep_prob, 0)`); in eval mode, or at
p = 0, it is the identity, as flax is when `deterministic` or rate 0.  The
keep mask is drawn with `torch.bernoulli` from the module's `generator`,
never from the global RNG: the trainer gives every Dropout of a model one
generator (`set_dropout_generator`) and seeds it from (seed, step) before
each step, so that a resumed run draws the masks an uninterrupted one
draws, as JAX's replayed key stream does.  torch cannot reproduce
`jax.random`'s numbers, so only the frequencies of the masks match JAX's.  A rank of a data-parallel
step draws its rows of the whole batch's masks (`parallel.rows.draw`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ralf_tpu_torch.parallel import rows


class Dropout(nn.Module):
    def __init__(self, p: float) -> None:
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must lie in [0, 1), got {p}")
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: call "
                               "set_dropout_generator(model, torch.Generator(...)) first")
        keep_prob = 1.0 - self.p
        keep = rows.draw(lambda shape: torch.empty(shape, device=x.device).bernoulli_(
            keep_prob, generator=self.generator), x.shape)
        return torch.where(keep.bool(), x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every Dropout inside `module` the one generator its masks come from."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
