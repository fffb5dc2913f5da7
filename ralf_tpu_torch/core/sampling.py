"""Logit sampling, the counterpart of `ralf_tpu/core/sampling.py`.

Strategies `deterministic` (argmax), `random` and `top_p` (sort-free
bisection filter, then a draw).  Draws come from an explicit
`torch.Generator` by the Gumbel-max rule, which samples the softmax exactly
and, unlike `torch.multinomial`, never waits on the device; they cannot
reproduce `jax.random`'s numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# logit mask value of the sampler; attention masks use models.nn.NEG_INF (-1e9)
NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    name: str = "random"  # deterministic | random | top_p
    temperature: float = 1.0
    top_p: float = 0.9


def top_p_filter_bisect(logits: torch.Tensor, p: float, iters: int = 26) -> torch.Tensor:
    """Sort-free nucleus filter: keep {i : prob_i >= t*} for the smallest
    threshold t* whose kept mass S(t) = sum(prob[prob >= t]) is <= p, found
    by 26 bisection steps on [0, max prob].  Ties at the threshold are all
    kept, the argmax always is, and p >= 1 is a no-op."""
    if p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    maxp = probs.amax(dim=-1, keepdim=True)
    lo, hi = torch.zeros_like(maxp), maxp
    zero = torch.zeros_like(probs)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid, probs, zero).sum(dim=-1, keepdim=True)
        over = mass > p  # t* lies above mid
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    thresh = torch.minimum(hi, maxp)
    return torch.where(probs < thresh, torch.full_like(logits, NEG_INF), logits)


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits) (Gumbel-max), int64 [...]."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(generator=generator)
    return torch.argmax(logits.float() - torch.log(e), dim=-1)


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (int64)."""
    if cfg.name == "deterministic":
        return torch.argmax(logits, dim=-1)
    scaled = logits / cfg.temperature
    if cfg.name == "top_p":
        scaled = top_p_filter_bisect(scaled, cfg.top_p)
    elif cfg.name != "random":
        raise ValueError(f"sampling strategy {cfg.name!r} is not ported "
                         "(deterministic, random, top_p)")
    return categorical(scaled, generator)
