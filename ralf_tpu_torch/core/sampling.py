"""Logit sampling, the counterpart of `ralf_tpu/core/sampling.py`.

Strategies `deterministic` (argmax), `random`, `top_k`, `top_p` (the
sort-free bisection filter, or with `top_p_prefilter` > 0 the sorted
nucleus over the top-k logits) and `gumbel` (Gumbel noise, then a draw).
`top_p_filter` is the sort formulation, the bisection's oracle.  Draws come from an explicit
`torch.Generator` by the Gumbel-max rule, which samples the softmax exactly
and, unlike `torch.multinomial`, never waits on the device; they cannot
reproduce `jax.random`'s numbers.  Every draw's leading axis is the batch
(`parallel.rows.draw`: a rank of a sharded program draws its rows of the
whole batch's draw).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ralf_tpu_torch.parallel import rows

# logit mask value of the sampler; attention masks use models.nn.NEG_INF (-1e9)
NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    name: str = "random"  # deterministic | random | top_k | top_p | gumbel
    temperature: float = 1.0
    top_k: int = 5
    top_p: float = 0.9
    top_p_prefilter: int = 0  # > 0: nucleus over this many highest logits


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits along the last axis (ties with the k-th
    too), NEG_INF the rest."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter by sorting (the oracle of `top_p_filter_bisect`): keep
    sorted positions whose prefix mass is <= p, and always the argmax."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    first = torch.arange(logits.shape[-1], device=logits.device) == 0
    keep_sorted = (cum <= p) | first
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep_sorted, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


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
    e = rows.draw(lambda shape: torch.empty(shape, device=logits.device).exponential_(
        generator=generator), logits.shape)
    return torch.argmax(logits.float() - torch.log(e), dim=-1)


def _nucleus_sample_prefiltered(scaled: torch.Tensor, p: float, k: int,
                                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Nucleus sampling over the k highest logits (sorted descending), the
    draw mapped back through their indices."""
    vals, idx = torch.topk(scaled, k, dim=-1)
    cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    keep = (cum <= p) | (torch.arange(k, device=vals.device) == 0)
    choice = categorical(torch.where(keep, vals, torch.full_like(vals, NEG_INF)), generator)
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: Optional[torch.Generator] = None,
           temperature: Optional[float] = None) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (int64); `temperature` overrides
    cfg.temperature (the relation decode's retries)."""
    if cfg.name == "deterministic":
        return torch.argmax(logits, dim=-1)
    scaled = logits / (cfg.temperature if temperature is None else temperature)
    if cfg.name == "top_p" and 0 < cfg.top_p_prefilter < logits.shape[-1]:
        return _nucleus_sample_prefiltered(scaled, cfg.top_p, cfg.top_p_prefilter, generator)
    if cfg.name == "top_k":
        scaled = top_k_filter(scaled, cfg.top_k)
    elif cfg.name == "top_p":
        scaled = top_p_filter_bisect(scaled, cfg.top_p)
    elif cfg.name == "gumbel":
        # Gumbel noise, then a draw from the noisy softmax: doubly stochastic,
        # as the JAX package (and the reference it follows) does
        u = rows.draw(lambda shape: torch.rand(shape, generator=generator, device=scaled.device),
                      scaled.shape)
        c = 1e-30
        scaled = scaled - torch.log(-torch.log(u + c) + c)
    elif cfg.name != "random":
        raise ValueError(f"unknown sampling strategy: {cfg.name}")
    return categorical(scaled, generator)
