"""Masking helpers of the masked-parallel decoders (MaskGIT), the
counterpart of `ralf_tpu/core/mask.py`.

`batch_topk_mask` keeps the JAX package's >= kth semantics, ties included,
and with them its step-0 quirk: a row with no eligible position has the
k-th score -inf, and -inf >= -inf is True, so the whole row is returned
True.  MaskGIT's sampler relies on it to re-mask everything after its
first step (`models/maskgit.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ralf_tpu_torch.parallel import rows


def batch_topk_mask(scores: torch.Tensor, topk: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(topk_mask [B, S] bool, kth score [B, 1]): the k largest eligible scores
    of each row (every score >= the k-th, ties included)."""
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -math.inf))
    sorted_desc = torch.sort(scores, dim=-1, descending=True).values
    idx = torch.clamp(topk.long() - 1, 0, scores.shape[1] - 1)[:, None]
    kth = torch.gather(sorted_desc, 1, idx)
    return scores >= kth, kth


def sequence_mask(length: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B] lengths -> [B, maxlen] bool."""
    return torch.arange(maxlen, device=length.device)[None, :] < length[:, None]


def sample_mask(mask: torch.Tensor, ratio: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """About ratio of each row's True positions, at least one, picked at random."""
    scores = rows.draw(lambda shape: torch.rand(shape, generator=generator, device=mask.device),
                       mask.shape)
    n_elem = mask.sum(dim=-1)
    topk = torch.clamp((ratio * n_elem).to(torch.int32), min=1)
    picked, _ = batch_topk_mask(scores, topk, mask=mask)
    return picked & mask


def mask_schedule(ratio: torch.Tensor, schedule: str = "linear") -> torch.Tensor:
    """MaskGIT's mask-rate schedules: ratio in [0, 1] -> mask rate in (0, 1], fp32."""
    ratio = ratio.float()
    if schedule == "linear":
        r = 1.0 - ratio
    elif schedule == "cosine":
        r = torch.cos(math.pi * 0.5 * ratio)
    elif schedule == "square":
        r = 1.0 - ratio**2
    elif schedule == "cubic":
        r = 1.0 - ratio**3
    elif schedule == "sqrt":
        r = 1.0 - torch.sqrt(ratio)
    else:
        raise NotImplementedError(schedule)
    return torch.clamp(r, 1e-6, 1.0)
