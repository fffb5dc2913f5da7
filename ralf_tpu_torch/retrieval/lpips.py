"""LPIPS perceptual distance and the retrieval rerank by it: the counterpart
of `ralf_tpu/retrieval/lpips.py`.

  * `net="alex"` (default): `models/towers.AlexNetFeatures`' five taps behind
    the lpips scaling layer, each tap's squared difference of channel-unit
    maps weighted by the learned lins when `{cache_dir}/lpips_alex.pth` (an
    `lpips.LPIPS(net="alex")` state_dict) is there; without it the tower runs
    randomly initialised with uniform channel weights, loudly.
  * `net="vgg"`: VGG16's LPIPS taps on the R_shm checkpoint (`vgg16.pt`).

Distances are [B] per call over NCHW taps; `lpips_rerank` reorders each
query's candidate pool by ascending distance, fetching the query and
candidate canvases `chunk` query rows at a time.  `cli.build_caches
--rerank lpips` writes the result under the backbone key `lpips`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ralf_tpu_torch.models.towers import (
    LPIPS_SCALE,
    LPIPS_SHIFT,
    TOWER_SPECS,
    AlexNetFeatures,
    VGG16Features,
    load_tower,
    resize_normalize,
    seeded,
)
from ralf_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def lpips_scale(images01: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 1] -> the lpips input: 2x - 1, then (x - shift) / scale."""
    x = 2.0 * images01 - 1.0
    shift = torch.tensor(LPIPS_SHIFT, dtype=x.dtype, device=x.device)[:, None, None]
    scale = torch.tensor(LPIPS_SCALE, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - shift) / scale


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips.normalize_tensor: unit L2 norm over the channels of each pixel."""
    return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + eps)


def lpips_from_taps(taps_a: Sequence[torch.Tensor], taps_b: Sequence[torch.Tensor],
                    channel_weights: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """[B] distances from two tap lists ([B, C, H, W] each): per tap the
    squared difference of the channel-unit maps, weighted per channel,
    summed over the channels and averaged over the pixels; summed over the taps."""
    total = 0.0
    for li, (fa, fb) in enumerate(zip(taps_a, taps_b)):
        d = (_unit_normalize(fa.float()) - _unit_normalize(fb.float())) ** 2
        if channel_weights is not None:
            d = d * channel_weights[li].to(d.device)[:, None, None]
        total = total + d.sum(dim=1).mean(dim=(-2, -1))
    return total


def make_lpips_fns(cache_dir: str = "cache", size: int = 224, net: str = "alex",
                   device="cuda"):
    """(embed_taps, dist_fn): the taps of images [B, H, W, C >= 3] in [0, 1]
    (numpy or tensor) on `device`, and the distance between two tap lists."""
    dev = resolve_device(device)
    channel_weights = None
    if net == "alex":
        from ralf_tpu_torch.utils.checkpoints import load_tower_if_available

        module = seeded(AlexNetFeatures)
        path = os.path.join(cache_dir, "lpips_alex.pth")
        loaded = load_tower_if_available(path, "lpips_alex")
        if loaded is not None:
            tower, lins = loaded
            module.load_state_dict(tower, strict=True)
            channel_weights = [w.to(dev) for w in lins]
            log.info("lpips: loaded AlexNet tower + learned lins from %s", path)
        else:
            log.warning("lpips: no %s — AlexNet taps RANDOMLY INITIALIZED with uniform "
                        "channel weights (consistent ranking, not the trained perceptual "
                        "space)", path)

        def prepare(x):
            return lpips_scale(resize_normalize(x, size, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))

        run = module
    elif net == "vgg":
        _, _, mean, std, ckpt, kind = TOWER_SPECS["vgg"]
        module = seeded(VGG16Features)
        load_tower(module, os.path.join(cache_dir, ckpt), kind, "lpips vgg")

        def prepare(x):
            return resize_normalize(x, size, mean, std)

        def run(x):
            return module(x, return_taps=True)
    else:
        raise ValueError(f"unknown lpips net {net!r}; choose alex or vgg")
    module.to(dev).eval()

    @torch.inference_mode()
    def embed_taps(images) -> list[torch.Tensor]:
        x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        return run(prepare(x.to(dev)[..., :3].float()))

    @torch.inference_mode()
    def dist_fn(taps_a, taps_b) -> torch.Tensor:
        return lpips_from_taps(taps_a, taps_b, channel_weights)

    return embed_taps, dist_fn


def lpips_rerank(query_images_fn, candidates: np.ndarray, gallery_images_fn,
                 cache_dir: str = "cache", size: int = 224, chunk: int = 8, net: str = "alex",
                 device="cuda") -> np.ndarray:
    """Each row of `candidates` [B, C] (gallery indices) reordered by
    ascending LPIPS distance to its query; `query_images_fn(rows)` and
    `gallery_images_fn(rows)` give canvases [n, H, W, C >= 3] in [0, 1]."""
    embed_taps, dist_fn = make_lpips_fns(cache_dir, size, net=net, device=device)
    B, C = candidates.shape
    out = np.zeros_like(candidates)
    for s in range(0, B, chunk):
        idx = np.arange(s, min(s + chunk, B))
        q_taps = embed_taps(np.asarray(query_images_fn(idx), np.float32))
        cand = candidates[idx]
        c_taps = embed_taps(np.asarray(gallery_images_fn(cand.reshape(-1)), np.float32))
        qc_taps = [t.repeat_interleave(C, dim=0) for t in q_taps]
        d = dist_fn(qc_taps, c_taps).cpu().numpy().reshape(len(idx), C)
        out[idx] = np.take_along_axis(cand, np.argsort(d, axis=1, kind="stable"), axis=1)
    return out
