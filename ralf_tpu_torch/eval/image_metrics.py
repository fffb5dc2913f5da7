"""The image-side evaluation scores, image FID and R_shm: the counterpart of
`ralf_tpu/eval/image_metrics.py`.

  * image FID: FID (and precision, recall, density, coverage) between the
    InceptionV3 features of GT-masked and of predicted-masked canvases
    (`mask_out_bbox_area` fills each box with 0.5), the keys prefixed `image_`;
  * R_shm: per sample, the L2 distance between VGG16's features of the canvas
    and of its layout-masked copy; higher means the layout covers more of
    what the network sees.

`tower_feature_fn` builds the batched extractor from `models/towers.py` on
the device; every function here also takes any
`feature_fn(images [B, H, W, 3]) -> [B, D]` that returns numpy.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.eval.metrics import compute_generative_model_scores
from ralf_tpu_torch.eval.visualizer import mask_out_bbox_area


def tower_feature_fn(kind: str, cache_dir: str = "cache", batch_size: int = 64,
                     device="cuda") -> Callable:
    """`fn(images numpy [B, H, W, C]) -> numpy [B, D]` of the `inception`
    (image FID) or `vgg` (R_shm) tower, `batch_size` canvases a call."""
    from ralf_tpu_torch.models.towers import build_feature_fn

    tower = build_feature_fn(kind, cache_dir, device)

    def fn(images: np.ndarray) -> np.ndarray:
        x = np.asarray(images, np.float32)
        return np.concatenate([tower(x[s:s + batch_size]).cpu().numpy()
                               for s in range(0, len(x), batch_size)], 0)

    return fn


def masked_features(layout: Layout, images: np.ndarray, feature_fn: Callable) -> np.ndarray:
    """Features of the layout-masked canvases: the chunk unit of image FID."""
    return np.asarray(feature_fn(mask_out_bbox_area(layout, images)))


def compute_image_fid(real_feats: np.ndarray, fake_feats: np.ndarray) -> dict[str, float]:
    """FID and prdc between the GT-masked and the predicted-masked canvases'
    features (`masked_features`, gathered over the chunks), keys prefixed
    `image_`."""
    out = compute_generative_model_scores(real_feats, fake_feats)
    return {f"image_{k}": v for k, v in out.items()}


def compute_rshm(layout: Layout, images: np.ndarray, feature_fn: Callable) -> np.ndarray:
    """[B] L2 distances between the canvas's features and its masked copy's."""
    f_img = np.asarray(feature_fn(np.asarray(images)[..., :3]))
    f_masked = np.asarray(feature_fn(mask_out_bbox_area(layout, images)))
    return np.sqrt(((f_img - f_masked) ** 2).sum(-1))
