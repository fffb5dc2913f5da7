"""Layout rendering utilities, the counterpart of `ralf_tpu/eval/visualizer.py`:
translucent per-class boxes over the canvas, a grid montage, and
`mask_out_bbox_area`, the layout-masked canvas of the image-FID features.

Numpy rasterization with the JAX package's output; a layout's fields may
be torch tensors on any device or numpy arrays.
"""

from __future__ import annotations

import numpy as np

from ralf_tpu_torch.core.layout import Layout


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

# per-class RGB palette (text, logo, underlay, embellishment, ...)
PALETTE = np.asarray(
    [
        (0.298, 0.447, 0.690),
        (0.866, 0.517, 0.321),
        (0.333, 0.658, 0.407),
        (0.768, 0.305, 0.321),
        (0.505, 0.447, 0.698),
    ],
    np.float32,
)


def render_layout(
    layout: Layout, images: np.ndarray, alpha: float = 0.5, border: int = 2
) -> np.ndarray:
    """[B, H, W, >=3] canvases + layouts -> [B, H, W, 3] rendered posters."""
    imgs = _np(images)[..., :3].copy()
    B, H, W = imgs.shape[:3]
    lab = _np(layout.label)
    mask = _np(layout.mask)
    l = np.clip((_np(layout.center_x) - _np(layout.width) / 2) * W, 0, W)
    r = np.clip((_np(layout.center_x) + _np(layout.width) / 2) * W, 0, W)
    t = np.clip((_np(layout.center_y) - _np(layout.height) / 2) * H, 0, H)
    b = np.clip((_np(layout.center_y) + _np(layout.height) / 2) * H, 0, H)
    l, r, t, b = (np.round(x).astype(int) for x in (l, r, t, b))
    for i in range(B):
        for e in range(lab.shape[1]):
            if not mask[i, e] or r[i, e] <= l[i, e] or b[i, e] <= t[i, e]:
                continue
            color = PALETTE[lab[i, e] % len(PALETTE)]
            region = imgs[i, t[i, e] : b[i, e], l[i, e] : r[i, e]]
            imgs[i, t[i, e] : b[i, e], l[i, e] : r[i, e]] = (
                (1 - alpha) * region + alpha * color
            )
            # opaque border
            bb = border
            imgs[i, t[i, e] : b[i, e], l[i, e] : l[i, e] + bb] = color
            imgs[i, t[i, e] : b[i, e], max(r[i, e] - bb, 0) : r[i, e]] = color
            imgs[i, t[i, e] : t[i, e] + bb, l[i, e] : r[i, e]] = color
            imgs[i, max(b[i, e] - bb, 0) : b[i, e], l[i, e] : r[i, e]] = color
    return np.clip(imgs, 0, 1)


def montage(images: np.ndarray, ncols: int = 4, pad: int = 2) -> np.ndarray:
    """[N, H, W, 3] -> one grid image."""
    imgs = _np(images)
    N, H, W, C = imgs.shape
    nrows = (N + ncols - 1) // ncols
    out = np.ones((nrows * (H + pad) - pad, ncols * (W + pad) - pad, C), imgs.dtype)
    for i in range(N):
        rr, cc = divmod(i, ncols)
        out[rr * (H + pad) : rr * (H + pad) + H, cc * (W + pad) : cc * (W + pad) + W] = imgs[i]
    return out


def mask_out_bbox_area(layout: Layout, images: np.ndarray,
                       fill: float = 0.5) -> np.ndarray:
    """Gray-fill every layout box on the canvas (`visualizer.py:147-177`) —
    the input to the image-FID feature extractor."""
    imgs = _np(images)[..., :3].copy()
    B, H, W = imgs.shape[:3]
    mask = _np(layout.mask)
    l = np.round(np.clip((_np(layout.center_x) - _np(layout.width) / 2), 0, 1) * W).astype(int)
    r = np.round(np.clip((_np(layout.center_x) + _np(layout.width) / 2), 0, 1) * W).astype(int)
    t = np.round(np.clip((_np(layout.center_y) - _np(layout.height) / 2), 0, 1) * H).astype(int)
    b = np.round(np.clip((_np(layout.center_y) + _np(layout.height) / 2), 0, 1) * H).astype(int)
    for i in range(B):
        for e in range(mask.shape[1]):
            if mask[i, e]:
                imgs[i, t[i, e] : b[i, e], l[i, e] : r[i, e]] = fill
    return imgs
