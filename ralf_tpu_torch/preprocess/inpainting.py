"""The inpainting stage of the offline dataset build, the counterpart of
`ralf_tpu/preprocess/inpainting.py`: the train posters' layout elements are
removed with big-lama under the dilated union of their boxes.

    inpaint(images, box_union_mask(layout, H, W), lama_path="cache/big-lama.pt")

The generator (`preprocess/lama.py`) runs batched on `device` (the card by
default; it raises without CUDA); the released TorchScript file is read
only for its weights.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.utils.device import resolve_device


def box_union_mask(layout: Layout, height: int, width: int, dilate: int = 9) -> np.ndarray:
    """The dilated union of the layout's boxes, uint8 [B, H, W] in {0, 255}."""
    lay = layout.numpy()
    m = lay["mask"]
    cx, cy, w, h = (lay[k] for k in ("center_x", "center_y", "width", "height"))
    l, r = (np.clip((cx + s * w / 2) * width, 0, width) for s in (-1, 1))
    t, b = (np.clip((cy + s * h / 2) * height, 0, height) for s in (-1, 1))
    l, r, t, b = (np.round(x).astype(int) for x in (l, r, t, b))
    mask = np.zeros((m.shape[0], height, width), np.uint8)
    for i, e in zip(*np.nonzero(m)):
        mask[i, max(t[i, e] - dilate, 0): b[i, e] + dilate,
             max(l[i, e] - dilate, 0): r[i, e] + dilate] = 255
    return mask


def inpaint(images: np.ndarray, masks: np.ndarray, lama_path: str = "cache/big-lama.pt",
            batch_size: int = 8, device="cuda") -> np.ndarray:
    """[B, H, W, 3] uint8 or float images and [B, H, W] {0, 255} masks ->
    the inpainted float32 images in [0, 1], [B, H, W, 3]: padded to a
    multiple of 8 (numpy "symmetric"), run in batches of `batch_size`, and
    cropped back."""
    from ralf_tpu_torch.preprocess.lama import build_generator, load_lama_params, pad_to_modulo

    dev = resolve_device(device)
    if not os.path.exists(lama_path):
        raise FileNotFoundError(
            f"LaMa weights not found at {lama_path}. Download big-lama.pt (see the "
            "reference README) and pass its path; inpainting is a one-time offline "
            "preprocessing step.")
    gen = build_generator(load_lama_params(lama_path)).to(dev)
    imgs = np.asarray(images, np.float32)
    if imgs.max() > 1.0:
        imgs = imgs / 255.0
    msk = (np.asarray(masks) > 127).astype(np.float32)[..., None]
    imgs_p, (H, W) = pad_to_modulo(imgs)
    msk_p, _ = pad_to_modulo(msk)
    out = []
    with torch.inference_mode():
        for s in range(0, imgs_p.shape[0], batch_size):
            x, m = (torch.from_numpy(a[s: s + batch_size]).to(dev).permute(0, 3, 1, 2)
                    for a in (imgs_p, msk_p))
            out.append(gen(x, m).permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(out)[:, :H, :W]
