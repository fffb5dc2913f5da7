"""What the GAN baselines share at sample time, the counterpart of the
sample side of `ralf_tpu/models/gan_common.py`: the packed layout, the
heads' outputs back to a Layout, the random initial layout, and the
IoU-grouping element order (DS-GAN's `use_reorder`).

A packed layout is [B, S, 2, K] (K = the labels + the no-object class K-1):
row 0 the class one-hot (padding is the no-object class), row 1 the
cxcywh box zero-padded to K.  Everything here but `unpack_outputs` is
host-side numpy drawing from the caller's numpy rng, as in JAX, so that
one seed gives the same initial layouts in both packages.

The training side (straight-through argmax, generalized IoU, Hungarian
matching, the set criterion, the hinge loss) is not ported yet (ROADMAP.md
Queue A item 14b).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ralf_tpu_torch.core.layout import GEO_KEYS, Layout

# class-frequency priors of DS-GAN's random class init, by K
DS_COEF = {4: (0.8, 1.0, 1.0, 0.1), 5: (0.8, 0.8, 1.0, 1.0, 0.1)}


def pack_layout(layout: Layout, num_classes_total: int) -> np.ndarray:
    """Layout -> packed [B, S, 2, K] float32: row 0 the class one-hot (pads
    the no-object class K-1), row 1 the cxcywh box zero-padded to K."""
    K = num_classes_total
    lay = layout.numpy()
    cls = np.eye(K, dtype=np.float32)[np.where(lay["mask"], lay["label"], K - 1)]
    box = np.stack([lay[k] for k in GEO_KEYS], axis=-1).astype(np.float32)
    box = np.pad(box, ((0, 0), (0, 0), (0, K - 4)))
    return np.stack([cls, box], axis=2)


def unpack_outputs(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                   num_classes_total: int) -> Layout:
    """The heads' outputs -> Layout; the no-object class empties an element."""
    label = pred_logits.argmax(dim=-1)
    mask = label != num_classes_total - 1
    b = pred_boxes[..., :4].float()
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    geo = {k: torch.where(mask, b[..., i], zero) for i, k in enumerate(GEO_KEYS)}
    return Layout(label=torch.where(mask, label, torch.zeros_like(label)), mask=mask, **geo)


def random_init_layout(rng: np.random.Generator, batch: int, S: int, K: int,
                       coef: Optional[tuple] = None,
                       n_elements: Optional[np.ndarray] = None) -> np.ndarray:
    """A gaussian random packed layout [batch, S, 2, K]: class ~ the coef
    prior, box from N(0.5, 0.15) xyxy corners -> cxcywh.  `n_elements`
    ([batch] counts in [1, S]) starts the positions past each count as the
    no-object class."""
    coef = np.asarray(coef if coef is not None else [1.0] * K, np.float64)
    cls_idx = rng.choice(K, size=(batch, S), p=coef / coef.sum())
    if n_elements is not None:
        beyond = np.arange(S)[None, :] >= np.asarray(n_elements)[:, None]
        cls_idx = np.where(beyond, K - 1, cls_idx)
    cls = np.eye(K, dtype=np.float32)[cls_idx]
    xyxy = rng.normal(0.5, 0.15, size=(batch, S, 4)).astype(np.float32)
    x0, y0, x1, y1 = np.split(xyxy, 4, axis=-1)
    box = np.concatenate([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)
    box = np.pad(box, ((0, 0), (0, 0), (0, K - 4)))
    return np.stack([cls, box], axis=2)


def _box_iou_xyxy(b: np.ndarray) -> np.ndarray:
    area = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return inter / (union + 1e-6)


def reorder(cls_mapped: np.ndarray, box_cxcywh: np.ndarray,
            max_elem: Optional[int] = None) -> list[int]:
    """The IoU-grouping order over PosterLayout's class mapping (0 bg, 1
    text, 2 logo, 3 underlay): logos first, each pulled together with the
    underlay group it touches, then texts by area descending, the stray
    underlays, then the background."""
    n = len(cls_mapped)
    max_elem = max_elem or n
    cx, cy, w, h = box_cxcywh[:, 0], box_cxcywh[:, 1], box_cxcywh[:, 2], box_cxcywh[:, 3]
    iou = _box_iou_xyxy(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1))
    area = np.clip(w, 0, None) * np.clip(h, 0, None)

    cls_np = np.asarray(cls_mapped)
    text = np.where(cls_np == 1)[0]
    logo = np.where(cls_np == 2)[0]
    deco = np.where(cls_np == 3)[0]
    order_text = sorted(text.tolist(), key=lambda i: area[i], reverse=True)
    order_deco = sorted(deco.tolist(), key=lambda i: area[i])

    connection: dict[int, int] = {}
    reverse_connection: dict[int, list[int]] = {}
    for d in order_deco:
        con = []
        for grp in (logo, text):
            for i in grp:
                if iou[d, i] > 0:
                    connection[int(i)] = int(d)
                    con.append(int(i))
        for i in deco:
            if i != d and iou[d, i] > 0:
                con.append(int(i))
        reverse_connection[int(d)] = con

    order: list[int] = []

    def pull(i: int) -> None:
        if i in connection:
            d = connection[i]
            for j in reverse_connection.get(d, []):
                if j not in order:
                    order.append(j)
            if d not in order:
                order.append(d)
        elif i not in order:
            order.append(i)

    for i in logo:
        pull(int(i))
    for i in order_text:
        if len(order) >= max_elem:
            break
        pull(int(i))
    order += [d for d in deco.tolist() if d not in order]
    if len(order) < max_elem:
        order += np.where(cls_np == 0)[0].tolist()
    return [int(i) for i in order[: min(n, max_elem)]]
