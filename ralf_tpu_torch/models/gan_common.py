"""What the GAN baselines share, the counterpart of
`ralf_tpu/models/gan_common.py`: the packed layout, the heads' outputs back
to a Layout, the random initial layout, the IoU-grouping element order
(DS-GAN's `use_reorder`), and the training side: the straight-through
argmax, generalized IoU, the Hungarian matching, DETR's set criterion and
the hinge loss.

A packed layout is [B, S, 2, K] (K = the labels + the no-object class K-1):
row 0 the class one-hot (padding is the no-object class), row 1 the
cxcywh box zero-padded to K.  Everything here but `unpack_outputs` is
host-side numpy drawing from the caller's numpy rng, as in JAX, so that
one seed gives the same initial layouts in both packages.

The matching solves its assignment on the device, one `ops.assignment`
launch a call with no read-back, as JAX solves it under jit.  Ties of a
max or a clip split their gradient in halves, as `jnp.maximum`'s do:
`torch.maximum` and `torch.minimum` against a tensor, never
`clamp`, which passes the whole gradient at the tie (a discriminator's
tanh saturates at exactly 1.0 in fp32, where the hinge's max(0, 1 - x) is
at its kink).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ralf_tpu_torch.core.layout import GEO_KEYS, Layout
from ralf_tpu_torch.ops.assignment import batched_lsa
from ralf_tpu_torch.parallel import rows

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


# ---- training: straight-through argmax, matching, losses --------------------------


class _StraightThroughArgmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed: torch.Tensor) -> torch.Tensor:
        cls = packed[:, :, 0]
        hard = F.one_hot(cls.argmax(-1), cls.shape[-1]).to(packed.dtype)
        out = packed.clone()
        out[:, :, 0] = hard
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad


def straight_through_argmax(packed: torch.Tensor) -> torch.Tensor:
    """[B, S, 2, K]: the class row hardened to the one-hot of its first
    argmax; the gradient passes through unchanged (JAX's custom_vjp)."""
    return _StraightThroughArgmax.apply(packed)


def _clip0(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xyxy boxes [..., N, 4] x [..., M, 4] -> [..., N, M] gIoU."""
    area_a = _clip0(a[..., 2] - a[..., 0]) * _clip0(a[..., 3] - a[..., 1])
    area_b = _clip0(b[..., 2] - b[..., 0]) * _clip0(b[..., 3] - b[..., 1])
    a_, b_ = a[..., :, None, :], b[..., None, :, :]
    wh = _clip0(torch.minimum(a_[..., 2:], b_[..., 2:]) - torch.maximum(a_[..., :2], b_[..., :2]))
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / (union + 1e-6)
    whm = _clip0(torch.maximum(a_[..., 2:], b_[..., 2:]) - torch.minimum(a_[..., :2], b_[..., :2]))
    hull = whm[..., 0] * whm[..., 1]
    return iou - (hull - union) / (hull + 1e-6)


def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor, cost_class: float = 2.0,
                    cost_bbox: float = 5.0, cost_giou: float = 2.0) -> torch.Tensor:
    """[B, S] int32, the target slot matched to each query: square matching
    over all S slots (the padded no-object slots are targets too), on the
    detached cost 5 L1 - 2 prob[target class] - 2 gIoU with NaN -> 1e5 and
    +-inf -> +-1e5."""
    B, S = pred_logits.shape[:2]
    with torch.no_grad():
        pred_boxes, tgt_boxes = pred_boxes[..., :4], tgt_boxes[..., :4]
        prob = torch.softmax(pred_logits, -1)
        c_cls = -prob.gather(2, tgt_labels[:, None, :].expand(B, S, S))
        c_l1 = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
        giou = generalized_box_iou(_box_cxcywh_to_xyxy(pred_boxes),
                                   _box_cxcywh_to_xyxy(tgt_boxes))
        cost = cost_bbox * c_l1 + cost_class * c_cls + cost_giou * -giou
        cost = torch.nan_to_num(cost, nan=1e5, posinf=1e5, neginf=-1e5)
        return batched_lsa(cost.float().contiguous())


def set_criterion(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, tgt_labels: torch.Tensor,
                  tgt_boxes: torch.Tensor, empty_weight: torch.Tensor,
                  num_classes_total: int) -> dict[str, torch.Tensor]:
    """DETR's losses over the Hungarian assignment: the CE over every query
    weighted by its matched target's class weight, over max(sum of the
    weights, 1e-8) (the global batch's in a data-parallel step,
    `parallel.rows`); L1 and 1 - gIoU of the matched boxes over B * S.  Also
    `match`, the assignment [B, S] int32."""
    pred_boxes, tgt_boxes = pred_boxes[..., :4], tgt_boxes[..., :4]
    match = hungarian_match(pred_logits, pred_boxes, tgt_labels, tgt_boxes)
    idx = match.long()
    tgt_l = tgt_labels.gather(1, idx)
    tgt_b = tgt_boxes.gather(1, idx[..., None].expand(*idx.shape, 4))
    logp = torch.log_softmax(pred_logits.float(), -1)
    w = empty_weight[tgt_l]
    ce = -logp.gather(-1, tgt_l[..., None])[..., 0]
    loss_ce = (ce * w).sum() / rows.mean_denominator(w.sum(), 1e-8)
    num_boxes = tgt_labels.shape[0] * tgt_labels.shape[1]  # equal shards: a plain mean
    loss_bbox = (pred_boxes - tgt_b).abs().sum() / num_boxes
    giou = generalized_box_iou(_box_cxcywh_to_xyxy(pred_boxes),
                               _box_cxcywh_to_xyxy(tgt_b)).diagonal(dim1=-2, dim2=-1)
    loss_giou = (1.0 - giou).sum() / num_boxes
    return {"loss_ce": loss_ce, "loss_bbox": loss_bbox, "loss_giou": loss_giou, "match": match}


def hinge_embedding_loss(x: torch.Tensor, target: torch.Tensor,
                         margin: float = 1.0) -> torch.Tensor:
    """torch.nn.HingeEmbeddingLoss's mean: x where target > 0, else
    max(0, margin - x) (the max's gradient halved at the tie, as JAX's)."""
    return torch.where(target > 0, x, _clip0(margin - x)).mean()
