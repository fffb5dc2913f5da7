"""Differentiable relation-constraint costs and the diffusion models' logit
update, the counterpart of `ralf_tpu/ops/relation_costs.py`.

`relation_cost` is the mean violated amount of the 14 hinge terms over a
bitmask edge graph whose node 0 is the canvas; `stochastic_convert` gives
the expected geometry under each position's softmax over its bins; and
`update_logits_for_relation` takes a few plain gradient steps on a reverse
step's log-probabilities down that cost, gated off for t < 10.  The
gradient is `torch.autograd.grad` where JAX takes `jax.grad`.  A sampler
may run under `torch.inference_mode`, whose tensors autograd cannot save:
the update leaves inference mode and differentiates a clone.
"""

from __future__ import annotations

import torch

from ralf_tpu_torch.core.layout import GEO_KEYS
from ralf_tpu_torch.core.relationships import REL_SIZE_ALPHA, RelLoc, RelSize
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer
from ralf_tpu_torch.parallel import rows

# the update's gradient steps and their size, as the diffusion samplers take them
RELATION_LAMBDA, NUM_UPDATE = 1.0, 3


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def _le(a, b):  # the violated amount of a <= b
    return _relu(a - b)


def _lt(a, b, eps: float = 1e-8):
    return _relu(a - b + eps)


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v [B, S + 1], idx [B, E] (a negative index reads 0; its edge is invalid)."""
    return torch.gather(v, 1, idx.clamp(min=0))


def stochastic_convert(log_prob: torch.Tensor,
                       tokenizer: LayoutSequenceTokenizer) -> dict[str, torch.Tensor]:
    """[B, L, V] log-probabilities -> the expected geometry {key: [B, S]}."""
    C, N = tokenizer.N_var_per_element, tokenizer.N_bbox_per_var
    var_order = list(tokenizer.config.var_order)
    out = {}
    for key in GEO_KEYS:
        col, off = var_order.index(key), tokenizer.geo_offset(key)
        probs = torch.softmax(log_prob[:, col::C, off : off + N], dim=-1)  # [B, S, N]
        centers = torch.as_tensor(tokenizer.bucketizers[key].centers, device=log_prob.device)
        out[key] = (probs * centers[None, None, :]).sum(dim=-1)
    return out


def relation_cost(bbox_flat: torch.Tensor, edge_idx: torch.Tensor,
                  edge_attr: torch.Tensor) -> torch.Tensor:
    """bbox_flat [B, S + 1, 4] cxcywh (row 0 the canvas), edge_idx [B, E, 2],
    edge_attr [B, E] bitmasks -> the mean of the 14 terms' total violation."""
    cx, cy, w, h = (bbox_flat[..., i] for i in range(4))
    area = w * h
    l, r = cx - w / 2, cx + w / 2
    t, b = cy - h / 2, cy + h / 2
    zi, zj = edge_idx[..., 0], edge_idx[..., 1]
    valid = zi >= 0

    def has(rel):
        return (edge_attr & (1 << int(rel))) != 0

    is_canvas_i = zi == 0
    ai, aj = _gather(area, zi), _gather(area, zj)
    yc_j = _gather(cy, zj)
    li, lj = _gather(l, zi), _gather(l, zj)
    ti, tj = _gather(t, zi), _gather(t, zj)
    ri, rj = _gather(r, zi), _gather(r, zj)
    bi, bj = _gather(b, zi), _gather(b, zj)
    total = torch.zeros(bbox_flat.shape[0], dtype=bbox_flat.dtype, device=bbox_flat.device)

    def acc(total, cost, cond):
        return total + torch.where(cond & valid, cost, torch.zeros_like(cost)).sum(dim=1)

    for canvas in (False, True):  # size terms, for canvas and element i alike
        ci = is_canvas_i == canvas
        total = acc(total, _le(aj, (1 - REL_SIZE_ALPHA) * ai), ci & has(RelSize.SMALLER))
        total = acc(total, _lt((1 - REL_SIZE_ALPHA) * ai, aj) + _lt(aj, (1 + REL_SIZE_ALPHA) * ai),
                    ci & has(RelSize.EQUAL))
        total = acc(total, _le((1 + REL_SIZE_ALPHA) * ai, aj), ci & has(RelSize.LARGER))
    # location on the canvas: thirds of yc
    total = acc(total, _le(yc_j, 1 / 3), is_canvas_i & has(RelLoc.TOP))
    total = acc(total, _lt(1 / 3, yc_j) + _lt(yc_j, 2 / 3), is_canvas_i & has(RelLoc.CENTER))
    total = acc(total, _le(2 / 3, yc_j), is_canvas_i & has(RelLoc.BOTTOM))
    # location between elements
    ei = ~is_canvas_i
    overlap_band = _lt(ti, bj) + _lt(tj, bi)  # vertical overlap, for left / right / center
    total = acc(total, _le(bj, ti), ei & has(RelLoc.TOP))
    total = acc(total, _le(bi, tj), ei & has(RelLoc.BOTTOM))
    total = acc(total, _le(rj, li) + overlap_band, ei & has(RelLoc.LEFT))
    total = acc(total, _le(ri, lj) + overlap_band, ei & has(RelLoc.RIGHT))
    total = acc(total, _lt(li, rj) + _lt(lj, ri) + overlap_band, ei & has(RelLoc.CENTER))
    return rows.batch_mean(total) / 14.0


def update_logits_for_relation(log_prob: torch.Tensor, t: torch.Tensor, edge_idx: torch.Tensor,
                               edge_attr: torch.Tensor, tokenizer: LayoutSequenceTokenizer
                               ) -> torch.Tensor:
    """NUM_UPDATE steps lp <- lp - RELATION_LAMBDA * grad(cost)(lp) * (t >= 10)
    on log_prob [B, L, V], t [B]."""
    with torch.inference_mode(False), torch.enable_grad():
        # clones are normal tensors, which autograd may save
        lp = log_prob.clone()
        edge_idx, edge_attr = edge_idx.clone(), edge_attr.clone()
        B = lp.shape[0]
        canvas = torch.tensor([0.5, 0.5, 1.0, 1.0], dtype=lp.dtype,
                              device=lp.device).expand(B, 1, 4)

        def cost(x: torch.Tensor) -> torch.Tensor:
            coords = stochastic_convert(x, tokenizer)
            bbox = torch.stack([coords[k] for k in GEO_KEYS], dim=-1)
            return relation_cost(torch.cat([canvas, bbox], dim=1), edge_idx, edge_attr)

        gate = (t.clone() >= 10).to(lp.dtype)[:, None, None]
        for _ in range(NUM_UPDATE):
            x = lp.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(cost(x), x)
            lp = lp - RELATION_LAMBDA * g * gate
    return lp.detach()
