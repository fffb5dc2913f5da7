"""Layout quality metrics, the counterpart of `ralf_tpu/eval/metrics.py`.

The layout and saliency metrics are batched torch over padded [B, S]
layouts (and [B, H, W, 4] canvases) on the layout's device, the same
formulas and masks as JAX's:

  * alignment and overlap (LayoutGAN++), overlay and underlay
    effectiveness (PosterLayout), per sample [B];
  * validity: the filtered layout and the kept share of elements;
  * utilization, occlusion, unreadability: over the pixel raster of the
    boxes, rounded-integer half-open bounds (`canvas[t:b, l:r]`), and the
    Sobel gradient of the BT.601 gray image.

A sample with no result is NaN, dropped by `nanmean`.  FID and
precision/recall/density/coverage stay numpy, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ralf_tpu_torch.core.layout import Layout

EPS_F32 = float(np.finfo(np.float32).eps)


def _coords(layout: Layout, validate: bool = True):
    """(xl, xc, xr, yt, yc, yb), optionally clamped to the canvas."""
    xl = layout.center_x - layout.width / 2.0
    xr = layout.center_x + layout.width / 2.0
    yt = layout.center_y - layout.height / 2.0
    yb = layout.center_y + layout.height / 2.0
    if validate:
        xl, xr = xl.clamp_min(0.0), xr.clamp_max(1.0)
        yt, yb = yt.clamp_min(0.0), yb.clamp_max(1.0)
    return xl, layout.center_x, xr, yt, layout.center_y, yb


def _eye(S: int, device) -> torch.Tensor:
    return torch.eye(S, dtype=torch.bool, device=device)


def _per_element_mean(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum(dim=1)
    return torch.where(n > 0, score / n.clamp_min(1), torch.zeros_like(score))


def compute_alignment(layout: Layout) -> torch.Tensor:
    """alignment-LayoutGAN++ per sample [B]: mean over elements of
    -log10(1 - the least edge or center delta to another element)."""
    mask = layout.mask
    S = mask.shape[1]
    X = torch.stack(_coords(layout), dim=1)  # [B, 6, S]
    D = (X[:, :, :, None] - X[:, :, None, :]).abs()  # [B, 6, S, S]
    D = D.masked_fill(_eye(S, D.device)[None, None], 1.0)
    D = D.permute(0, 2, 1, 3)  # [B, S, 6, S]
    D = torch.where(mask[:, :, None, None], D, torch.ones_like(D))
    m = D.amin(dim=(2, 3))  # [B, S]
    m = torch.where(m == 1.0, torch.zeros_like(m), m)
    return _per_element_mean((-torch.log10(1.0 - m)).sum(dim=1), mask)


def _clean_padding(layout: Layout) -> Layout:
    m = layout.mask
    zero = torch.zeros_like(layout.center_x)
    return Layout(label=torch.where(m, layout.label, torch.zeros_like(layout.label)),
                  center_x=torch.where(m, layout.center_x, zero),
                  center_y=torch.where(m, layout.center_y, zero),
                  width=torch.where(m, layout.width, zero),
                  height=torch.where(m, layout.height, zero), mask=m)


def _pairwise(layout: Layout):
    """(inter, a1, a2) of the clamped boxes, [B, S, S] (i rows, j columns)."""
    xl, _, xr, yt, _, yb = _coords(layout)
    l1, r1, t1, b1 = xl[:, :, None], xr[:, :, None], yt[:, :, None], yb[:, :, None]
    l2, r2, t2, b2 = xl[:, None, :], xr[:, None, :], yt[:, None, :], yb[:, None, :]
    a1 = (r1 - l1) * (b1 - t1)
    a2 = (r2 - l2) * (b2 - t2)
    lm, rm = torch.maximum(l1, l2), torch.minimum(r1, r2)
    tm, bm = torch.maximum(t1, t2), torch.minimum(b1, b2)
    inter = (rm - lm) * (bm - tm)
    inter = torch.where((lm < rm) & (tm < bm), inter, torch.zeros_like(inter))
    return inter, a1.expand_as(inter), a2.expand_as(inter)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def compute_overlap(layout: Layout) -> torch.Tensor:
    """overlap-LayoutGAN++ per sample [B]: the sum of pairwise
    intersection / own area over ordered pairs, divided by n."""
    layout = _clean_padding(layout)
    mask = layout.mask
    S = mask.shape[1]
    inter, a1, _ = _pairwise(layout)
    pair_ok = mask[:, :, None] & mask[:, None, :] & ~_eye(S, mask.device)[None]
    inter = torch.where(pair_ok, inter, torch.zeros_like(inter))
    return _per_element_mean(_safe_div(inter, a1).sum(dim=(1, 2)), mask)


def compute_overlay(layout: Layout, underlay_id: int) -> torch.Tensor:
    """PosterLayout overlay per sample [B]: the mean pairwise IoU over valid
    non-underlay elements; NaN with fewer than 2."""
    keep = layout.mask & (layout.label != underlay_id)
    inter, a1, a2 = _pairwise(layout)
    iou = _safe_div(inter, a1 + a2 - inter)
    S = keep.shape[1]
    pair_ok = keep[:, :, None] & keep[:, None, :] & ~_eye(S, keep.device)[None]
    n_pairs = pair_ok.sum(dim=(1, 2))
    mean_iou = torch.where(pair_ok, iou, torch.zeros_like(iou)).sum(dim=(1, 2)) / n_pairs.clamp_min(1)
    return torch.where(n_pairs > 0, mean_iou, torch.full_like(mean_iou, float("nan")))


def compute_underlay_effectiveness(layout: Layout, underlay_id: int) -> dict:
    """loose: the mean over underlays of the best intersection / area of a
    non-underlay element; strict: the mean of [an element lies fully
    inside].  NaN when the sample has no underlay or fewer than 2 elements."""
    mask = layout.mask
    S = mask.shape[1]
    is_under = mask & (layout.label == underlay_id)
    inter, _, a2 = _pairwise(layout)
    ratio = _safe_div(inter, a2)
    pair_ok = (is_under[:, :, None] & mask[:, None, :] & ~is_under[:, None, :]
               & ~_eye(S, mask.device)[None])
    best = torch.where(pair_ok, ratio, torch.full_like(ratio, float("-inf"))).amax(dim=2)
    has_pair = pair_ok.any(dim=2)
    zero = torch.zeros_like(best)
    loose_i = torch.where(has_pair, best, zero)
    strict_i = torch.where(has_pair, (best >= 1.0 - EPS_F32).to(best.dtype), zero)
    n_elem = mask.sum(dim=1)
    n_under = is_under.sum(dim=1)
    denom = n_under.clamp_min(1)
    loose = torch.where(is_under, loose_i, zero).sum(dim=1) / denom
    strict = torch.where(is_under, strict_i, zero).sum(dim=1) / denom
    valid = (n_under > 0) & (n_elem >= 2)
    nan = torch.full_like(loose, float("nan"))
    return {"underlay_effectiveness_loose": torch.where(valid, loose, nan),
            "underlay_effectiveness_strict": torch.where(valid, strict, nan)}


def compute_validity(layout: Layout, thresh: float = 1e-3) -> tuple[Layout, torch.Tensor]:
    """(filtered layout, validity ratio): elements of area <= 0.1% of the
    canvas are dropped; the ratio is kept / valid elements (1 with none)."""
    ok = layout.mask & (layout.width * layout.height > thresh)
    total = layout.mask.sum()
    ratio = torch.where(total > 0, ok.sum() / total.clamp_min(1),
                        torch.ones((), device=ok.device))
    filtered = _clean_padding(Layout(label=layout.label, center_x=layout.center_x,
                                     center_y=layout.center_y, width=layout.width,
                                     height=layout.height, mask=ok))
    return filtered, ratio.float()


def pixel_box_mask(layout: Layout, H: int, W: int, keep: torch.Tensor) -> torch.Tensor:
    """[B, H, W] union raster of the kept boxes: rounded-integer bounds,
    half-open, as `canvas[t:b, l:r] = 1`."""
    xl, _, xr, yt, _, yb = _coords(layout)
    l, r = torch.round(xl * W).long(), torch.round(xr * W).long()
    t, b = torch.round(yt * H).long(), torch.round(yb * H).long()
    ys = torch.arange(H, device=xl.device)[None, None, :, None]
    xs = torch.arange(W, device=xl.device)[None, None, None, :]
    inside = ((ys >= t[:, :, None, None]) & (ys < b[:, :, None, None])
              & (xs >= l[:, :, None, None]) & (xs < r[:, :, None, None]))
    return (inside & keep[:, :, None, None]).any(dim=1)


def sobel_gradient_map(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] RGB in [0, 1] -> [B, H, W] gradient magnitude of the
    BT.601 gray image (edge padding), divided by its per-image peak."""
    gray = (0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]) * 255.0
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32,
                      device=images.device)
    gp = F.pad(gray[:, None], (1, 1, 1, 1), mode="replicate")
    gx = F.conv2d(gp, kx[None, None])
    gy = F.conv2d(gp, kx.t().contiguous()[None, None])
    mag = torch.sqrt((gx**2 + gy**2) / 2.0)[:, 0]
    peak = mag.amax(dim=(1, 2), keepdim=True)
    return mag / peak.clamp_min(1e-8)


def compute_saliency_aware_metrics(layout: Layout, images: torch.Tensor, text_id: int,
                                   underlay_id: int) -> dict:
    """utilization, occlusion and unreadability per sample [B]; images
    [B, H, W, 4] RGB + saliency, float in [0, 1]."""
    saliency = images[..., 3]
    _, H, W = saliency.shape
    box = pixel_box_mask(layout, H, W, layout.mask)
    inv = 1.0 - saliency
    utilization = (inv * box).sum(dim=(1, 2)) / inv.sum(dim=(1, 2)).clamp_min(1e-8)
    box_area = box.sum(dim=(1, 2))
    occlusion = torch.where(box_area > 0, (saliency * box).sum(dim=(1, 2)) / box_area.clamp_min(1),
                            torch.zeros_like(utilization))
    text_mask = pixel_box_mask(layout, H, W, layout.mask & (layout.label == text_id))
    under_mask = pixel_box_mask(layout, H, W, layout.mask & (layout.label == underlay_id))
    special = text_mask & ~under_mask
    grad = sobel_gradient_map(images[..., :3])
    sp_area = special.sum(dim=(1, 2))
    unread = torch.where(sp_area > 0, (grad * special).sum(dim=(1, 2)) / sp_area.clamp_min(1),
                         torch.zeros_like(utilization))
    return {"utilization": utilization, "occlusion": occlusion, "unreadability": unread}


# ---- distribution metrics: FID + precision/recall/density/coverage (numpy) ----


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two feature sets; tr(sqrtm(sa @ sb)) as the sum of the
    square roots of the eigenvalues of sa @ sb."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    sa = np.cov(feats_a, rowvar=False)
    sb = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    eigs = np.linalg.eigvals(sa @ sb)
    eigs = np.where(np.real(eigs) > 0, eigs, 0.0)
    covmean_trace = np.sum(np.sqrt(eigs)).real
    return float(diff @ diff + np.trace(sa) + np.trace(sb) - 2.0 * covmean_trace)


def compute_prdc(real: np.ndarray, fake: np.ndarray, nearest_k: int = 5) -> dict[str, float]:
    """precision / recall / density / coverage (Naeem et al. 2020)."""

    def pairwise(a, b):
        return np.sqrt(np.maximum((a**2).sum(1)[:, None] + (b**2).sum(1)[None] - 2 * a @ b.T, 0.0))

    def kth_radius(x, k):
        return np.sort(pairwise(x, x), axis=1)[:, k]  # column 0 is the point itself

    r_real = kth_radius(real, nearest_k)
    r_fake = kth_radius(fake, nearest_k)
    d_rf = pairwise(real, fake)
    return {
        "precision": float((d_rf < r_real[:, None]).any(axis=0).mean()),
        "recall": float((d_rf < r_fake[None, :]).any(axis=1).mean()),
        "density": float((1.0 / nearest_k) * (d_rf < r_real[:, None]).sum(axis=0).mean()),
        "coverage": float((d_rf.min(axis=1) < r_real).mean()),
    }


def compute_generative_model_scores(feats_real: np.ndarray, feats_fake: np.ndarray,
                                    nearest_k: int = 5) -> dict[str, float]:
    """prdc and FID in one dict."""
    out = compute_prdc(feats_real, feats_fake, nearest_k)
    out["fid"] = frechet_distance(feats_real, feats_fake)
    return out


def nanmean(values) -> float:
    """The mean of the non-NaN values (float64); NaN when there are none."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    v = np.asarray(values, np.float64)
    v = v[~np.isnan(v)]
    return float(v.mean()) if v.size else float("nan")
