"""FIDNetV3 layout feature extractor, the counterpart of
`ralf_tpu/models/fidnet.py` (`extract_features` only).

A permutation-invariant post-LN transformer over layout elements with a
learned CLS token; the CLS output is the 256-d feature RALF embeds each
retrieved layout with.  `pos_token` belongs to the auxiliary reconstruction
decoder of FID training, which is not ported; it is kept so that the JAX
variables load whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.models.nn import TransformerEncoder

BBOX_KEYS = ("center_x", "center_y", "width", "height")


class FIDNetV3(nn.Module):
    def __init__(self, num_labels: int, d_model: int = 256, nhead: int = 4,
                 num_layers: int = 4, max_bbox: int = 10) -> None:
        super().__init__()
        self.emb_label = nn.Embedding(num_labels, d_model)
        self.fc_bbox = nn.Linear(4, d_model)
        self.enc_fc_in = nn.Linear(2 * d_model, d_model)
        self.cls_token = nn.Parameter(torch.randn(1, 1, d_model))
        self.enc_transformer = TransformerEncoder(
            d_model, nhead, num_layers, d_model // 2, norm_first=False)
        self.pos_token = nn.Parameter(torch.rand(max_bbox, 1, d_model))

    def extract_features(self, layout: Layout) -> torch.Tensor:
        """Layout [B, S] -> CLS feature [B, d_model]."""
        dtype = self.fc_bbox.weight.dtype
        bbox = torch.stack([layout.geo(k) for k in BBOX_KEYS], dim=-1).to(dtype)
        h = torch.cat([self.fc_bbox(bbox), self.emb_label(layout.label)], dim=-1)
        h = F.relu(self.enc_fc_in(h))  # [B, S, D]
        B = h.shape[0]
        x = torch.cat([self.cls_token.to(h.dtype).expand(B, 1, -1), h], dim=1)
        keep = torch.cat([torch.ones_like(layout.mask[:, :1]), layout.mask], dim=1)
        return self.enc_transformer(x, keep=keep)[:, 0]
