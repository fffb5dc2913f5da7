"""FIDNetV3 layout feature extractor, the counterpart of
`ralf_tpu/models/fidnet.py`.

A permutation-invariant post-LN transformer over layout elements with a
learned CLS token; the CLS output is the 256-d feature RALF embeds each
retrieved layout with (`extract_features`).  The full forward adds the
auxiliary heads of FID training: a real/fake logit from the feature, and a
decoder transformer over the feature tiled to every element slot with a
learned position token, whose outputs give label logits and sigmoid boxes.

`aux_heads=False` leaves those heads out: RALF's frozen feature tower only
extracts features, and the JAX variables of RALF hold no heads (flax
creates a submodule's parameters only when it runs).  `pos_token` is kept
either way: the JAX module creates it in `setup`, so the variables hold it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.models.base import compute_dtype
from ralf_tpu_torch.models.nn import TransformerEncoder

BBOX_KEYS = ("center_x", "center_y", "width", "height")


class FIDNetV3(nn.Module):
    def __init__(self, num_labels: int, d_model: int = 256, nhead: int = 4,
                 num_layers: int = 4, max_bbox: int = 10, aux_heads: bool = True) -> None:
        super().__init__()
        self.emb_label = nn.Embedding(num_labels, d_model)
        self.fc_bbox = nn.Linear(4, d_model)
        self.enc_fc_in = nn.Linear(2 * d_model, d_model)
        self.cls_token = nn.Parameter(torch.randn(1, 1, d_model))
        self.enc_transformer = TransformerEncoder(
            d_model, nhead, num_layers, d_model // 2, norm_first=False)
        self.pos_token = nn.Parameter(torch.rand(max_bbox, 1, d_model))
        if aux_heads:
            self.fc_out_disc = nn.Linear(d_model, 1)
            self.dec_fc_in = nn.Linear(2 * d_model, d_model)
            self.dec_transformer = TransformerEncoder(
                d_model, nhead, num_layers, d_model // 2, norm_first=False)
            self.fc_out_cls = nn.Linear(d_model, num_labels)
            self.fc_out_bbox = nn.Linear(d_model, 4)

    def extract_features(self, layout: Layout) -> torch.Tensor:
        """Layout [B, S] -> CLS feature [B, d_model]."""
        dtype = compute_dtype(self.fc_bbox.weight)
        bbox = torch.stack([layout.geo(k) for k in BBOX_KEYS], dim=-1).to(dtype)
        h = torch.cat([self.fc_bbox(bbox), self.emb_label(layout.label)], dim=-1)
        h = F.relu(self.enc_fc_in(h))  # [B, S, D]
        B = h.shape[0]
        x = torch.cat([self.cls_token.to(h.dtype).expand(B, 1, -1), h], dim=1)
        keep = torch.cat([torch.ones_like(layout.mask[:, :1]), layout.mask], dim=1)
        return self.enc_transformer(x, keep=keep)[:, 0]

    def forward(self, layout: Layout) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full forward: (disc_logit [B], cls_logits [B, S, L], bbox [B, S, 4])."""
        B, S = layout.label.shape
        feat = self.extract_features(layout)
        logit_disc = self.fc_out_disc(feat)[:, 0]
        x = feat[:, None, :].expand(B, S, -1)
        t = self.pos_token[:S, 0][None].expand(B, -1, -1).to(x.dtype)
        x = F.relu(self.dec_fc_in(torch.cat([x, t], dim=-1)))
        x = self.dec_transformer(x, keep=layout.mask)
        return logit_disc, self.fc_out_cls(x), torch.sigmoid(self.fc_out_bbox(x))
