"""The retrieval augmentation that makes RA-LayoutDM of LayoutDM, the
counterpart of `ralf_tpu/models/retrieval_augment.py`:

    feats     = FIDNet(retrieved layouts), frozen                 [B, K, 256]
    ref       = PE1d(adapter(feats))                              [B, K, D]
    memory_ca = ViTCrossAttn(memory, ref)                         [B, M, D]
    memory'   = ViTFFN(concat[memory, memory_ca, ref])            [B, 2M+K, D]

The K retrieved layouts of each canvas are folded into the batch: one
FIDNet call over B*K layouts per batch (K1 with a key mask in its 4
layers), as JAX does; RALF's precomputed gallery table is not used here.
The adapter, the encoding, the cross-attention and the fusion head are
RALF's modules (`models/ralf.py`).  FIDNet stays frozen: in eval mode
whatever the module's mode, under no_grad.
"""

from __future__ import annotations

import torch
from torch import nn

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.models.fidnet import FIDNetV3
from ralf_tpu_torch.models.positional import PositionalEncoding1D
from ralf_tpu_torch.models.ralf import RETRIEVED_KEYS, ViTCrossAttention, ViTFeedForward


class RetrievalAugmentation(nn.Module):
    def __init__(self, num_labels: int, max_seq_length: int, d_model: int = 256,
                 top_k: int = 16, dropout: float = 0.1) -> None:
        super().__init__()
        self.top_k = top_k
        self.layout_encoder = FIDNetV3(num_labels, 256, 4, 4, max_bbox=max_seq_length,
                                       aux_heads=False)
        self.layout_adapter = ViTFeedForward(256, 4 * d_model, d_model)
        self.pos_emb_1d = PositionalEncoding1D(d_model, dropout)
        self.attn = ViTCrossAttention(d_model, heads=8, dim_head=64)
        self.fusion_head = ViTFeedForward(d_model, 4 * d_model, d_model)

    def train(self, mode: bool = True) -> "RetrievalAugmentation":
        super().train(mode)
        self.layout_encoder.train(False)
        return self

    def forward(self, img_feature: torch.Tensor, retrieved: dict) -> torch.Tensor:
        """img_feature [B, M, D] + retrieved {key: [B, K, S]} -> [B, 2M + K, D]."""
        B, K, S = retrieved["label"].shape
        flat = Layout(**{k: retrieved[k].reshape(B * K, S) for k in RETRIEVED_KEYS})
        with torch.no_grad():
            feats = self.layout_encoder.extract_features(flat)
        ref = self.pos_emb_1d(self.layout_adapter(feats.reshape(B, K, -1)))
        memory_ca = self.attn(img_feature, ref)
        return self.fusion_head(torch.cat([img_feature, memory_ca, ref], dim=1))
