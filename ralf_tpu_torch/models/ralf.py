"""RALF, the retrieval-augmented layout transformer: the counterpart of
`ralf_tpu/models/ralf.py` for the final architecture (`concat_crossattn`):

    memory    = ImageEncoder(image + saliency)                  [B, M, D]
    ref       = PE1d(adapter(FIDNet features of the top-k))     [B, K, D]
    memory_ca = ViTCrossAttn(memory, ref)                       [B, M, D]
    fused     = ViTFFN(concat[memory, memory_ca, ref])          [B, 2M+K, D]
    memory'   = concat[fused + flag_0, ConstEnc(c) + flag_1]
    logits    = TokenDecoder(tokens | memory', causal)

The frozen FIDNet features of the gallery are computed once
(`RALFGenerator.precompute_retrieved_feats`) and gathered per batch.  The
other six fusion ablations of the JAX package are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.core.conditioning import Condition
from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer
from ralf_tpu_torch.models.autoreg import AutoregGenerator, ConstraintEncoder
from ralf_tpu_torch.models.base import GeneratorConfig
from ralf_tpu_torch.models.fidnet import FIDNetV3
from ralf_tpu_torch.models.nn import TokenDecoder, layer_norm
from ralf_tpu_torch.models.positional import PositionalEncoding1D
from ralf_tpu_torch.models.resnet import ImageEncoder

RETRIEVED_KEYS = ("label", "center_x", "center_y", "width", "height", "mask")


class ViTFeedForward(nn.Module):
    """LayerNorm -> Linear -> GELU (tanh) -> Linear."""

    def __init__(self, dim: int, hidden_dim: int, output_dim: int) -> None:
        super().__init__()
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_0(x)), approximate="tanh"))


class ViTCrossAttention(nn.Module):
    """Pre-LN cross-attention with bias-free q/kv projections; q = image
    memory, kv = retrieved layout features."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64) -> None:
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.LayerNorm_0 = layer_norm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        M = context.shape[1]
        q = self.to_q(self.LayerNorm_0(x)).reshape(B, N, self.heads, self.dim_head)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        k = k.reshape(B, M, self.heads, self.dim_head)
        v = v.reshape(B, M, self.heads, self.dim_head)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * self.dim_head**-0.5
        attn = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, -1)
        return self.to_out(out)


class RALFCore(nn.Module):
    def __init__(self, vocab_size: int, const_vocab_size: int, num_labels: int,
                 max_seq_length: int, cfg: GeneratorConfig = GeneratorConfig(),
                 fusion: str = "concat_crossattn") -> None:
        super().__init__()
        if fusion != "concat_crossattn":
            raise NotImplementedError(f"fusion {fusion!r}: only 'concat_crossattn' is ported")
        d = cfg.d_model
        self.encoder = ImageEncoder(cfg.backbone, d, cfg.nhead, cfg.num_encoder_layers,
                                    cfg.dim_feedforward)
        self.layout_encoder = FIDNetV3(num_labels, 256, 4, 4, max_bbox=max_seq_length)
        self.layout_adapter = ViTFeedForward(256, 4 * d, d)
        self.pos_emb_1d = PositionalEncoding1D(d)
        self.attn = ViTCrossAttention(d, heads=8, dim_head=64)
        self.fusion_head = ViTFeedForward(d, 4 * d, d)
        self.const_encoder = ConstraintEncoder(const_vocab_size, d, cfg.nhead,
                                               cfg.num_encoder_layers, cfg.dim_feedforward)
        self.flag_emb = nn.Parameter(torch.randn(2, 1) * 0.02)
        self.decoder = TokenDecoder(vocab_size, d, cfg.nhead, cfg.num_decoder_layers,
                                    cfg.dim_feedforward)

    def encode_retrieved(self, retrieved: dict) -> torch.Tensor:
        """{'feats': [B, K, 256]} (or the layouts {'label': [B, K, S], ...})
        -> ref sequence [B, K, D]."""
        if retrieved.get("feats") is not None:
            feats = retrieved["feats"].to(self.flag_emb.dtype)
            B, K = feats.shape[:2]
        else:
            B, K, S = retrieved["label"].shape
            flat = Layout(**{k: retrieved[k].reshape(B * K, S) for k in RETRIEVED_KEYS})
            feats = self.layout_encoder.extract_features(flat)
        return self.pos_emb_1d(self.layout_adapter(feats.reshape(B, K, -1)))

    def encode_memory(self, image: torch.Tensor, retrieved: dict, const_seq: torch.Tensor,
                      const_keep: torch.Tensor) -> torch.Tensor:
        ref = self.encode_retrieved(retrieved)
        memory = self.encoder(image)
        memory_ca = self.attn(memory, ref)
        fused = self.fusion_head(torch.cat([memory, memory_ca, ref], dim=1))  # [B, 2M+K, D]
        const = self.const_encoder(const_seq, const_keep)
        flag = self.flag_emb.to(fused.dtype)
        return torch.cat([fused + flag[0], const + flag[1]], dim=1)


class RALFGenerator(AutoregGenerator):
    """Generator wrapper for RALF: the autoreg conditioning and decode, plus
    the retrieval arrays of every batch (retrieval/wrapper.py)."""

    def __init__(self, tokenizer: LayoutSequenceTokenizer,
                 cfg: GeneratorConfig = GeneratorConfig(),
                 auxiliary_task: Optional[str] = "uncond",
                 image_hw: tuple[int, int] = (350, 240), top_k: int = 16,
                 fusion: str = "concat_crossattn", *, device="cuda", seed: int = 0) -> None:
        self.top_k = top_k
        self.fusion = fusion
        super().__init__(tokenizer, cfg, auxiliary_task, image_hw, device=device, seed=seed)

    def _build_core(self) -> RALFCore:
        return RALFCore(
            vocab_size=self.tokenizer.N_total,
            const_vocab_size=self.vocab.N_total,
            num_labels=self.tokenizer.N_label,
            max_seq_length=self.tokenizer.max_seq_length,
            cfg=self.cfg,
            fusion=self.fusion,
        )

    def _retrieved_arrays(self, retrieved: dict) -> dict:
        """Host retrieval arrays -> tensors on the generator's device."""
        dtypes = {"label": torch.int64, "mask": torch.bool}
        out = {
            k: torch.as_tensor(np.asarray(retrieved[k]), device=self.device).to(
                dtypes.get(k, torch.float32))
            for k in RETRIEVED_KEYS
        }
        if retrieved.get("feats") is not None:
            out["feats"] = torch.as_tensor(np.asarray(retrieved["feats"], np.float32),
                                           device=self.device)
        return out

    @torch.inference_mode()
    def precompute_retrieved_feats(self, gallery_layouts: dict, chunk: int = 4096) -> np.ndarray:
        """FIDNet CLS features [G, 256] (float32) of every gallery layout, once:
        the tower is frozen and the gallery fixed, so each batch gathers rows
        of this table instead of running B*K FIDNet forwards."""
        G = np.asarray(gallery_layouts["label"]).shape[0]
        out = []
        for s in range(0, G, chunk):
            part = {k: np.asarray(gallery_layouts[k])[s : s + chunk] for k in RETRIEVED_KEYS}
            layout = Layout.fromdict(part, device=self.device)
            out.append(self.core.layout_encoder.extract_features(layout).float().cpu().numpy())
        return np.concatenate(out, axis=0)

    @torch.inference_mode()
    def encode_memory(self, cond: Condition) -> torch.Tensor:
        image = cond.image
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image))
        return self.core.encode_memory(
            image.to(self.device),
            self._retrieved_arrays(cond.retrieved),
            torch.as_tensor(cond.const_seq, device=self.device).long(),
            torch.as_tensor(cond.const_mask, device=self.device),
        )
