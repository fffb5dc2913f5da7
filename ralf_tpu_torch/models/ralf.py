"""RALF, the retrieval-augmented layout transformer: the counterpart of
`ralf_tpu/models/ralf.py`.  The final architecture (`concat_crossattn`):

    memory    = ImageEncoder(image + saliency)                  [B, M, D]
    ref       = PE1d(adapter(FIDNet features of the top-k))     [B, K, D]
    memory_ca = ViTCrossAttn(memory, ref)                       [B, M, D]
    fused     = ViTFFN(concat[memory, memory_ca, ref])          [B, 2M+K, D]
    memory'   = concat[fused + flag_0, ConstEnc(c) + flag_1]
    logits    = TokenDecoder(tokens | memory', causal)

and JAX's six other fusion ablations (`RALFCore.FUSIONS`), which replace
the `fused` line:

    flag_concat_crossattn  memory + e_0 and ref + e_1 (a learned scalar per
                           modality, `modality_emb` [2, 1]), then as above
    crossattn              ViTFFN(concat[memory, memory_ca])       [B, 2M, D]
    concat                 ViTFFN(concat[memory, ref])             [B, M+K, D]
    adapter                concat[memory, ref]                     [B, M+K, D]
    pre_encoder            f = features(image); the image encoder's
                           transformer over concat[f, CA(f, ref), ref]  [B, 2M+K, D]
    post_encoder           a second transformer (`modality_encoder`,
                           dropout 0.1 whatever cfg.dropout is: ROADMAP.md
                           Queue C 75) over
                           concat[memory, ref]                     [B, M+K, D]

A mode builds only the submodules it calls, as flax creates only the
parameters a mode's init reaches (`adapter` has neither `attn` nor
`fusion_head`), so JAX's tree of each mode loads whole.  No preset and no
CLI flag sets a mode: `RALFGenerator(..., fusion=...)` does.

The frozen FIDNet features of the gallery are computed once
(`RALFGenerator.precompute_retrieved_feats`) and gathered per batch, or,
as in training, FIDNet runs on the B*K retrieved layouts.  The tower stays
frozen: `RALFCore.train()` leaves it in eval mode (JAX runs it
deterministic inside the loss, so K1 stays on and its dropout off), and
it runs under torch.no_grad(), the port's stop_gradient.  The ViT blocks'
dropout rate is 0.0 in JAX, so they carry none.
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
from ralf_tpu_torch.models.base import GeneratorConfig, compute_dtype
from ralf_tpu_torch.models.fidnet import FIDNetV3
from ralf_tpu_torch.models.nn import TokenDecoder, TransformerEncoder, layer_norm
from ralf_tpu_torch.models.positional import PositionalEncoding1D
from ralf_tpu_torch.models.resnet import ImageEncoder
from ralf_tpu_torch.utils import tracing

RETRIEVED_KEYS = ("label", "center_x", "center_y", "width", "height", "mask")


def retrieved_tensors(retrieved: dict, device) -> dict:
    """Host retrieval arrays {key: [B, K, S]} -> tensors on `device` (label
    int64, mask bool, geometry fp32), with the features [B, K, 256] when given
    (traced: their host bytes counted, `utils.tracing.count_h2d`)."""
    dtypes = {"label": torch.int64, "mask": torch.bool}
    host = {k: np.asarray(retrieved[k]) for k in RETRIEVED_KEYS}
    if retrieved.get("feats") is not None:
        host["feats"] = np.asarray(retrieved["feats"], np.float32)
    for v in host.values():
        tracing.count_h2d(v)
    return {k: torch.as_tensor(v, device=device).to(dtypes.get(k, torch.float32))
            for k, v in host.items()}


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
    FUSIONS = ("concat_crossattn", "flag_concat_crossattn", "crossattn", "concat", "adapter",
               "pre_encoder", "post_encoder")
    _CROSS_ATTENTION = ("concat_crossattn", "flag_concat_crossattn", "crossattn", "pre_encoder")
    _FUSION_HEAD = ("concat_crossattn", "flag_concat_crossattn", "crossattn", "concat")
    MODALITY_DROPOUT = 0.1  # post_encoder's modality encoder, fixed in JAX (`ralf.py:172-177`)

    def __init__(self, vocab_size: int, const_vocab_size: int, num_labels: int,
                 max_seq_length: int, cfg: GeneratorConfig = GeneratorConfig(),
                 fusion: str = "concat_crossattn") -> None:
        super().__init__()
        if fusion not in self.FUSIONS:
            raise ValueError(f"unknown RALF fusion {fusion!r}; choose from {self.FUSIONS}")
        self.fusion = fusion
        d = cfg.d_model
        self.encoder = ImageEncoder(cfg.backbone, d, cfg.nhead, cfg.num_encoder_layers,
                                    cfg.dim_feedforward, cfg.dropout)
        self.layout_encoder = FIDNetV3(num_labels, 256, 4, 4, max_bbox=max_seq_length,
                                       aux_heads=False)
        self.layout_adapter = ViTFeedForward(256, 4 * d, d)
        self.pos_emb_1d = PositionalEncoding1D(d, cfg.dropout)
        if fusion in self._CROSS_ATTENTION:
            self.attn = ViTCrossAttention(d, heads=8, dim_head=64)
        if fusion in self._FUSION_HEAD:
            self.fusion_head = ViTFeedForward(d, 4 * d, d)
        if fusion == "flag_concat_crossattn":
            self.modality_emb = nn.Parameter(torch.randn(2, 1) * 0.02)
        if fusion == "post_encoder":
            self.modality_encoder = TransformerEncoder(d, cfg.nhead, cfg.num_encoder_layers,
                                                       cfg.dim_feedforward,
                                                       dropout=self.MODALITY_DROPOUT)
        self.const_encoder = ConstraintEncoder(const_vocab_size, d, cfg.nhead,
                                               cfg.num_encoder_layers, cfg.dim_feedforward,
                                               cfg.dropout)
        self.flag_emb = nn.Parameter(torch.randn(2, 1) * 0.02)
        self.decoder = TokenDecoder(vocab_size, d, cfg.nhead, cfg.num_decoder_layers,
                                    cfg.dim_feedforward, cfg.dropout)

    def train(self, mode: bool = True) -> "RALFCore":
        super().train(mode)
        self.layout_encoder.train(False)  # the frozen tower runs deterministic, as in JAX
        return self

    def encode_retrieved(self, retrieved: dict) -> torch.Tensor:
        """{'feats': [B, K, 256]} (or the layouts {'label': [B, K, S], ...})
        -> ref sequence [B, K, D]."""
        if retrieved.get("feats") is not None:
            feats = retrieved["feats"].to(compute_dtype(self.flag_emb))
            B, K = feats.shape[:2]
        else:
            B, K, S = retrieved["label"].shape
            flat = Layout(**{k: retrieved[k].reshape(B * K, S) for k in RETRIEVED_KEYS})
            with torch.no_grad():  # frozen: JAX's stop_gradient
                feats = self.layout_encoder.extract_features(flat)
        return self.pos_emb_1d(self.layout_adapter(feats.reshape(B, K, -1)))

    def fuse(self, image: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """The image memory fused with the retrieved sequence ref [B, K, D]
        by `self.fusion` (see the module docstring)."""
        f = self.fusion
        if f == "pre_encoder":
            feat = self.encoder.features(image)
            return self.encoder.encode_seq(torch.cat([feat, self.attn(feat, ref), ref], dim=1))
        memory = self.encoder(image)
        if f == "post_encoder":
            return self.modality_encoder(torch.cat([memory, ref], dim=1))
        if f == "adapter":
            return torch.cat([memory, ref], dim=1)
        if f == "concat":
            return self.fusion_head(torch.cat([memory, ref], dim=1))
        if f == "flag_concat_crossattn":
            emb = self.modality_emb.to(memory.dtype)
            memory, ref = memory + emb[0], ref + emb[1]
        memory_ca = self.attn(memory, ref)
        if f == "crossattn":
            return self.fusion_head(torch.cat([memory, memory_ca], dim=1))
        return self.fusion_head(torch.cat([memory, memory_ca, ref], dim=1))  # [B, 2M+K, D]

    def encode_memory(self, image: torch.Tensor, retrieved: dict, const_seq: torch.Tensor,
                      const_keep: torch.Tensor) -> torch.Tensor:
        fused = self.fuse(image, self.encode_retrieved(retrieved))
        const = self.const_encoder(const_seq, const_keep)
        flag = self.flag_emb.to(fused.dtype)
        return torch.cat([fused + flag[0], const + flag[1]], dim=1)

    def forward(self, seq: torch.Tensor, image: torch.Tensor, retrieved: dict,
                const_seq: torch.Tensor, const_keep: torch.Tensor,
                tgt_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced logits [B, S, V] of the causal decoder."""
        memory = self.encode_memory(image, retrieved, const_seq, const_keep)
        return self.decoder(seq, memory, tgt_keep=tgt_keep, causal=True)


class RALFGenerator(AutoregGenerator):
    """Generator wrapper for RALF: the autoreg conditioning, decode and
    sample under every task, plus the retrieval arrays of every batch
    (retrieval/wrapper.py)."""

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

    def preprocess(self, batch: dict, rng: np.random.Generator) -> tuple[dict, dict]:
        if "retrieved" not in batch:
            raise ValueError("RALF needs retrieval-augmented batches (retrieval.wrapper)")
        inputs, targets = super().preprocess(batch, rng)
        inputs["retrieved"] = retrieved_tensors(batch["retrieved"], self.device)
        return inputs, targets

    def logits(self, inputs: dict) -> torch.Tensor:
        return self.core(inputs["seq"], inputs["image"], inputs["retrieved"],
                         inputs["const_seq"], inputs["const_keep"], inputs["tgt_keep"])

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
        """[B, 2M + K + Lc, D] in the final architecture (the fusion sets the
        first part); Lc, the constraint length, depends on the task."""
        with tracing.span("gen.encode", device=self.device.type == "cuda"):
            return self.core.encode_memory(self._image(cond),
                                           retrieved_tensors(cond.retrieved, self.device),
                                           *self._constraint(cond))
