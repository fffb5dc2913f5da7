"""Positional encodings, the counterpart of `ralf_tpu/models/positional.py`:
the 1-d interleaved sine table and the normalized 2-d sine table (numpy,
fp32), the modules that add them, and the diffusion decoders' learned
element/attribute encoding."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.models.dropout import Dropout


def sincos_1d(max_len: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table, [max_len, d_model] float32."""
    position = np.arange(max_len)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


def sine_2d_table(h: int, w: int, d_model: int, temperature: float = 10000.0) -> np.ndarray:
    """DETR-style 2-d sine table with y/x normalized to [0, 2pi], [h*w, d_model]."""
    half = d_model // 2
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ys = ys / max(h - 1, 1) * 2 * np.pi
    xs = xs / max(w - 1, 1) * 2 * np.pi
    dim_t = temperature ** (2 * (np.arange(half) // 2) / half)
    px = xs.reshape(-1)[:, None] / dim_t
    py = ys.reshape(-1)[:, None] / dim_t

    def interleave(p):
        out = np.empty_like(p)
        out[:, 0::2] = np.sin(p[:, 0::2])
        out[:, 1::2] = np.cos(p[:, 1::2])
        return out

    return np.concatenate([interleave(py), interleave(px)], axis=1).astype(np.float32)


class PositionalEncoding1D(nn.Module):
    """Dropout(x * sqrt(d) + sine PE)."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000) -> None:
        super().__init__()
        self.d_model = d_model
        self.register_buffer("pe", torch.from_numpy(sincos_1d(max_len, d_model)),
                             persistent=False)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x * torch.tensor(self.d_model, dtype=x.dtype).sqrt()
        return self.drop(h + self.pe[: x.shape[-2]].to(x.dtype))


class ElemAttrPositionalEncoding1D(nn.Module):
    """Dropout(x * sqrt(d) + concat[attribute embedding, element embedding]):
    position i of the token sequence is attribute i % n_attr of element
    i // n_attr, each half learned (flax's `Embed_0`, `Embed_1`)."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000,
                 n_attr_per_elem: int = 5) -> None:
        super().__init__()
        self.d_model, self.n_attr = d_model, n_attr_per_elem
        self.Embed_0 = nn.Embedding(n_attr_per_elem, d_model // 2)
        self.Embed_1 = nn.Embedding(max_len // n_attr_per_elem, d_model // 2)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        S = x.shape[1]
        if S % self.n_attr:
            raise ValueError(f"sequence length {S} is not a multiple of {self.n_attr}")
        h = x * torch.tensor(self.d_model, dtype=x.dtype).sqrt()
        idx = torch.arange(S, device=x.device)
        pe = torch.cat([self.Embed_0(idx % self.n_attr), self.Embed_1(idx // self.n_attr)], -1)
        return self.drop(h + pe[None].to(h.dtype))


class PositionEmbeddingSine2D(nn.Module):
    """[B, H, W, C] feature map -> [B, H*W, C] sequence + 2-d sine PE."""

    def __init__(self, d_model: int) -> None:
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        assert C == self.d_model
        pos = torch.from_numpy(sine_2d_table(H, W, C)).to(device=x.device, dtype=x.dtype)
        return x.reshape(B, H * W, C) + pos[None]
