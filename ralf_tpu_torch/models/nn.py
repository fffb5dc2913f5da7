"""Transformer building blocks with KV-cached decoding, the counterpart of
`ralf_tpu/models/nn.py`.

Submodule names follow the flax parameter tree (`q_proj`, `Dense_0`,
`layer_0`, `norm1`, ...) so that `utils.weights.load_jax_params` maps the
JAX variables mechanically.  Inference only: no dropout.

Conventions: padding masks are True for VALID positions ("keep"); masks
become additive biases with the finite NEG_INF = -1e9.  Decode caches use
the [B, H, Dh, T] layout and are updated in place.

Kernels on the sample path (each wrapper runs its plain version on CPU
tensors):
  * `MultiHeadAttention.attend` -> K1 `ops.encoder_attention` for
    same-length self-attention with no bias or a key-padding bias;
  * `attend_shared` -> K2 `ops.decode_shared_attention`;
  * `attend_shared_q8` -> K3 `ops.decode_shared_attention_q8`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.models.positional import PositionalEncoding1D, sincos_1d
from ralf_tpu_torch.ops.decode_attention import (
    decode_shared_attention,
    decode_shared_attention_q8,
    quantize_shared_memory,
)
from ralf_tpu_torch.ops.encoder_attention import encoder_attention

NEG_INF = -1e9
LN_EPS = 1e-6  # flax LayerNorm's default epsilon (torch's is 1e-5)


def layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


def keep_to_bias(keep: torch.Tensor) -> torch.Tensor:
    """bool keep-mask [..., S] -> float32 additive bias (0 keep / -1e9 drop)."""
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, torch.full_like(zero, NEG_INF))


def causal_bias(S: int, device=None) -> torch.Tensor:
    i = torch.arange(S, device=device)
    return keep_to_bias(i[None, :] <= i[:, None])


def quantize_per_token(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, Dh, 1] -> (int8 [B, H, Dh, 1], fp32 scale [B, H, 1]): absmax over Dh."""
    xf = x.float()
    s = xf.abs().amax(dim=2, keepdim=True).clamp_min(1e-8) / 127.0
    xi = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xi, s[:, :, 0, :]


class MultiHeadAttention(nn.Module):
    """MHA with separable K/V projection for cache reuse."""

    def __init__(self, d_model: int, nhead: int) -> None:
        super().__init__()
        assert d_model % nhead == 0
        self.d_model, self.nhead, self.head_dim = d_model, nhead, d_model // nhead
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        return x.reshape(B, S, self.nhead, self.head_dim)

    def project_kv(self, kv_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, M, D] -> (k, v) each [B, M, H, Dh]."""
        return self._split(self.k_proj(kv_in)), self._split(self.v_proj(kv_in))

    def _query(self, q_in: torch.Tensor) -> torch.Tensor:
        return self._split(self.q_proj(q_in))[:, 0]  # [B, H, Dh]

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q_in [B, S, D], k/v [B, M, H, Dh], bias broadcastable to [B, H, S, M]."""
        B, S = q_in.shape[:2]
        M = k.shape[1]
        key_only = bias is not None and bias.dim() == 4 and bias.shape[1:3] == (1, 1)
        if S == M and (bias is None or key_only):
            key_bias = None if bias is None else bias[:, 0, 0, :].float().expand(B, M)
            out = encoder_attention(
                self.q_proj(q_in) * self.head_dim**-0.5,
                k.reshape(B, M, self.d_model), v.reshape(B, M, self.d_model),
                self.nhead, None if key_bias is None else key_bias.contiguous(),
            )
            return self.out_proj(out)
        q = self._split(self.q_proj(q_in)) * torch.tensor(self.head_dim, dtype=q_in.dtype) ** -0.5
        logits = torch.einsum("bshd,bmhd->bhsm", q, k).float()
        if bias is not None:
            logits = logits + bias.float()
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhsm,bmhd->bshd", probs, v)
        return self.out_proj(out.reshape(B, S, self.d_model))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.project_kv(kv_in)
        return self.attend(q_in, k, v, bias)

    def attend_t(self, q_in: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Single query [B, 1, D] against [B, H, Dh, T] caches -> [B, 1, D]."""
        B = q_in.shape[0]
        q = self._query(q_in) * torch.tensor(self.head_dim, dtype=q_in.dtype) ** -0.5
        logits = torch.einsum("bhd,bhdm->bhm", q.float(), k_t.float())
        if bias is not None:
            logits = logits + bias.float()
        probs = torch.softmax(logits, dim=-1).to(v_t.dtype)
        out = torch.einsum("bhm,bhdm->bhd", probs, v_t)
        return self.out_proj(out.reshape(B, 1, self.d_model))

    def _fold_query(self, q_in: torch.Tensor) -> torch.Tensor:
        """q_tilde [B, H, E] = (scale q_h) Wk_h^T: the query seen by the raw memory."""
        E = self.k_proj.weight.shape[1]
        wk = self.k_proj.weight.t().reshape(E, self.nhead, self.head_dim)
        q = self._query(q_in).float() * self.head_dim**-0.5
        # einsum may hand back a permuted view; the kernels take contiguous rows
        return torch.einsum("bhd,ehd->bhe", q, wk.float()).to(q_in.dtype).contiguous()

    def _apply_wv(self, ot: torch.Tensor) -> torch.Tensor:
        """o_tilde [B, H, E] -> out_proj((o_tilde_h Wv_h + bv_h) over heads) [B, 1, D]."""
        B, _, E = ot.shape
        wv = self.v_proj.weight.t().reshape(E, self.nhead, self.head_dim)
        bv = self.v_proj.bias.reshape(self.nhead, self.head_dim)
        out = torch.einsum("bhe,ehd->bhd", ot.to(wv.dtype), wv) + bv
        return self.out_proj(out.reshape(B, 1, self.d_model))

    def attend_shared(self, q_in: torch.Tensor, mem: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Weight-folded single-query cross-attention over the SHARED memory
        [B, M, E]: the K bias cancels in the softmax and the V bias rides
        through sum(p) = 1, so every layer reads the raw memory."""
        qt = self._fold_query(q_in)
        if bias is None:
            ot = decode_shared_attention(qt, mem.to(qt.dtype))
        else:
            scores = torch.einsum("bhe,bme->bhm", qt.float(), mem.float()) + bias.float()
            probs = torch.softmax(scores, dim=-1)
            ot = torch.einsum("bhm,bme->bhe", probs, mem.float()).to(qt.dtype)
        return self._apply_wv(ot)

    def attend_shared_q8(self, q_in: torch.Tensor, mem_i8: torch.Tensor,
                         mem_scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """attend_shared over int8 memory with per-token fp32 scales [B, M]."""
        qt = self._fold_query(q_in)
        if bias is None:
            ot = decode_shared_attention_q8(qt, mem_i8, mem_scale)
        else:
            memf = mem_i8.float() * mem_scale[:, :, None]
            scores = torch.einsum("bhe,bme->bhm", qt.float(), memf) + bias.float()
            ot = torch.einsum("bhm,bme->bhe", torch.softmax(scores, -1), memf).to(qt.dtype)
        return self._apply_wv(ot)

    def attend_t_q8tok(self, q_in: torch.Tensor, k_i8: torch.Tensor, v_i8: torch.Tensor,
                       ks: torch.Tensor, vs: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Single query over per-token int8 caches [B, H, Dh, T] with fp32
        scales [B, H, T]: logits = (q . k_i8) * ks, out = (p * vs) . v_i8."""
        B = q_in.shape[0]
        dt = q_in.dtype
        q = (self._query(q_in).float() * self.head_dim**-0.5).to(dt)
        logits = torch.einsum("bhd,bhdm->bhm", q.float(), k_i8.to(dt).float()) * ks
        if bias is not None:
            logits = logits + bias.float()
        probs = (torch.softmax(logits, dim=-1) * vs).to(dt)
        out = torch.einsum("bhm,bhdm->bhd", probs.float(), v_i8.to(dt).float()).to(dt)
        return self.out_proj(out.reshape(B, 1, self.d_model))

    def attend_t_any(self, q_in: torch.Tensor, cross,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-attention over the shared memory tensor or the int8
        (mem_i8 [B, M, E], scale [B, M]) pair."""
        if isinstance(cross, torch.Tensor):
            return self.attend_shared(q_in, cross, bias)
        return self.attend_shared_q8(q_in, cross[0], cross[1], bias)


class FeedForward(nn.Module):
    """Linear -> ReLU -> Linear."""

    def __init__(self, d_model: int, dim_feedforward: int) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(d_model, dim_feedforward)
        self.Dense_1 = nn.Linear(dim_feedforward, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))


class TransformerEncoderLayer(nn.Module):
    """Pre-LN (norm_first, the model zoo default) or post-LN (FIDNet) layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 norm_first: bool = True) -> None:
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FeedForward(d_model, dim_feedforward)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm_first = norm_first

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_first:
            h = self.norm1(x)
            x = x + self.self_attn(h, h, bias)
            return x + self.ffn(self.norm2(x))
        x = self.norm1(x + self.self_attn(x, x, bias))
        return self.norm2(x + self.ffn(x))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers `layer_i`; the keep-mask becomes a key bias."""

    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int,
                 norm_first: bool = True) -> None:
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, norm_first))

    def layers(self) -> list[nn.Module]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        bias = None if keep is None else keep_to_bias(keep)[:, None, None, :]
        for layer in self.layers():
            x = layer(x, bias)
        return x


class TransformerDecoderLayer(nn.Module):
    """Pre-LN decoder layer with a full forward and single-step cached paths."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int) -> None:
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.cross_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FeedForward(d_model, dim_feedforward)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_bias: Optional[torch.Tensor] = None,
                mem_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, self_bias)
        x = x + self.cross_attn(self.norm2(x), memory, mem_bias)
        return x + self.ffn(self.norm3(x))

    def _new_kv(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        k, v = self.self_attn.project_kv(h)  # [B, 1, H, Dh]
        return k.permute(0, 2, 3, 1), v.permute(0, 2, 3, 1)  # [B, H, Dh, 1]

    def _finish_step(self, x_t: torch.Tensor, cross,
                     mem_bias: Optional[torch.Tensor]) -> torch.Tensor:
        x_t = x_t + self.cross_attn.attend_t_any(self.norm2(x_t), cross, mem_bias)
        return x_t + self.ffn(self.norm3(x_t))

    def step(self, x_t: torch.Tensor, t: int, cache_k: torch.Tensor, cache_v: torch.Tensor,
             self_bias_t: torch.Tensor, cross, mem_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """One decode step; writes position t of the [B, H, Dh, T] caches in place."""
        h = self.norm1(x_t)
        k_t, v_t = self._new_kv(h)
        cache_k[..., t : t + 1] = k_t.to(cache_k.dtype)
        cache_v[..., t : t + 1] = v_t.to(cache_v.dtype)
        x_t = x_t + self.self_attn.attend_t(h, cache_k, cache_v, self_bias_t)
        return self._finish_step(x_t, cross, mem_bias)

    def step_q8(self, x_t: torch.Tensor, t: int, cache_k: torch.Tensor, cache_v: torch.Tensor,
                cache_ks: torch.Tensor, cache_vs: torch.Tensor, self_bias_t: torch.Tensor,
                cross, mem_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """`step` over int8 per-token self caches: the new token's K/V are
        absmax-quantized over Dh as they are written."""
        h = self.norm1(x_t)
        k_t, v_t = self._new_kv(h)
        ki, kscale = quantize_per_token(k_t)
        vi, vscale = quantize_per_token(v_t)
        cache_k[..., t : t + 1] = ki
        cache_v[..., t : t + 1] = vi
        cache_ks[..., t : t + 1] = kscale
        cache_vs[..., t : t + 1] = vscale
        x_t = x_t + self.self_attn.attend_t_q8tok(h, cache_k, cache_v, cache_ks, cache_vs,
                                                  self_bias_t)
        return self._finish_step(x_t, cross, mem_bias)


class TransformerDecoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int) -> None:
        super().__init__()
        self.d_model, self.nhead, self.num_layers = d_model, nhead, num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(d_model, nhead, dim_feedforward))

    def layers(self) -> list[nn.Module]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                tgt_keep: Optional[torch.Tensor] = None,
                mem_keep: Optional[torch.Tensor] = None, causal: bool = True) -> torch.Tensor:
        S = x.shape[1]
        self_bias = torch.zeros((1, 1, S, S), device=x.device)
        if causal:
            self_bias = self_bias + causal_bias(S, x.device)[None, None]
        if tgt_keep is not None:
            self_bias = self_bias + keep_to_bias(tgt_keep)[:, None, None, :]
        mem_bias = None if mem_keep is None else keep_to_bias(mem_keep)[:, None, None, :]
        for layer in self.layers():
            x = layer(x, memory, self_bias, mem_bias)
        return x

    def init_cache(self, batch: int, max_len: int, self_quant: bool = False,
                   dtype: torch.dtype = torch.float32, device=None) -> dict:
        """Zeroed per-layer caches [B, H, Dh, T]; with self_quant int8 plus
        per-token fp32 scales [B, H, T]."""
        shape = (batch, self.nhead, self.d_model // self.nhead, max_len)
        dt = torch.int8 if self_quant else dtype
        n = self.num_layers
        cache = {
            "k": [torch.zeros(shape, dtype=dt, device=device) for _ in range(n)],
            "v": [torch.zeros(shape, dtype=dt, device=device) for _ in range(n)],
        }
        if self_quant:
            sshape = (batch, self.nhead, max_len)
            cache["ks"] = [torch.zeros(sshape, device=device) for _ in range(n)]
            cache["vs"] = [torch.zeros(sshape, device=device) for _ in range(n)]
        return cache

    def cross_kv(self, memory: torch.Tensor, kv_quant: bool = False, dtype=None):
        """The decode's cross-attention operand, shared by every layer: the
        raw memory, or with kv_quant one int8 copy with per-token scales."""
        if kv_quant:
            return quantize_shared_memory(memory)
        return memory if dtype is None else memory.to(dtype)

    def step(self, x_t: torch.Tensor, t: int, cache: dict, cross,
             self_keep: torch.Tensor, mem_keep: Optional[torch.Tensor]) -> torch.Tensor:
        self_bias = keep_to_bias(self_keep)[:, None, :]  # [B, 1, T]
        mem_bias = None if mem_keep is None else keep_to_bias(mem_keep)[:, None, :]
        for i, layer in enumerate(self.layers()):
            if "ks" in cache:  # int8 per-token self caches (self_quant)
                x_t = layer.step_q8(x_t, t, cache["k"][i], cache["v"][i], cache["ks"][i],
                                    cache["vs"][i], self_bias, cross, mem_bias)
            else:
                x_t = layer.step(x_t, t, cache["k"][i], cache["v"][i], self_bias, cross,
                                 mem_bias)
        return x_t


class TokenDecoder(nn.Module):
    """Embedding + 1-d PE + decoder stack + (LayerNorm, bias-free Linear) head."""

    def __init__(self, vocab_size: int, d_model: int = 256, nhead: int = 8,
                 num_layers: int = 6, dim_feedforward: int = 1024) -> None:
        super().__init__()
        self.d_model = d_model
        self.emb = nn.Embedding(vocab_size, d_model)
        self.pos_emb = PositionalEncoding1D(d_model)
        self.stack = TransformerDecoder(d_model, nhead, num_layers, dim_feedforward)
        self.head_norm = layer_norm(d_model)
        self.head_out = nn.Linear(d_model, vocab_size, bias=False)
        self.register_buffer("step_pe", torch.from_numpy(sincos_1d(4096, d_model)),
                             persistent=False)

    def forward(self, seq: torch.Tensor, memory: torch.Tensor,
                tgt_keep: Optional[torch.Tensor] = None,
                mem_keep: Optional[torch.Tensor] = None, causal: bool = True) -> torch.Tensor:
        h = self.pos_emb(self.emb(seq))
        return self.head(self.stack(h, memory, tgt_keep, mem_keep, causal))

    def embed_step(self, tok: torch.Tensor, t: int) -> torch.Tensor:
        """tok [B], step t -> [B, 1, D] PE'd embedding."""
        h = self.emb(tok)[:, None, :]
        h = h * torch.tensor(self.d_model, dtype=h.dtype).sqrt()
        return h + self.step_pe[t : t + 1].to(h.dtype)[None]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.head_out(self.head_norm(x))
