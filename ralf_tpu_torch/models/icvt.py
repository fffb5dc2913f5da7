"""ICVT, the geometry-aligned conditional VAE transformer baseline: the
counterpart of `ralf_tpu/models/icvt.py` for sampling.

    memory = ImageEncoder(image + saliency, cgl FPN)             [B, M, d]
    ga_k   = GeoDictEncoder(the stride-16 grid as a pseudo-layout) [B, M, d]
    z ~ N(0, I)                                                   [B, 1, d]
    for i < S:  out = LayoutDictDecoder(GADecoder(PE([z, e_0..e_{i-1}]) | memory,
                                                 GA query = the pre-PE target, ga_k))
                token i = argmax of each attribute's logits at position i
                e_i = LayoutDictEncoder(token i)

A layout is five tokens an element (label, with a BG class for padding,
and the four geometry buckets of 128), each attribute embedded in d/5 and
the grid's geometry in d/4 (d = 200 in the preset).  The target stays
padded to [B, 1+S, d] with a causal mask, so every step runs one fixed
shape, as in JAX.

Geometry-aligned cross-attention (`ga_type` "concat", the preset's):
query [h, ga_q] and key [memory, ga_k] of width 2d, value [memory, 0];
`cross_out` maps the concatenated head outputs back to d, standing in for
the reference's truncated out_proj, so the cross-attention has no out_proj
of its own (nor has the flax tree).  Its heads are 2d/8 = 50 wide and it
attends over unequal lengths: the einsum path.  "add" and None are the
other GA types, as in JAX.  K1 serves the image encoder's self-attention:
6 launches a request at the preset's head width d/8 = 25 (padded to 32).

The latent: JAX draws a key from the caller's numpy rng,
`int(rng.integers(2**31))`; the port draws the same integer (the numpy
stream stays in step for later batches) and seeds a `torch.Generator` on
the device with it, so z is not JAX's (torch cannot reproduce
`jax.random`): parity passes JAX's z in.

Training is the cVAE's (`preprocess`, `loss`): the GA encoder
(`vae_encoder`, K1 for its self-attention in eval mode, over the GT
layout's embedding with its key mask) pooled by the learnable token gives
(mu, logvar), z = mu + eps exp(logvar / 2), and the decoder, teacher-forced
on [z, e_0, ..., e_{S-2}] with the PE'd target as its GA query, is scored by
each attribute's cross-entropy plus kl_mult * kl_beta * KL.  eps comes from
`seeded_normal`, a generator seeded with the numpy rng's next integer (JAX
seeds `jax.random` with it: parity passes JAX's eps in).  kl_beta stays at
1e-3 under the trainer, which calls no `update_per_epoch`, as in JAX.  The
GT-layout embedding is named `layout_encoder`, which JAX's optimizer freezes
by name (`train.optim`): the port follows.  `sample(...,
ref_duplicated_prefix=True)`, the reference's quadratic prefix loop that
only JAX's torch-reference test calls, is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.core.bucketizer import linear_bucketizer
from ralf_tpu_torch.core.layout import GEO_KEYS, Layout
from ralf_tpu_torch.models.base import GeneratorConfig, build_core, device_image
from ralf_tpu_torch.models.dropout import Dropout
from ralf_tpu_torch.models.nn import (
    FeedForward,
    MultiHeadAttention,
    causal_bias,
    keep_to_bias,
    layer_norm,
)
from ralf_tpu_torch.models.positional import PositionalEncoding1D
from ralf_tpu_torch.models.resnet import ImageEncoder
from ralf_tpu_torch.parallel import rows
from ralf_tpu_torch.utils.device import resolve_device

ATTRS = ("label", *GEO_KEYS)


def seeded_normal(shape: tuple, seed: int, device) -> torch.Tensor:
    """N(0, I) draws (the latent z of sampling, the posterior's eps in
    training) from a generator on `device` seeded by `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return rows.draw(lambda s: torch.randn(s, generator=g, device=device), shape)


class ICVTTokenizer:
    """Per-attribute linear bucketizer; the label's BG class marks padding."""

    def __init__(self, num_labels: int, n_boundaries: int = 128) -> None:
        self.num_labels = num_labels
        self.bg_idx = num_labels
        self.n_boundaries = n_boundaries
        self._b = {k: linear_bucketizer(n_boundaries) for k in GEO_KEYS}

    def encode(self, layout: Layout) -> dict:
        out = {"mask": layout.mask}
        for k in GEO_KEYS:
            ids = self._b[k].encode(layout.geo(k))
            out[k] = torch.where(layout.mask, ids, torch.zeros_like(ids))
        out["label"] = torch.where(layout.mask, layout.label,
                                   torch.full_like(layout.label, self.bg_idx))
        return out

    def decode(self, ids: dict) -> Layout:
        mask = ids["label"] != self.bg_idx
        geo = {k: torch.where(mask, self._b[k].decode(ids[k]), 0.0) for k in GEO_KEYS}
        label = torch.where(mask, ids["label"], torch.zeros_like(ids["label"]))
        return Layout(label=label, mask=mask, **geo)


class LayoutDictEncoder(nn.Module):
    """Each attribute's embedding (d/5 wide), concatenated: [B, S, d]."""

    def __init__(self, d_attr: int, num_classes_w_bg: int, n_boundaries: int) -> None:
        super().__init__()
        self.embed_label = nn.Embedding(num_classes_w_bg, d_attr)
        for k in GEO_KEYS:
            self.add_module(f"embed_{k}", nn.Embedding(n_boundaries, d_attr))

    def forward(self, ids: dict) -> torch.Tensor:
        return torch.cat([getattr(self, f"embed_{k}")(ids[k]) for k in ATTRS], dim=-1)


class GeoDictEncoder(nn.Module):
    """The geometry-only embedding (d/4 an attribute) of the GA key grid."""

    def __init__(self, d_attr: int, n_boundaries: int) -> None:
        super().__init__()
        for k in GEO_KEYS:
            self.add_module(f"embed_{k}", nn.Embedding(n_boundaries, d_attr))

    def forward(self, ids: dict) -> torch.Tensor:
        return torch.cat([getattr(self, f"embed_{k}")(ids[k]) for k in GEO_KEYS], dim=-1)


class LayoutDictDecoder(nn.Module):
    """Per-attribute classification heads: {attribute: logits}."""

    def __init__(self, d_model: int, num_classes_w_bg: int, n_boundaries: int) -> None:
        super().__init__()
        self.fc_label = nn.Linear(d_model, num_classes_w_bg)
        for k in GEO_KEYS:
            self.add_module(f"fc_{k}", nn.Linear(d_model, n_boundaries))

    def forward(self, h: torch.Tensor) -> dict:
        return {k: getattr(self, f"fc_{k}")(h) for k in ATTRS}


class ConcatCrossAttention(nn.Module):
    """The q, k, v projections of the concat GA cross-attention (width 2d);
    no out_proj: the layer's `cross_out` takes its place."""

    def __init__(self, d_cross: int, nhead: int, dropout: float = 0.1) -> None:
        super().__init__()
        self.nhead, self.head_dim = nhead, d_cross // nhead
        self.q_proj = nn.Linear(d_cross, d_cross)
        self.k_proj = nn.Linear(d_cross, d_cross)
        self.v_proj = nn.Linear(d_cross, d_cross)
        self.attn_drop = Dropout(dropout)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Concatenated head outputs [B, S, d_cross]."""
        B, S = q_in.shape[:2]
        q, k, v = (p(x).reshape(B, x.shape[1], self.nhead, self.head_dim)
                   for p, x in ((self.q_proj, q_in), (self.k_proj, k_in), (self.v_proj, v_in)))
        q = q * torch.tensor(self.head_dim, dtype=q.dtype) ** -0.5
        logits = torch.einsum("bshd,bmhd->bhsm", q, k).float()
        if bias is not None:
            logits = logits + bias.float()
        probs = self.attn_drop(torch.softmax(logits, dim=-1).to(q.dtype))
        return torch.einsum("bhsm,bmhd->bshd", probs, v).reshape(B, S, -1)


class GADecoderLayer(nn.Module):
    """Pre-LN decoder layer whose cross-attention query and key carry the
    geometry embeddings (`ga_type`: "concat", "add" or None)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1,
                 ga_type: Optional[str] = "concat") -> None:
        super().__init__()
        if ga_type not in ("concat", "add", None):
            raise ValueError(f"ga_type {ga_type!r}: 'concat', 'add' or None")
        self.ga_type = ga_type
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        if ga_type == "concat":
            self.cross_attn = ConcatCrossAttention(2 * d_model, nhead, dropout)
            self.cross_out = nn.Linear(2 * d_model, d_model)
        else:  # flax creates no cross_out for these: the layer never calls it
            self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.ffn = FeedForward(d_model, dim_feedforward, dropout)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, ga_q: torch.Tensor,
                ga_k: torch.Tensor, self_bias: Optional[torch.Tensor] = None,
                mem_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, self_bias)
        h = self.norm2(x)
        ca = self.cross_attn
        if self.ga_type == "concat":
            out = ca(torch.cat([h, ga_q], -1), torch.cat([memory, ga_k], -1),
                     torch.cat([memory, torch.zeros_like(memory)], -1), mem_bias)
            x = x + self.cross_out(out)
        elif self.ga_type == "add":  # key = memory + ga_k, value = memory alone
            k = ca._split(ca.k_proj(memory + ga_k))
            v = ca._split(ca.v_proj(memory))
            x = x + ca.attend(h + ga_q, k, v, mem_bias)
        else:
            x = x + ca(h, memory, mem_bias)
        return x + self.ffn(self.norm3(x))


class GADecoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int,
                 dropout: float = 0.1, ga_type: Optional[str] = "concat") -> None:
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", GADecoderLayer(d_model, nhead, dim_feedforward,
                                                         dropout, ga_type))

    def forward(self, x: torch.Tensor, memory: torch.Tensor, ga_q: torch.Tensor,
                ga_k: torch.Tensor, tgt_keep: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        S = x.shape[1]
        self_bias = causal_bias(S, x.device)[None, None] if causal else None
        if tgt_keep is not None:
            pad = keep_to_bias(tgt_keep)[:, None, None, :]
            self_bias = pad if self_bias is None else self_bias + pad
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, memory, ga_q, ga_k, self_bias)
        return x


class ICVTCore(nn.Module):
    """Every module of JAX's `ICVTCore` tree, the posterior side
    (`vae_encoder`, `aap`, `learnable_token`, `fc_mu`, `fc_var`) included,
    so that its weights load whole; sampling runs `encode_image`,
    `ga_key_grid`, `decode_step_stack` and `embed_layout`."""

    def __init__(self, num_labels: int, max_seq_length: int = 10, n_boundaries: int = 128,
                 ga_type: Optional[str] = "concat", image_hw: tuple[int, int] = (350, 240),
                 cfg: GeneratorConfig = GeneratorConfig(d_model=200)) -> None:
        super().__init__()
        d = cfg.d_model
        if d % 4 or d % 5:
            raise ValueError(f"ICVT's d_model must be a multiple of 4 and of 5, got {d}")
        K = num_labels + 1
        self.image_hw, self.n_boundaries = image_hw, n_boundaries
        self.encoder = ImageEncoder(cfg.backbone, d, cfg.nhead, cfg.num_encoder_layers, 2048,
                                    cfg.dropout, fpn_style="cgl")
        self.layout_encoder = LayoutDictEncoder(d // 5, K, n_boundaries)
        self.ga_layout_encoder = GeoDictEncoder(d // 4, n_boundaries)
        self.layout_decoder = LayoutDictDecoder(d, K, n_boundaries)
        self.pos_emb_1d = PositionalEncoding1D(d, cfg.dropout)
        self.vae_encoder = GADecoder(d, 8, cfg.num_encoder_layers, 2048, cfg.dropout, ga_type)
        self.vae_decoder = GADecoder(d, 8, cfg.num_decoder_layers, 2048, cfg.dropout, ga_type)
        self.aap = MultiHeadAttention(d, 8, cfg.dropout)
        self.learnable_token = nn.Parameter(torch.randn(1, 1, d) * 0.02)
        self.fc_mu = nn.Linear(d, d)
        self.fc_var = nn.Linear(d, d)

    def ga_key_grid(self, B: int) -> torch.Tensor:
        """The stride-16 feature map's grid as a pseudo-layout (22x15 cells
        at 350x240), embedded: [B, h*w, d].  The bucket ids are numpy's
        searchsorted(side="left") of the float64 grid over the float32
        boundaries, as JAX computes them."""
        gy, gx = -(-self.image_hw[0] // 16), -(-self.image_hw[1] // 16)
        ys, xs = np.meshgrid(np.arange(gy) / gy, np.arange(gx) / gx, indexing="ij")
        edges = linear_bucketizer(self.n_boundaries).boundaries
        dev = self.learnable_token.device

        def enc(v):
            v = np.clip(np.asarray(v, np.float64).reshape(-1), 0.0, 1.0)
            return torch.as_tensor(np.searchsorted(edges, v, side="left"), device=dev)

        ids = {"center_y": enc(ys), "center_x": enc(xs), "width": enc(np.full(gy * gx, 1 / gx)),
               "height": enc(np.full(gy * gx, 1 / gy))}
        return self.ga_layout_encoder(ids)[None].expand(B, -1, -1)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.encoder(image)

    def encode_posterior(self, ids: dict, img_memory: torch.Tensor, ga_k: torch.Tensor,
                         eps: torch.Tensor) -> tuple:
        """(z, mu, logvar [B, 1, d], the GT layout's embedding [B, S, d]): the GA
        encoder over the embedding (its own GA query, the key mask of the
        layout's elements), pooled by attention from the learnable token."""
        layout_feature = self.layout_encoder(ids)
        h = self.vae_encoder(layout_feature, img_memory, layout_feature, ga_k,
                             tgt_keep=ids["mask"])
        tok = self.learnable_token.expand(h.shape[0], -1, -1).to(h.dtype)
        pooled = self.aap(tok, h, keep_to_bias(ids["mask"])[:, None, None, :])
        mu, logvar = self.fc_mu(pooled), self.fc_var(pooled)
        return eps * torch.exp(0.5 * logvar) + mu, mu, logvar, layout_feature

    def forward(self, ids: dict, image: torch.Tensor, eps: torch.Tensor) -> tuple:
        """The teacher-forced pass: ({attribute: logits [B, S, .]}, mu, logvar).
        The GA query is the PE'd shifted target [z, e_0, ..., e_{S-2}]."""
        img_memory = self.encoder(image)
        ga_k = self.ga_key_grid(image.shape[0])
        z, mu, logvar, layout_feature = self.encode_posterior(ids, img_memory, ga_k, eps)
        shifted = self.pos_emb_1d(torch.cat([z, layout_feature[:, :-1]], dim=1))
        h = self.vae_decoder(shifted, img_memory, shifted, ga_k, causal=True)
        return self.layout_decoder(h), mu, logvar

    def embed_layout(self, ids: dict) -> torch.Tensor:
        return self.layout_encoder(ids)

    def decode_step_stack(self, tgt: torch.Tensor, img_memory: torch.Tensor,
                          ga_k: torch.Tensor) -> dict:
        """Every attribute's logits at every position of the causal decode of
        `tgt`; the GA query is the pre-PE target (the reference's sample
        loop; its training loop passes the PE'd one)."""
        h = self.vae_decoder(self.pos_emb_1d(tgt), img_memory, tgt, ga_k, causal=True)
        return self.layout_decoder(h)


class ICVTGenerator:
    """The argmax sample loop around `ICVTCore`.  Weights are random from
    `seed` until `utils.weights.load_jax_params` fills `self.core`; `device`
    defaults to the card and raises when there is none."""

    def __init__(self, num_labels: int, cfg: GeneratorConfig = GeneratorConfig(d_model=200),
                 ga_type: Optional[str] = "concat", kl_mult: float = 1.0,
                 max_seq_length: int = 10, image_hw: tuple[int, int] = (350, 240), *,
                 device="cuda", seed: int = 0) -> None:
        self.device = resolve_device(device)
        self.num_labels = num_labels
        self.cfg = cfg
        self.S = max_seq_length
        self.image_hw = image_hw
        self.kl_mult = kl_mult
        self.kl_beta = 1e-3
        self.task = "uncond"
        self.icvt_tokenizer = ICVTTokenizer(num_labels)
        self.tokenizer = None
        self.core = build_core(lambda: ICVTCore(num_labels, max_seq_length, ga_type=ga_type,
                                                image_hw=image_hw, cfg=cfg),
                               cfg, self.device, seed)

    def update_per_epoch(self, epoch: int, warmup: int, max_epoch: int) -> None:
        """The cyclical KL beta, 2 cycles: 1e-3 for the first half of a cycle,
        then linear up to 0.3 at three quarters, then 0.3."""
        period = max(max_epoch // 2, 1)
        t = (epoch % period) / period
        if t < 0.5:
            beta = 0.001
        elif t < 0.75:
            beta = 0.001 + (0.3 - 0.001) * (t - 0.5) / 0.25
        else:
            beta = 0.3
        self.kl_beta = beta

    def preprocess(self, batch: dict, rng: np.random.Generator) -> tuple[dict, dict]:
        """({'image', the ids of ATTRS, 'mask', 'vae_seed'}, {the ids of ATTRS})
        on the device, the seed drawn from `rng` as JAX does."""
        ids = {k: v.to(self.device) for k, v in
               self.icvt_tokenizer.encode(batch["layout"]).items()}
        inputs = {"image": device_image(batch["image"], self.device), **ids,
                  "vae_seed": int(rng.integers(2**31))}
        return inputs, {k: ids[k] for k in ATTRS}

    def loss(self, inputs: dict, targets: dict) -> tuple[torch.Tensor, dict]:
        """The sum of each attribute's cross-entropy (every position, BG
        included) and kl_mult * kl_beta * KL(q(z | layout) || N(0, I))."""
        image = inputs["image"]
        eps = seeded_normal((image.shape[0], 1, self.cfg.d_model), inputs["vae_seed"],
                            image.device)
        out, mu, logvar = self.core({k: inputs[k] for k in (*ATTRS, "mask")}, image, eps)
        losses = {}
        for k in ATTRS:
            lp = torch.log_softmax(out[k].float(), dim=-1)
            losses[f"loss_recon_{k}"] = -lp.gather(-1, targets[k][..., None]).mean()
        losses["loss_kl"] = -0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar))
        total = sum(losses[f"loss_recon_{k}"] for k in ATTRS)
        total = total + self.kl_mult * self.kl_beta * losses["loss_kl"]
        return total, {**losses, "nll_loss": total}

    def draw_latent(self, B: int, seed: int) -> torch.Tensor:
        """z ~ N(0, I) [B, 1, d] from a generator on the device seeded by `seed`."""
        return seeded_normal((B, 1, self.cfg.d_model), seed, self.device)

    def sample(self, batch: dict, rng: np.random.Generator,
               z: Optional[torch.Tensor] = None) -> Layout:
        """Layouts for a batch's canvases: S argmax steps from the latent z
        ([B, 1, d]; by default N(0, I) from a generator seeded by a draw of
        `rng`, which is made even when z is given, as in JAX)."""
        seed = int(rng.integers(2**31))
        return self.icvt_tokenizer.decode(self.sample_ids(batch["image"], seed, z))

    @torch.inference_mode()
    def sample_ids(self, image, seed: int, z: Optional[torch.Tensor] = None) -> dict:
        """{attribute: ids [B, S]} of `sample`, z drawn from `seed` unless given."""
        core, dev = self.core, self.device
        image = device_image(image, dev)
        B, d = image.shape[0], self.cfg.d_model
        img_memory = core.encode_image(image)
        ga_k = core.ga_key_grid(B)
        z = self.draw_latent(B, seed) if z is None else z
        dtype = img_memory.dtype
        ids = {k: torch.zeros((B, self.S), dtype=torch.long, device=dev) for k in ATTRS}
        tgt = torch.zeros((B, 1 + self.S, d), dtype=dtype, device=dev)
        tgt[:, :1] = torch.as_tensor(z, device=dev).to(dtype)
        for i in range(self.S):
            out = core.decode_step_stack(tgt[:, :-1], img_memory, ga_k)
            for k in ATTRS:
                ids[k][:, i] = out[k][:, i].argmax(-1)
            tgt[:, i + 1] = core.embed_layout({k: ids[k][:, i:i + 1] for k in ATTRS})[:, 0]
        return ids
