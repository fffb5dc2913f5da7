"""Discrete diffusion layout generators, LayoutDM and VQDiffusion: the
counterpart of `ralf_tpu/models/diffusion.py` for sampling.

One class serves both, as in JAX: LayoutDM's transitions stay inside each
attribute's own tokens and PAD (`q_type="constrained"`, the learned
element/attribute position encoding), VQDiffusion's replace over the whole
vocabulary (`q_type="default"`, the sine encoding); `with_retrieval` adds
the retrieval augmentation (RA-LayoutDM, `models/retrieval_augment.py`).

    memory = ImageEncoder(image + saliency, cgl FPN) [+ retrieval]     [B, M, D]
    logits = DiffusionDecoderCore(x_t | memory, t)                     [B, L, V]

Sampling starts from all [MASK] (or the user's tokens) and runs the
steps T - 1, ..., 0 (T = 50 by default): each predicts x_0 from the
decoder's logits, takes q(x_{t-1} | x_t, x_0) in log space over [B, L, V]
(`MaskAndReplaceDiffusion.q_posterior`, fp32), replaces the tokens the
user fixed, adds the refinement prior, moves the log-probabilities down
the relation costs' gradient (`ops.relation_costs`, from t = 10 up) and
forbids PAD where the element count is known, then samples.  This math
is plain torch: in JAX it is XLA, not a Pallas kernel.  The decoder's
self-attention (S = L, no bias) takes K1 at every step, 6 per step, and
its cross-attention over the memory K10, 6 per step, over K and V that
`cross_kv` projects once before the loop; the image encoder's
self-attention takes K1 too.

`q_pred`'s t - 1 = -1 reads row T of the cumulative tables, the identity:
JAX wraps the index with `(t + T + 1) % (T + 1)` and so does the port,
rather than rely on torch's negative indexing.

Training (`preprocess`, `loss`) draws a timestep t per canvas from the
numpy rng (uniform; `sample_time` switches to importance sampling once
`update_importance` has seen every t often enough, which no trainer calls,
as in JAX), noises the tokens to x_t by a Gumbel-max draw from q(x_t | x_0)
and takes `MaskAndReplaceDiffusion.loss`: the KL of the model's posterior
against the true one (the decoder NLL at t = 0), and the auxiliary x_0 KL,
both over p(t).  The Gumbel noise's uniforms come from `gumbel_uniforms`,
a torch generator on the device seeded with the rng's next integer (JAX
seeds `jax.random` with it, which torch cannot reproduce: parity passes
JAX's uniforms in).  In train mode every attention takes the einsum path;
RA-LayoutDM's frozen FIDNet stays in eval mode and takes K1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.core.conditioning import Condition, get_condition, normalize_task
from ralf_tpu_torch.core.layout import GEO_KEYS
from ralf_tpu_torch.core.sampling import SamplingConfig, sample
from ralf_tpu_torch.core.seq_length import SeqLengthDistribution
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer
from ralf_tpu_torch.models.base import (
    GeneratorConfig,
    build_core,
    compute_dtype,
    device_image,
    zoo_feedforward,
)
from ralf_tpu_torch.models.nn import LN_EPS, FeedForward, MultiHeadAttention, layer_norm
from ralf_tpu_torch.models.positional import ElemAttrPositionalEncoding1D, PositionalEncoding1D
from ralf_tpu_torch.models.ralf import RETRIEVED_KEYS, retrieved_tensors
from ralf_tpu_torch.models.resnet import ImageEncoder
from ralf_tpu_torch.ops.relation_costs import update_logits_for_relation
from ralf_tpu_torch.parallel import rows
from ralf_tpu_torch.utils import tracing
from ralf_tpu_torch.utils.device import resolve_device

LOG_EPS = float(np.log(1e-30))
# the mask-and-replace schedule's end points: alpha (keep) and gamma (mask)
# at the first and the last step
ATT_1, ATT_T, CTT_1, CTT_T = 0.999, 0.0001, 0.0001, 0.9
# refinement's weak prior: REFINE_LAMBDA on the tokens whose bin centres lie
# within REFINE_OFFSET_RATIO of the given one
REFINE_LAMBDA, REFINE_OFFSET_RATIO = 3.0, 0.2
Timestep = Union[int, torch.Tensor]  # one step for the batch, or [B] steps


# ---- schedules ------------------------------------------------------------------


def alpha_schedule(num_timesteps: int, N: int):
    """The mask-and-replace schedule in fp64: (at, bt, ct) [T] and the
    cumulative (att, btt, ctt) [T + 1], whose row T is the identity."""
    T = num_timesteps
    att = np.arange(T, dtype=np.float64) / (T - 1) * (ATT_T - ATT_1) + ATT_1
    att = np.concatenate([[1.0], att])
    at = att[1:] / att[:-1]
    ctt = np.arange(T, dtype=np.float64) / (T - 1) * (CTT_T - CTT_1) + CTT_1
    ctt = np.concatenate([[0.0], ctt])
    one_minus_ct = (1 - ctt)[1:] / (1 - ctt)[:-1]
    ct = 1 - one_minus_ct
    bt = (1 - at - ct) / N
    att = np.concatenate([att[1:], [1.0]])
    ctt = np.concatenate([ctt[1:], [0.0]])
    btt = (1 - att - ctt) / N
    return at, bt, ct, att, btt, ctt


def _safe_log(x: np.ndarray) -> np.ndarray:
    return np.log(np.clip(x, 1e-30, None))


@dataclasses.dataclass(frozen=True)
class TransitionTables:
    """Per-position log transition tables, fp32: [T, L] per step, [T + 1, L]
    cumulative, and `log_ind` [L, V], each position's sub-vocabulary (0
    inside, LOG_EPS outside; the MASK column always outside)."""

    log_at: torch.Tensor
    log_bt: torch.Tensor
    log_ct: torch.Tensor
    log_1_min_ct: torch.Tensor
    log_cum_at: torch.Tensor
    log_cum_bt: torch.Tensor
    log_cum_ct: torch.Tensor
    log_1_min_cum_ct: torch.Tensor
    log_ind: torch.Tensor


def build_tables(tokenizer: LayoutSequenceTokenizer, num_timesteps: int,
                 q_type: str = "constrained", device=None) -> TransitionTables:
    L, V = tokenizer.max_token_length, tokenizer.N_total
    mask_id, pad_id = tokenizer.name_to_id("mask"), tokenizer.pad_id
    C = tokenizer.N_var_per_element
    var_order = list(tokenizer.config.var_order)
    if q_type == "default":
        groups = ["all"]
        pos_group = np.zeros((L,), np.int64)
    elif q_type == "constrained":
        groups = var_order
        pos_group = np.arange(L) % C
    else:
        raise ValueError(q_type)

    per_group = []
    inds = np.full((len(groups), V), LOG_EPS, np.float64)
    for gi, key in enumerate(groups):
        if q_type == "default":  # uniform replacement over every non-mask token
            N = V - 1
            inds[gi, :] = 0.0
            inds[gi, mask_id] = LOG_EPS
        else:  # the attribute's own tokens and PAD
            if key == "label":
                tok_ids = np.arange(tokenizer.N_label)
            else:
                off = tokenizer.geo_offset(key)
                tok_ids = np.arange(off, off + tokenizer.N_bbox_per_var)
            N = len(tok_ids) + 1
            inds[gi, tok_ids] = 0.0
            inds[gi, pad_id] = 0.0
        per_group.append(alpha_schedule(num_timesteps, N=N))

    def stack(idx: int) -> np.ndarray:
        return np.stack([g[idx] for g in per_group], axis=1)[:, pos_group]  # [T(+1), L]

    def f(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(_safe_log(x).astype(np.float32), device=device)

    at, bt, ct, att, btt, ctt = (stack(i) for i in range(6))
    return TransitionTables(
        log_at=f(at), log_bt=f(bt), log_ct=f(ct), log_1_min_ct=f(1 - ct),
        log_cum_at=f(att), log_cum_bt=f(btt), log_cum_ct=f(ctt), log_1_min_cum_ct=f(1 - ctt),
        log_ind=torch.as_tensor(inds[pos_group].astype(np.float32), device=device),
    )


# ---- diffusion math (log space, [B, L, V], vocabulary last) ---------------------


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def index_to_log_onehot(x: torch.Tensor, V: int) -> torch.Tensor:
    """int [...] -> fp32 [..., V]: 0 at the token, LOG_EPS elsewhere (an index
    outside [0, V) gives a row of LOG_EPS, as jax.nn.one_hot's zeros do)."""
    hit = x[..., None] == torch.arange(V, device=x.device)
    return torch.where(hit, 0.0, LOG_EPS)


def log_onehot_to_index(log_x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(log_x, dim=-1)


def gumbel_uniforms(shape: tuple, seed: int, device) -> torch.Tensor:
    """The uniforms [0, 1) of `q_sample`'s Gumbel noise, from a generator on
    `device` seeded by `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return rows.draw(lambda s: torch.rand(s, generator=g, device=device), shape)


def aux_weight(t: torch.Tensor, T: int) -> torch.Tensor:
    """The auxiliary loss's weight (1 - t / T) + 1, fp32, as JAX's jitted step
    computes it: XLA turns t / T into t times the fp32 reciprocal of T and
    folds the two additions into one rounding of 2 - t * (1 / T), which is
    exact in fp64 before it."""
    return (2.0 - t.double() * float(np.float32(1.0) / np.float32(T))).float()


class MaskAndReplaceDiffusion:
    """q and p over [B, L, V] log tensors."""

    def __init__(self, tokenizer: LayoutSequenceTokenizer, num_timesteps: int,
                 q_type: str = "constrained", device=None) -> None:
        sp = tuple(tokenizer.config.special_tokens)
        if "mask" not in sp or tokenizer.name_to_id("mask") != tokenizer.N_total - 1:
            raise ValueError(f"diffusion needs MASK as the last token, got special tokens {sp}")
        self.tokenizer = tokenizer
        self.T = num_timesteps
        self.q_type = q_type
        self.tables = build_tables(tokenizer, num_timesteps, q_type, device)
        self.V = tokenizer.N_total
        self.L = tokenizer.max_token_length
        self.mask_id = tokenizer.N_total - 1

    @staticmethod
    def _g(table: torch.Tensor, t: Timestep) -> torch.Tensor:
        """Rows t of a [T(+1), L] table as [B or 1, L, 1]."""
        return table[t][None, :, None] if isinstance(t, int) else table[t][:, :, None]

    def q_pred_one_timestep(self, log_x_t: torch.Tensor, t: Timestep) -> torch.Tensor:
        """q(x_t | x_{t-1})."""
        tb = self.tables
        non_mask = log_add_exp(log_x_t[..., :-1] + self._g(tb.log_at, t),
                               self._g(tb.log_bt, t) + tb.log_ind[None, :, :-1])
        mask_row = log_add_exp(log_x_t[..., -1:] + self._g(tb.log_1_min_ct, t),
                               self._g(tb.log_ct, t))
        return torch.cat([non_mask, mask_row], dim=-1)

    def q_pred(self, log_x_start: torch.Tensor, t: Timestep) -> torch.Tensor:
        """q(x_t | x_0); t = -1 wraps to row T, the identity."""
        tb = self.tables
        t = (t + (self.T + 1)) % (self.T + 1)
        non_mask = log_add_exp(log_x_start[..., :-1] + self._g(tb.log_cum_at, t),
                               self._g(tb.log_cum_bt, t) + tb.log_ind[None, :, :-1])
        mask_row = log_add_exp(log_x_start[..., -1:] + self._g(tb.log_1_min_cum_ct, t),
                               self._g(tb.log_cum_ct, t))
        return torch.cat([non_mask, mask_row], dim=-1)

    def q_posterior(self, log_x_start: torch.Tensor, log_x_t: torch.Tensor,
                    t: Timestep) -> torch.Tensor:
        """log p(x_{t-1} | x_t) = log sum_x0 q(x_{t-1} | x_t, x0) p(x0)."""
        tb = self.tables
        is_mask = (log_onehot_to_index(log_x_t) == self.mask_id)[:, :, None]
        log_qt = self.q_pred(log_x_t, t)[..., :-1]
        log_qt = torch.where(is_mask, self._g(tb.log_cum_ct, t), log_qt)
        log_qt1 = self.q_pred_one_timestep(log_x_t, t)
        eps_col = torch.full_like(log_qt1[..., -1:], LOG_EPS)
        log_qt1 = torch.cat([log_qt1[..., :-1], eps_col], dim=-1)
        ct_row = torch.cat([self._g(tb.log_ct, t).expand_as(log_qt1[..., :-1]),
                            torch.zeros_like(eps_col)], dim=-1)
        log_qt1 = torch.where(is_mask, ct_row, log_qt1)
        # columns outside a position's sub-vocabulary are dropped, not shifted:
        # x_start and log_qt both sit near LOG_EPS there (no-op for "default")
        in_vocab = tb.log_ind[None, :, :-1] > 0.5 * LOG_EPS
        q = torch.where(in_vocab, log_x_start[..., :-1] - log_qt, LOG_EPS)
        q = torch.cat([q, torch.full_like(q[..., :1], LOG_EPS)], dim=-1)
        q_norm = torch.logsumexp(q, dim=-1, keepdim=True)
        q = q - q_norm
        out = self.q_pred(q, t - 1) + log_qt1 + q_norm
        return torch.clamp(out, -70.0, 0.0)

    def log_sample_categorical(self, u: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        """The Gumbel-max draw of each position's token given the uniforms u,
        as a log one-hot [B, L, V]."""
        gumbel = -torch.log(-torch.log(u + 1e-30) + 1e-30)
        return index_to_log_onehot(torch.argmax(gumbel + logits, dim=-1), self.V)

    def q_sample(self, u: torch.Tensor, log_x_start: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        """x_t ~ q(x_t | x_0) as a log one-hot, given the uniforms u [B, L, V]."""
        return self.log_sample_categorical(u, self.q_pred(log_x_start, t))

    def predict_start(self, logits: torch.Tensor) -> torch.Tensor:
        """Decoder logits [B, L, V] -> log p(x0 | x_t), MASK excluded and (for
        "constrained") each position's sub-vocabulary applied."""
        lp = torch.log_softmax(logits[..., :-1].float(), dim=-1)
        if self.q_type == "constrained":
            lp = lp + self.tables.log_ind[None, :, :-1]
        lp = torch.cat([lp, torch.full_like(lp[..., :1], -70.0)], dim=-1)
        return torch.clamp(lp, -70.0, 0.0)

    def loss(self, u: torch.Tensor, logits_fn, x_start: torch.Tensor, t: torch.Tensor,
             pt: torch.Tensor, auxiliary_loss_weight: float = 0.1) -> tuple[torch.Tensor, dict]:
        """x_start [B, L] tokens, t [B] timesteps, pt [B] their probabilities,
        u [B, L, V] the noise's uniforms; logits_fn(x_t, t) -> [B, L, V].
        (loss, {'kl_loss', 'kl_per_sample' [B], 'aux_loss'}): the KL of the
        model's posterior against the true one over p(t) (the decoder NLL at
        t = 0), plus the auxiliary x_0 KL weighted by 2 - t/T."""
        log_x_start = index_to_log_onehot(x_start, self.V)
        log_x_t = self.q_sample(u, log_x_start, t)
        log_x0_recon = self.predict_start(logits_fn(log_onehot_to_index(log_x_t), t))
        log_model_prob = self.q_posterior(log_x0_recon, log_x_t, t)
        log_true_prob = self.q_posterior(log_x_start, log_x_t, t)

        kl = (torch.exp(log_true_prob) * (log_true_prob - log_model_prob)).sum(-1).mean(-1)
        decoder_nll = -(torch.exp(log_x_start) * log_model_prob).sum(-1).mean(-1)
        at0 = (t == 0).float()
        kl_loss = at0 * decoder_nll + (1 - at0) * kl
        loss = (kl_loss / pt).mean()
        losses = {"kl_loss": loss, "kl_per_sample": kl_loss}
        if auxiliary_loss_weight > 0:
            x0 = log_x_start[..., :-1]
            kl_aux = (torch.exp(x0) * (x0 - log_x0_recon[..., :-1])).sum(-1).mean(-1)
            kl_aux_loss = at0 * decoder_nll + (1 - at0) * kl_aux
            w = aux_weight(t, self.T)
            losses["aux_loss"] = (w * auxiliary_loss_weight * kl_aux_loss / pt).mean()
            loss = loss + losses["aux_loss"]
        return loss, losses

    def sample_single_step(
        self, log_z: torch.Tensor, logits_fn, t: int, sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
        strong_seq: Optional[torch.Tensor] = None,  # [B, L] tokens
        strong_mask: Optional[torch.Tensor] = None,  # [B, L] bool
        weak_mask: Optional[torch.Tensor] = None,  # [B, L, V] bool
        weak_logits: Optional[torch.Tensor] = None,  # [B, L, V]
        pad_disable_mask: Optional[torch.Tensor] = None,  # [B, L] bool
        relation_edges: Optional[tuple] = None,  # (edge_idx [B, E, 2], edge_attr [B, E])
    ) -> torch.Tensor:
        """One reverse step at timestep t for the whole batch -> log one-hot z.
        Traced: the decoder's prediction of x_0 is the span
        `zoo.denoise.decoder`, the posterior through the sampled one-hot
        `zoo.denoise.posterior` (both with device time on the card)."""
        B, on_card = log_z.shape[0], log_z.is_cuda
        with tracing.span("zoo.denoise.decoder", device=on_card):
            t_b = torch.full((B,), t, dtype=torch.long, device=log_z.device)
            log_x_recon = self.predict_start(logits_fn(log_onehot_to_index(log_z), t_b))
        with tracing.span("zoo.denoise.posterior", device=on_card):
            model_log_prob = self.q_posterior(log_x_recon, log_z, t)
            if strong_seq is not None:
                model_log_prob = torch.where(strong_mask[:, :, None],
                                             index_to_log_onehot(strong_seq, self.V),
                                             model_log_prob)
            if weak_logits is not None:
                model_log_prob = torch.where(weak_mask, model_log_prob + weak_logits,
                                             model_log_prob)
            if relation_edges is not None and t >= 10:  # below 10 its gate is 0: the identity
                model_log_prob = update_logits_for_relation(
                    model_log_prob, t_b, *relation_edges, self.tokenizer)
            if pad_disable_mask is not None:
                is_pad = torch.arange(self.V, device=log_z.device) == self.tokenizer.pad_id
                model_log_prob = torch.where(pad_disable_mask[:, :, None] & is_pad, LOG_EPS,
                                             model_log_prob)
            return index_to_log_onehot(sample(model_log_prob, sampling, generator), self.V)


# ---- the timestep-conditioned decoder -------------------------------------------


def timestep_frequencies(d_model: int) -> np.ndarray:
    """exp(i * -log(10000) / (half - 1)) for i < half, fp32: the product in
    fp32, the exp correctly rounded, as XLA computes the constant in a
    jitted program (JAX's samplers are jitted).  One ulp matters: the
    timestep's angle reaches some 4000 radians, where an ulp of a frequency
    moves a sine by 5e-5."""
    half = d_model // 2
    arg = np.arange(half, dtype=np.float32) * np.float32(-math.log(10000.0) / (half - 1))
    return np.exp(arg.astype(np.float64)).astype(np.float32)


class AdaLayerNorm(nn.Module):
    """LayerNorm without affine (eps 1e-6), modulated by the timestep:
    h (1 + scale) + shift, with (scale, shift) = Dense(SiLU(sine embedding
    of t / max_timestep * 4000)), the frequencies over half - 1."""

    def __init__(self, d_model: int, max_timestep: int = 100) -> None:
        super().__init__()
        self.d_model, self.max_timestep = d_model, max_timestep
        self.Dense_0 = nn.Linear(d_model, 2 * d_model)
        self.register_buffer("freqs", torch.from_numpy(timestep_frequencies(d_model)),
                             persistent=False)
        # t / max_timestep * 4000 as jitted XLA computes it: t times one fp32
        # constant, fp32(1 / max_timestep) * 4000 rounded
        self.t_scale = float(np.float32(np.float32(1.0) / np.float32(max_timestep))
                             * np.float32(4000.0))

    def forward(self, x: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
        emb = (timestep.float() * self.t_scale)[:, None] * self.freqs.float()[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
        emb = self.Dense_0(F.silu(emb.to(compute_dtype(x))))[:, None, :]
        scale, shift = emb.chunk(2, dim=-1)
        h = F.layer_norm(x, (self.d_model,), eps=LN_EPS).to(compute_dtype(x))
        return h * (1 + scale) + shift


class DiffusionDecoderLayer(nn.Module):
    """Pre-LN decoder layer with AdaLayerNorm before both attentions; the
    submodules carry flax's automatic names."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1,
                 max_timestep: int = 100) -> None:
        super().__init__()
        self.AdaLayerNorm_0 = AdaLayerNorm(d_model, max_timestep)
        self.MultiHeadAttention_0 = MultiHeadAttention(d_model, nhead, dropout)
        self.AdaLayerNorm_1 = AdaLayerNorm(d_model, max_timestep)
        self.MultiHeadAttention_1 = MultiHeadAttention(d_model, nhead, dropout)
        self.LayerNorm_0 = layer_norm(d_model)
        self.FeedForward_0 = FeedForward(d_model, dim_feedforward, dropout)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, timestep: torch.Tensor,
                cross: Optional[tuple] = None) -> torch.Tensor:
        """`cross`: this layer's (k, v) over the memory from `cross_kv`, which
        the cross-attention then reads instead of projecting the memory."""
        h = self.AdaLayerNorm_0(x, timestep)
        x = x + self.MultiHeadAttention_0(h, h)  # S == M, no bias: K1 in eval mode
        h = self.AdaLayerNorm_1(x, timestep)
        k, v = self.MultiHeadAttention_1.project_kv(memory) if cross is None else cross
        x = x + self.MultiHeadAttention_1.attend(h, k, v)  # S != M: K10 in eval mode on the card
        return x + self.FeedForward_0(self.LayerNorm_0(x))


class DiffusionDecoderCore(nn.Module):
    """Embedding + position encoding ("elem_attr" learned for LayoutDM,
    "layout" sine for VQDiffusion) + N AdaLN layers + LayerNorm and a
    bias-free head."""

    def __init__(self, vocab_size: int, d_model: int = 256, nhead: int = 8, num_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1, max_timestep: int = 100,
                 n_attr_per_elem: int = 5, pos_emb: str = "elem_attr") -> None:
        super().__init__()
        self.num_layers = num_layers
        self.Embed_0 = nn.Embedding(vocab_size, d_model)
        if pos_emb == "elem_attr":
            self.ElemAttrPositionalEncoding1D_0 = ElemAttrPositionalEncoding1D(
                d_model, dropout, n_attr_per_elem=n_attr_per_elem)
        else:
            self.PositionalEncoding1D_0 = PositionalEncoding1D(d_model, dropout)
        self.pos_emb = pos_emb
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DiffusionDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, max_timestep))
        self.LayerNorm_0 = layer_norm(d_model)
        self.Dense_0 = nn.Linear(d_model, vocab_size, bias=False)

    def layers(self) -> list[DiffusionDecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def cross_kv(self, memory: torch.Tensor) -> list[tuple]:
        """Each layer's cross-attention (k, v) [B, M, H, Dh] over the memory:
        the projections of a denoising loop, made once for all its steps."""
        return [layer.MultiHeadAttention_1.project_kv(memory) for layer in self.layers()]

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, timestep: torch.Tensor,
                cross: Optional[list] = None) -> torch.Tensor:
        """Logits [B, L, V]; with `cross` (`cross_kv(memory)`) the layers read
        the projected K and V instead of projecting the memory again."""
        pos = (self.ElemAttrPositionalEncoding1D_0 if self.pos_emb == "elem_attr"
               else self.PositionalEncoding1D_0)
        h = pos(self.Embed_0(tgt))
        for i, layer in enumerate(self.layers()):
            h = layer(h, memory, timestep, None if cross is None else cross[i])
        return self.Dense_0(self.LayerNorm_0(h))


class LayoutDMCore(nn.Module):
    def __init__(self, vocab_size: int, num_timesteps: int, pos_emb: str,
                 cfg: GeneratorConfig = GeneratorConfig(), with_retrieval: bool = False,
                 num_labels: int = 3, max_seq_length: int = 10, top_k: int = 16) -> None:
        super().__init__()
        ff = zoo_feedforward(cfg)
        self.encoder = ImageEncoder(cfg.backbone, cfg.d_model, cfg.nhead, cfg.num_encoder_layers,
                                    ff, cfg.dropout, fpn_style="cgl")
        self.with_retrieval = with_retrieval
        if with_retrieval:
            from ralf_tpu_torch.models.retrieval_augment import RetrievalAugmentation

            self.retrieval_aug = RetrievalAugmentation(num_labels, max_seq_length, cfg.d_model,
                                                       top_k, cfg.dropout)
        self.decoder = DiffusionDecoderCore(vocab_size, cfg.d_model, cfg.nhead,
                                            cfg.num_decoder_layers, ff, cfg.dropout,
                                            max_timestep=num_timesteps, pos_emb=pos_emb)

    def encode_memory(self, image: torch.Tensor, retrieved: Optional[dict] = None) -> torch.Tensor:
        memory = self.encoder(image)
        if self.with_retrieval:
            memory = self.retrieval_aug(memory, retrieved)
        return memory

    def forward(self, seq: torch.Tensor, image: torch.Tensor, timestep: torch.Tensor,
                retrieved: Optional[dict] = None) -> torch.Tensor:
        return self.decoder(seq, self.encode_memory(image, retrieved), timestep)


# ---- the generator ----------------------------------------------------------------


class LayoutDMGenerator:
    """LayoutDM (q_type "constrained", pos_emb "elem_attr") and VQDiffusion
    (q_type "default", pos_emb "layout") behind one wrapper; with_retrieval
    is RA-LayoutDM.  Weights are random from `seed` until
    `utils.weights.load_jax_params` fills `self.core`; `device` defaults to
    the card and raises when there is none."""

    def __init__(self, tokenizer: LayoutSequenceTokenizer,
                 cfg: GeneratorConfig = GeneratorConfig(), num_timesteps: int = 50,
                 q_type: str = "constrained", pos_emb: str = "elem_attr",
                 auxiliary_loss_weight: float = 0.1, image_hw: tuple[int, int] = (350, 240),
                 with_retrieval: bool = False, top_k: int = 16, use_seq_dist: bool = False, *,
                 device="cuda", seed: int = 0) -> None:
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.task = "uncond"
        self.image_hw = image_hw
        self.num_timesteps = num_timesteps
        self.aux_w = auxiliary_loss_weight
        self.with_retrieval = with_retrieval
        self.top_k = top_k
        self.diffusion = MaskAndReplaceDiffusion(tokenizer, num_timesteps, q_type, self.device)
        self.core = build_core(lambda: LayoutDMCore(
            tokenizer.N_total, num_timesteps, pos_emb, cfg, with_retrieval, tokenizer.N_label,
            tokenizer.max_seq_length, top_k), cfg, self.device, seed)
        # the element-count EMA: with use_seq_dist, uncond sampling pins the
        # positions past a drawn count to PAD through the strong constraint
        self.use_seq_dist = use_seq_dist
        self.seq_dist = SeqLengthDistribution(tokenizer.max_seq_length)
        # the timesteps' importance statistics: a 0.9-EMA of each t's squared
        # KL and its count (`update_importance`)
        self.Lt_history = np.zeros((num_timesteps,))
        self.Lt_count = np.zeros((num_timesteps,))

    # ---- training ------------------------------------------------------------------

    def sample_time(self, B: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """(t [B], p(t) [B]): uniform until every t has been seen more than 10
        times, then in proportion to sqrt(E[KL^2]) (t = 0 weighted as t = 1)."""
        T = self.num_timesteps
        if not (self.Lt_count > 10).all():
            return rng.integers(0, T, size=B), np.full((B,), 1.0 / T)
        w = np.sqrt(self.Lt_history + 1e-10) + 1e-4
        w[0] = w[1]
        p = w / w.sum()
        t = rng.choice(T, size=B, p=p)
        return t, p[t]

    def update_importance(self, t: np.ndarray, kl: np.ndarray) -> None:
        """Fold a batch's per-sample KL (`kl_per_sample`) into the statistics."""
        for ti, ki in zip(t, kl):
            self.Lt_history[ti] = 0.9 * self.Lt_history[ti] + 0.1 * ki**2
            self.Lt_count[ti] += 1

    def preprocess(self, batch: dict, rng: np.random.Generator) -> tuple[dict, dict]:
        """({'image', 't', 'pt', 'noise_seed'[, 'retrieved']}, {'seq'}) on the
        device, drawing from `rng` as JAX does (the timesteps, then the
        noise's seed)."""
        layout, dev = batch["layout"], self.device
        self.seq_dist.update(layout.mask.cpu().numpy())
        seq = self.tokenizer.encode(layout)["seq"].to(dev)
        t, pt = self.sample_time(seq.shape[0], rng)
        inputs = {"image": device_image(batch["image"], dev),
                  "t": torch.as_tensor(t.astype(np.int32), device=dev).long(),
                  "pt": torch.as_tensor(pt.astype(np.float32), device=dev),
                  "noise_seed": int(rng.integers(2**31))}
        if self.with_retrieval:
            inputs["retrieved"] = retrieved_tensors(
                {k: batch["retrieved"][k] for k in RETRIEVED_KEYS}, dev)
        return inputs, {"seq": seq}

    def loss(self, inputs: dict, targets: dict) -> tuple[torch.Tensor, dict]:
        """The diffusion loss of the core in its current mode (see the module
        docstring); the aux holds kl_loss, aux_loss and kl_per_sample [B]."""
        memory = self.core.encode_memory(inputs["image"], inputs.get("retrieved"))
        seq = targets["seq"]
        u = gumbel_uniforms((*seq.shape, self.diffusion.V), inputs["noise_seed"], seq.device)
        return self.diffusion.loss(u, lambda x_t, t: self.core.decoder(x_t, memory, t), seq,
                                   inputs["t"], inputs["pt"], self.aux_w)

    # ---- sampling ------------------------------------------------------------------

    def build_condition(self, batch: dict, rng: np.random.Generator,
                        task: Optional[str] = None):
        """(condition, target layout) of `task` (default the generator's); the
        RA variant's neighbours ride on the condition."""
        task = self.task if task is None else normalize_task(task)
        with tracing.span("gen.condition"):
            return get_condition(batch["layout"], batch["image"], task, self.tokenizer, rng,
                                 ids=batch.get("id"), retrieved=batch.get("retrieved"),
                                 relationships=getattr(self, "relationships_table", None))

    def sample(self, cond: Condition, sampling: SamplingConfig,
               generator: Optional[torch.Generator] = None, return_tokens: bool = False):
        """Layouts (and tokens [B, L]) for a condition: the host side
        (`prepare_sample`), then the device side (`sample_prepared`)."""
        seq = self.sample_prepared(self.prepare_sample(cond, generator), sampling, generator)
        layout = self.tokenizer.decode(seq)
        return (layout, seq) if return_tokens else layout

    def prepare_sample(self, cond: Condition,
                       generator: Optional[torch.Generator] = None) -> dict:
        """The conditioning tensors on the device: absent conditioning is an
        absent key.  use_seq_dist's element counts come from a numpy rng
        seeded by the generator's seed.  Traced, the host bytes handed over
        are counted (`utils.tracing.count_h2d`)."""
        tok, dev = self.tokenizer, self.device

        def put(x) -> torch.Tensor:
            x = np.asarray(x)
            tracing.count_h2d(x)
            return torch.as_tensor(x, device=dev)

        V, L = tok.N_total, tok.max_token_length
        image = device_image(cond.image, dev)
        B = image.shape[0]
        task = normalize_task(cond.task)

        all_mask = torch.full((B, L, V), LOG_EPS, device=dev)
        all_mask[:, :, -1] = 0.0
        prepared = {"image": image, "z0": all_mask}
        if cond.seq is not None:
            seq = put(cond.seq).long()
            prepared["z0"] = index_to_log_onehot(seq, V)
            prepared["strong_seq"] = seq
            prepared["strong_mask"] = put(cond.seq_mask).bool()
        elif self.use_seq_dist and task == "uncond":
            rng = np.random.default_rng(None if generator is None else generator.initial_seed())
            n = self.seq_dist.sample(rng, B)  # positions past 5 n are pinned to PAD
            beyond = np.arange(L)[None, :] >= n[:, None] * tok.N_var_per_element
            prepared["strong_seq"] = put(np.where(beyond, tok.pad_id, 0))
            prepared["strong_mask"] = put(beyond)
        if task == "refinement":
            prepared["weak_logits"], prepared["weak_mask"] = self._refinement_weak_logits(cond)
        if task == "relation" and cond.edges is not None:
            prepared["edge_indexes"] = put(cond.edges["edge_indexes"]).long()
            prepared["edge_attributes"] = put(cond.edges["edge_attributes"]).long()
        if task in ("c", "cwh", "refinement", "relation") and cond.seq is not None:
            attr = np.arange(L) % tok.N_var_per_element
            prepared["pad_disable"] = put((attr[None, :] != 0)
                                          & (np.asarray(cond.seq) != tok.pad_id))
        if self.with_retrieval:
            if cond.retrieved is None:
                raise ValueError("RA-LayoutDM needs the retrieved layouts on the condition")
            prepared["retrieved"] = retrieved_tensors(
                {k: cond.retrieved[k] for k in RETRIEVED_KEYS}, dev)
        return prepared

    @torch.no_grad()
    def sample_prepared(self, prepared: dict, sampling: SamplingConfig,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Encode, then the denoising loop over t = T - 1, ..., 0 -> tokens [B, L].  Under
        no_grad rather than inference_mode: the relation update takes a
        gradient (`ops.relation_costs`).  The decoder's cross-attention K and
        V are projected once, before the loop (`DiffusionDecoderCore.cross_kv`).
        Traced: the spans `gen.encode` (with device time on the card) and
        `zoo.denoise` over the projection and the loop."""
        with tracing.span("gen.encode", device=self.device.type == "cuda"):
            memory = self.core.encode_memory(prepared["image"], prepared.get("retrieved"))
        edges = None
        if "edge_indexes" in prepared:
            edges = (prepared["edge_indexes"], prepared["edge_attributes"])
        log_z = prepared["z0"]
        with tracing.span("zoo.denoise"):
            cross = self.core.decoder.cross_kv(memory)

            def logits_fn(x_t, t):
                return self.core.decoder(x_t, memory, t, cross)

            for t in range(self.num_timesteps - 1, -1, -1):
                log_z = self.diffusion.sample_single_step(
                    log_z, logits_fn, t, sampling, generator,
                    prepared.get("strong_seq"), prepared.get("strong_mask"),
                    prepared.get("weak_mask"), prepared.get("weak_logits"),
                    prepared.get("pad_disable"), edges)
        return log_onehot_to_index(log_z)

    def _refinement_weak_logits(self, cond: Condition) -> tuple[torch.Tensor, torch.Tensor]:
        """The smoothed one-hot geometry prior, JAX's "uniform" mode: (weak
        logits [B, L, V], where they apply [B, L, V], the positions the
        condition does not fix)."""
        tok = self.tokenizer
        V, N = tok.N_total, tok.N_bbox_per_var
        table = np.zeros((V, V), np.float32)
        np.fill_diagonal(table, 1.0)
        for key in GEO_KEYS:
            off = tok.geo_offset(key)
            centers = tok.bucketizers[key].centers
            ii, jj = np.meshgrid(centers, centers, indexing="ij")
            table[off : off + N, off : off + N] = np.abs(ii - jj) < REFINE_OFFSET_RATIO
        host = (np.asarray(cond.seq), table, np.asarray(cond.seq_mask))
        for x in host:
            tracing.count_h2d(x)
        seq, table, known = (torch.as_tensor(x, device=self.device) for x in host)
        seq, known = seq.long(), known.bool()
        weak_logits = table[seq] * REFINE_LAMBDA
        return weak_logits, (~known)[:, :, None].expand_as(weak_logits)
