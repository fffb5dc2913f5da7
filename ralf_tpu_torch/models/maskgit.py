"""MaskGIT, the masked parallel decoding baseline: the counterpart of
`ralf_tpu/models/maskgit.py` for sampling.

    memory = ImageEncoder(image + saliency, cgl FPN)           [B, M, D]
    logits = TokenDecoder(tokens | memory, bidirectional)      [B, L, V]

Sampling runs T steps (10 by default) over the whole sequence at once.
Each step predicts every position, keeps the prediction where the token
was [MASK], and re-masks the least confident of the positions that were
masked, by the schedule's ratio of the positions the user left free (the
ratio rounded as JAX's jitted loop rounds it, `remask_rate`).  The
confidence is the log-probability of the chosen token plus Gumbel noise
at the temperature temperature * (1 - (t + 1) / T), drawn from the
generator: torch cannot reproduce `jax.random`'s draws, so the port equals
JAX only where the noise vanishes (`sampling.temperature=0` with
deterministic sampling).  Step 0 re-masks everything: no position starts
as [MASK], and `core.mask.batch_topk_mask` keeps JAX's -inf >= -inf quirk.

The image encoder's self-attention takes K1 in eval mode; the decoder's
does not (its bias is a [1, 1, S, S] zero matrix, as in JAX).  The
tokenizer has the special tokens (pad, mask) and no BOS/EOS.

Training masks a random share of each sequence and predicts it back
(`preprocess`, `loss`): the share is the schedule's rate at a uniform
draw of the numpy rng, and the positions come from `draw_loss_mask`, a
torch generator on the device seeded with the rng's next integer (JAX
seeds `jax.random` with it, which torch cannot reproduce: parity passes
JAX's mask in).  The loss is cross-entropy with smoothing 0.1 over the
masked positions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.core.conditioning import Condition, get_condition, normalize_task
from ralf_tpu_torch.core.mask import batch_topk_mask, mask_schedule, sample_mask
from ralf_tpu_torch.core.sampling import NEG_INF, SamplingConfig, sample
from ralf_tpu_torch.core.seq_length import SeqLengthDistribution
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer
from ralf_tpu_torch.models.base import (
    GeneratorConfig,
    build_core,
    device_image,
    zoo_feedforward,
)
from ralf_tpu_torch.models.nn import TokenDecoder
from ralf_tpu_torch.models.resnet import ImageEncoder
from ralf_tpu_torch.parallel import rows
from ralf_tpu_torch.utils.device import resolve_device


def remask_rate(t: int, T: int, schedule: str = "linear") -> np.float32:
    """The mask rate after step t of T, as JAX's jitted loop computes it:
    XLA turns (t + 1) / T into (t + 1) times the fp32 reciprocal of T, and
    for the linear schedule fuses 1 - that into one rounding (an FMA).  At
    T = 10 that re-masks 14 positions of 50 after step 6, where the
    correctly rounded 1 - 7/10 gives 15.  The product is exact in fp64."""
    float_t = (t + 1) * float(np.float32(1.0) / np.float32(T))
    if schedule == "linear":
        return np.clip(np.float32(1.0 - float_t), np.float32(1e-6), np.float32(1.0))
    return mask_schedule(torch.tensor(np.float32(float_t)), schedule).numpy()


def draw_loss_mask(ratio: torch.Tensor, T: int, seed: int) -> torch.Tensor:
    """The training mask [B, T] bool: max(int(ratio * T), 1) positions of each
    row, uniformly at random, from a generator on ratio's device seeded by `seed`."""
    g = torch.Generator(device=ratio.device).manual_seed(seed)
    every = torch.ones((ratio.shape[0], T), dtype=torch.bool, device=ratio.device)
    return sample_mask(every, ratio, g)


class MaskGITCore(nn.Module):
    def __init__(self, vocab_size: int, cfg: GeneratorConfig = GeneratorConfig()) -> None:
        super().__init__()
        ff = zoo_feedforward(cfg)
        self.encoder = ImageEncoder(cfg.backbone, cfg.d_model, cfg.nhead, cfg.num_encoder_layers,
                                    ff, cfg.dropout, fpn_style="cgl")
        self.decoder = TokenDecoder(vocab_size, cfg.d_model, cfg.nhead, cfg.num_decoder_layers,
                                    ff, cfg.dropout)

    def encode_memory(self, image: torch.Tensor) -> torch.Tensor:
        return self.encoder(image)

    def forward(self, seq: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        """Logits [B, L, V] of the bidirectional decoder over every token."""
        return self.decoder(seq, self.encode_memory(image), causal=False)


class MaskGITGenerator:
    """Conditioning and the T-step sampler around `MaskGITCore`.  Weights are
    random from `seed` until `utils.weights.load_jax_params` fills `self.core`;
    `device` defaults to the card and raises when there is none."""

    def __init__(self, tokenizer: LayoutSequenceTokenizer,
                 cfg: GeneratorConfig = GeneratorConfig(), mask_schedule_name: str = "linear",
                 use_gumbel_noise: bool = True, num_timesteps: int = 10,
                 image_hw: tuple[int, int] = (350, 240), *, device="cuda", seed: int = 0) -> None:
        sp = tuple(tokenizer.config.special_tokens)
        if "mask" not in sp or "bos" in sp:
            raise ValueError(f"MaskGIT needs a (pad, mask) tokenizer without BOS/EOS, got {sp}")
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.schedule = mask_schedule_name
        self.use_gumbel_noise = use_gumbel_noise
        self.num_timesteps = num_timesteps
        self.image_hw = image_hw
        self.task = "uncond"
        self.mask_id = tokenizer.name_to_id("mask")
        self.pad_id = tokenizer.pad_id
        self.core = build_core(lambda: MaskGITCore(tokenizer.N_total, cfg), cfg, self.device, seed)
        self.token_mask = torch.as_tensor(tokenizer.token_mask, device=self.device)
        self.seq_dist = SeqLengthDistribution(tokenizer.max_seq_length)  # the element-count EMA

    def preprocess(self, batch: dict, rng: np.random.Generator) -> tuple[dict, dict]:
        """Random masking: ({'seq': masked tokens, 'image'}, {'seq': tokens,
        'loss_mask'}) on the device, drawing from `rng` as JAX does (the
        rates, then the mask's seed)."""
        layout = batch["layout"]
        self.seq_dist.update(layout.mask.cpu().numpy())
        seq = self.tokenizer.encode(layout)["seq"].to(self.device)
        B, T = seq.shape
        # rng's float64 draws rounded to fp32, as jnp.asarray rounds them
        u = torch.from_numpy(rng.uniform(size=(B,)).astype(np.float32))
        ratio = mask_schedule(u, self.schedule).to(self.device)
        loss_mask = draw_loss_mask(ratio, T, int(rng.integers(2**31)))
        inputs = {"seq": torch.where(loss_mask, self.mask_id, seq),
                  "image": device_image(batch["image"], self.device)}
        return inputs, {"seq": seq, "loss_mask": loss_mask}

    def loss(self, inputs: dict, targets: dict) -> tuple[torch.Tensor, dict]:
        """Cross-entropy with smoothing 0.1 (0.9 on the target, 0.1 / V on every
        token) over the masked positions, divided by their count (at least 1; in a
        data-parallel step the global batch's, `parallel.rows`)."""
        logits = self.core(inputs["seq"], inputs["image"])
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        tgt_logp = logp.gather(-1, targets["seq"][..., None])[..., 0]
        per_tok = -(0.9 * tgt_logp + (0.1 / V) * logp.sum(-1))
        keep = targets["loss_mask"].float()
        nll = (per_tok * keep).sum() / rows.mean_denominator(keep.sum(), 1.0)
        return nll, {"nll_loss": nll}

    def build_condition(self, batch: dict, rng: np.random.Generator,
                        task: Optional[str] = None):
        """(condition, target layout) of `task` (default the generator's)."""
        task = self.task if task is None else normalize_task(task)
        return get_condition(batch["layout"], batch["image"], task, self.tokenizer, rng,
                             ids=batch.get("id"), retrieved=batch.get("retrieved"),
                             relationships=getattr(self, "relationships_table", None))

    @torch.inference_mode()
    def encode_memory(self, cond: Condition) -> torch.Tensor:
        return self.core.encode_memory(device_image(cond.image, self.device))

    def user_tokens(self, cond: Condition) -> tuple[torch.Tensor, torch.Tensor]:
        """(tokens [B, L], known [B, L]) the user gave; all PAD and none known
        for uncond."""
        B, L = cond.image.shape[0], self.tokenizer.max_token_length
        if cond.seq is None:
            return (torch.full((B, L), self.pad_id, dtype=torch.long, device=self.device),
                    torch.zeros((B, L), dtype=torch.bool, device=self.device))
        return (torch.as_tensor(np.asarray(cond.seq), device=self.device).long(),
                torch.as_tensor(np.asarray(cond.seq_mask), device=self.device).bool())

    def sample(self, cond: Condition, sampling: SamplingConfig,
               generator: Optional[torch.Generator] = None, return_tokens: bool = False):
        """Layouts (and tokens [B, L]) for a condition."""
        memory = self.encode_memory(cond)
        seq_user, known_user = self.user_tokens(cond)
        element_num_known = normalize_task(cond.task) in ("c", "cwh", "refinement")
        seq = self.unmask(memory, seq_user, known_user, sampling, generator,
                          self.num_timesteps, element_num_known)
        layout = self.tokenizer.decode(seq)
        return (layout, seq) if return_tokens else layout

    @torch.inference_mode()
    def unmask(self, memory: torch.Tensor, seq_user: torch.Tensor, known_user: torch.Tensor,
               sampling: SamplingConfig, generator: Optional[torch.Generator], T_steps: int,
               element_num_known: bool) -> torch.Tensor:
        """The T-step confidence-driven unmasking -> tokens [B, L]."""
        B, L = seq_user.shape
        V = self.token_mask.shape[1]
        invalid = ~self.token_mask[None]  # [1, L, V]
        if element_num_known:  # a position the user gave an element for is never PAD
            is_pad = torch.arange(V, device=self.device) == self.pad_id
            invalid = invalid | ((seq_user != self.pad_id)[:, :, None] & is_pad)
        n_free = (~known_user).sum(dim=1)
        seq = seq_user
        for t in range(T_steps):
            ratio = torch.full((B,), float(remask_rate(t, T_steps, self.schedule)),
                               device=self.device)
            is_masked = seq == self.mask_id
            logits = self.core.decoder(seq, memory, causal=False).float()
            logits = torch.where(invalid, NEG_INF, logits)
            seq_pred = sample(logits, sampling, generator)
            conf = torch.log_softmax(logits, dim=-1).gather(-1, seq_pred[..., None])[..., 0]
            if self.use_gumbel_noise:
                u = rows.draw(lambda shape: torch.rand(shape, generator=generator,
                                                       device=self.device), conf.shape)
                float_t = np.float32((t + 1) * float(np.float32(1.0) / np.float32(T_steps)))
                temp_t = float(np.float32(sampling.temperature) * (np.float32(1.0) - float_t))
                conf = conf + temp_t * -torch.log(-torch.log(u + 1e-30) + 1e-30)
            seq = torch.where(is_masked, seq_pred, seq)
            if t < T_steps - 1:
                topk = torch.clamp((n_free * ratio).to(torch.int32), min=1)
                unconfident, _ = batch_topk_mask(-conf, topk, mask=is_masked)
                seq = torch.where(unconfident, self.mask_id, seq)
            seq = torch.where(known_user, seq_user, seq)
        return seq
