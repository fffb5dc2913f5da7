"""The autoregressive layout generator (the plain `autoreg` family), the
counterpart of `ralf_tpu/models/autoreg.py`:

    memory = concat[ImageEncoder(image + saliency) + flag_0,
                    ConstraintEncoder(constraint sequence) + flag_1]
    logits = TokenDecoder(layout tokens | memory, causal)

`AutoregGenerator` is the shell every AR generator shares: it turns a batch
into a `Condition` (any task of `COND_TYPES`, or a multitask draw), encodes
it, and runs the KV-cached constrained decode, or for `relation` the
decode with retries (`ops/relation_decode.py`).  For training it turns a
batch into the teacher-forced tensors (`preprocess`) and gives the
label-smoothed cross-entropy of the core's logits (`loss`), in the core's
mode: `train.trainer.Trainer` sets it.  `RALFGenerator` (models/ralf.py)
supplies its own core.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.core.conditioning import (
    Condition,
    ConstraintVocabulary,
    build_constraint_sequence,
    build_forced_tokens,
    get_condition,
    normalize_task,
)
from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.core.sampling import SamplingConfig
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer
from ralf_tpu_torch.models.base import GeneratorConfig, build_core, device_image
from ralf_tpu_torch.models.nn import TokenDecoder, TransformerEncoder
from ralf_tpu_torch.models.positional import PositionalEncoding1D
from ralf_tpu_torch.models.resnet import ImageEncoder
from ralf_tpu_torch.ops.decode_loop import ar_decode
from ralf_tpu_torch.ops.relation_decode import build_relation_tensors, relation_aware_decode
from ralf_tpu_torch.parallel import rows
from ralf_tpu_torch.utils import tracing
from ralf_tpu_torch.utils.device import resolve_device


class ConstraintEncoder(nn.Module):
    """Embedding + 1-d PE + pre-LN encoder over the serialized constraint."""

    def __init__(self, vocab_size: int, d_model: int = 256, nhead: int = 8,
                 num_layers: int = 6, dim_feedforward: int = 1024, dropout: float = 0.1) -> None:
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, d_model)
        self.pos_emb = PositionalEncoding1D(d_model, dropout)
        self.TransformerEncoder_0 = TransformerEncoder(d_model, nhead, num_layers, dim_feedforward,
                                                       dropout=dropout)

    def forward(self, seq: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        return self.TransformerEncoder_0(self.pos_emb(self.Embed_0(seq)), keep=keep)


class AutoregCore(nn.Module):
    """Image encoder + constraint encoder + two flag scalars + token decoder."""

    def __init__(self, vocab_size: int, const_vocab_size: int,
                 cfg: GeneratorConfig = GeneratorConfig()) -> None:
        super().__init__()
        d = cfg.d_model
        self.encoder = ImageEncoder(cfg.backbone, d, cfg.nhead, cfg.num_encoder_layers,
                                    cfg.dim_feedforward, cfg.dropout)
        self.const_encoder = ConstraintEncoder(const_vocab_size, d, cfg.nhead,
                                               cfg.num_encoder_layers, cfg.dim_feedforward,
                                               cfg.dropout)
        self.flag_emb = nn.Parameter(torch.randn(2, 1) * 0.02)  # image rows / constraint rows
        self.decoder = TokenDecoder(vocab_size, d, cfg.nhead, cfg.num_decoder_layers,
                                    cfg.dim_feedforward, cfg.dropout)

    def encode_memory(self, image: torch.Tensor, const_seq: torch.Tensor,
                      const_keep: torch.Tensor) -> torch.Tensor:
        """[B, H'W' + Lc, D]; the decoder attends every row, padded constraint
        rows included, as the reference does."""
        img_mem = self.encoder(image)
        const_mem = self.const_encoder(const_seq, const_keep)
        flag = self.flag_emb.to(img_mem.dtype)
        return torch.cat([img_mem + flag[0], const_mem + flag[1]], dim=1)

    def forward(self, seq: torch.Tensor, image: torch.Tensor, const_seq: torch.Tensor,
                const_keep: torch.Tensor, tgt_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced logits [B, S, V] of the causal decoder."""
        memory = self.encode_memory(image, const_seq, const_keep)
        return self.decoder(seq, memory, tgt_keep=tgt_keep, causal=True)


def smoothed_ce_loss(logits: torch.Tensor, targets: torch.Tensor, ignore_id: int,
                     smoothing: float = 0.1) -> torch.Tensor:
    """torch's CrossEntropyLoss(label_smoothing, ignore_index) as JAX writes
    it: the mean over non-ignored positions of -(1 - s) log p_target -
    (s / V) sum log p, in fp32.  In a data-parallel step the count of
    non-ignored positions is the global batch's (`parallel.rows`)."""
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt_logp = logp.gather(-1, targets[..., None].long())[..., 0]
    loss = -((1.0 - smoothing) * tgt_logp + (smoothing / V) * logp.sum(dim=-1))
    keep = (targets != ignore_id).float()
    return (loss * keep).sum() / rows.mean_denominator(keep.sum(), 1.0)


class AutoregGenerator:
    """Host-side conditioning + the decode around a core module that has a
    `decoder` (TokenDecoder); subclasses define `_build_core` and
    `encode_memory` for their core.

    Weights are random from `seed` until `utils.weights.load_jax_params`
    fills `self.core`.  `device` defaults to the card and raises when there
    is none; pass device='cpu' for the plain path."""

    # auxiliary_task='multitask' draws a task per batch with these weights
    MULTITASK_CHOICES = ("uncond", "c", "cwh", "partial", "refinement", "relation")
    MULTITASK_WEIGHTS = (1 / 12, 1 / 3, 1 / 3, 1 / 12, 1 / 3, 1 / 12)

    def __init__(self, tokenizer: LayoutSequenceTokenizer,
                 cfg: GeneratorConfig = GeneratorConfig(),
                 auxiliary_task: Optional[str] = "uncond",
                 image_hw: tuple[int, int] = (350, 240), *,
                 device="cuda", seed: int = 0) -> None:
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.multitask = auxiliary_task == "multitask"
        self.task = normalize_task(None if self.multitask else auxiliary_task)
        self.vocab = ConstraintVocabulary(tokenizer)
        self.image_hw = image_hw
        # optional precomputed {str(id): clause list} table of the relations
        self.relationships_table: Optional[dict] = None
        self.core = build_core(self._build_core, cfg, self.device, seed)
        self.token_mask = torch.as_tensor(tokenizer.token_mask, device=self.device)

    def _build_core(self) -> nn.Module:
        return AutoregCore(self.tokenizer.N_total, self.vocab.N_total, self.cfg)

    def _image(self, cond: Condition) -> torch.Tensor:
        return device_image(cond.image, self.device)

    def _constraint(self, cond: Condition) -> tuple[torch.Tensor, torch.Tensor]:
        tracing.count_h2d(cond.const_seq)
        tracing.count_h2d(cond.const_mask)
        return (torch.as_tensor(cond.const_seq, device=self.device).long(),
                torch.as_tensor(cond.const_mask, device=self.device))

    @torch.inference_mode()
    def encode_memory(self, cond: Condition) -> torch.Tensor:
        with tracing.span("gen.encode", device=self.device.type == "cuda"):
            return self.core.encode_memory(self._image(cond), *self._constraint(cond))

    def preprocess(self, batch: dict, rng: np.random.Generator) -> tuple[dict, dict]:
        """Training-side: the condition and the teacher-forced decoder
        tensors on the generator's device, drawing from `rng` as JAX does."""
        cond, target = self.build_condition(batch, rng)
        enc = self.tokenizer.encode(target)
        seq, mask = enc["seq"].to(self.device), enc["mask"].to(self.device)
        const_seq, const_keep = self._constraint(cond)
        inputs = {"seq": seq[:, :-1], "tgt_keep": mask[:, :-1], "image": self._image(cond),
                  "const_seq": const_seq, "const_keep": const_keep}
        return inputs, {"seq": seq[:, 1:]}

    def logits(self, inputs: dict) -> torch.Tensor:
        return self.core(inputs["seq"], inputs["image"], inputs["const_seq"],
                         inputs["const_keep"], inputs["tgt_keep"])

    def loss(self, inputs: dict, targets: dict) -> tuple[torch.Tensor, dict]:
        """(the smoothed CE, {'nll_loss': it}) of the core in its current mode."""
        nll = smoothed_ce_loss(self.logits(inputs), targets["seq"], self.tokenizer.pad_id,
                               self.cfg.label_smoothing)
        return nll, {"nll_loss": nll}

    def build_condition(self, batch: dict, rng: np.random.Generator,
                        task: Optional[str] = None) -> tuple[Condition, Layout]:
        """batch: {'layout': Layout, 'image': [B, H, W, 4], optional 'id',
        'retrieved'}; the numpy `rng` draws what the task samples."""
        if task is None and self.multitask:
            w = np.asarray(self.MULTITASK_WEIGHTS)
            task = rng.choice(self.MULTITASK_CHOICES, p=w / w.sum())
        task = self.task if task is None else normalize_task(task)
        with tracing.span("gen.condition"):
            cond, target = get_condition(batch["layout"], batch["image"], task, self.tokenizer,
                                         rng, ids=batch.get("id"), retrieved=batch.get("retrieved"),
                                         relationships=self.relationships_table)
            cond.const_seq, cond.const_mask = build_constraint_sequence(cond, self.vocab, rng)
        return cond, target

    @torch.inference_mode()
    def decode(self, memory: torch.Tensor, forced, sampling: SamplingConfig,
               generator: Optional[torch.Generator] = None, kv_quant: bool = False,
               self_quant: bool = False, q8_mxu: bool = False) -> torch.Tensor:
        """The KV-cached constrained decode -> tokens [B, 5S] on the device."""
        tok = self.tokenizer
        forced = np.asarray(forced)
        tracing.count_h2d(forced)
        return ar_decode(
            self.core.decoder, memory, None, self.token_mask,
            torch.as_tensor(forced, device=self.device),
            tok.max_token_length, tok.bos_id, tok.pad_id, sampling, generator,
            kv_quant=kv_quant, self_quant=self_quant, q8_mxu=q8_mxu,
        )

    def sample(self, cond: Condition, sampling: SamplingConfig,
               generator: Optional[torch.Generator] = None, return_tokens: bool = False,
               use_backtrack: bool = True, max_retries: int = 8, kv_quant: bool = False,
               self_quant: bool = False, q8_mxu: bool = False):
        """Layouts (and tokens) for a condition; `relation` with backtracking
        takes the decode with retries."""
        memory = self.encode_memory(cond)
        forced = build_forced_tokens(cond, self.tokenizer)
        if normalize_task(cond.task) == "relation" and use_backtrack:
            seq = relation_aware_decode(
                self.core.decoder, memory, self.tokenizer,
                torch.as_tensor(forced, device=self.device),
                build_relation_tensors(cond, self.tokenizer.max_seq_length),
                sampling, generator, max_retries=max_retries, kv_quant=kv_quant,
                self_quant=self_quant, q8_mxu=q8_mxu,
            )
        else:
            seq = self.decode(memory, forced, sampling, generator, kv_quant, self_quant, q8_mxu)
        layout = self.tokenizer.decode(seq)
        return (layout, seq) if return_tokens else layout
