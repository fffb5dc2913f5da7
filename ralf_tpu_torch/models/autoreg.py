"""Autoregressive generator protocol, the counterpart of
`ralf_tpu/models/autoreg.py`: the constraint encoder, and the generator
shell that turns a batch into a `Condition`, encodes it and runs the
KV-cached decode.  `RALFGenerator` (models/ralf.py) supplies the core; the
plain autoreg family's core is not ported.
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
from ralf_tpu_torch.models.base import GeneratorConfig
from ralf_tpu_torch.models.nn import TransformerEncoder
from ralf_tpu_torch.models.positional import PositionalEncoding1D
from ralf_tpu_torch.ops.decode_loop import ar_decode
from ralf_tpu_torch.utils.device import resolve_device


class ConstraintEncoder(nn.Module):
    """Embedding + 1-d PE + pre-LN encoder over the serialized constraint."""

    def __init__(self, vocab_size: int, d_model: int = 256, nhead: int = 8,
                 num_layers: int = 6, dim_feedforward: int = 1024) -> None:
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, d_model)
        self.pos_emb = PositionalEncoding1D(d_model)
        self.TransformerEncoder_0 = TransformerEncoder(d_model, nhead, num_layers, dim_feedforward)

    def forward(self, seq: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        return self.TransformerEncoder_0(self.pos_emb(self.Embed_0(seq)), keep=keep)


class AutoregGenerator:
    """Host-side conditioning + the decode around a core module that has
    `encode_memory` and a `decoder` (TokenDecoder).

    Weights are random from `seed` until `utils.weights.load_jax_params`
    fills `self.core`.  `device` defaults to the card and raises when there
    is none; pass device='cpu' for the plain path."""

    def __init__(self, tokenizer: LayoutSequenceTokenizer,
                 cfg: GeneratorConfig = GeneratorConfig(),
                 auxiliary_task: Optional[str] = "uncond",
                 image_hw: tuple[int, int] = (350, 240), *,
                 device="cuda", seed: int = 0) -> None:
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.task = normalize_task(auxiliary_task)
        self.vocab = ConstraintVocabulary(tokenizer)
        self.vocab.const_len(self.task)  # raises for a task that is not ported
        self.image_hw = image_hw
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            core = self._build_core()
        self.core = core.to(device=self.device, dtype=cfg.dtype or torch.float32).eval()
        self.core.requires_grad_(False)
        self.token_mask = torch.as_tensor(tokenizer.token_mask, device=self.device)

    def _build_core(self) -> nn.Module:
        raise NotImplementedError

    def encode_memory(self, cond: Condition) -> torch.Tensor:
        raise NotImplementedError

    def build_condition(self, batch: dict, task: Optional[str] = None
                        ) -> tuple[Condition, Layout]:
        """batch: {'layout': Layout, 'image': [B, H, W, 4], optional 'id', 'retrieved'}."""
        task = self.task if task is None else normalize_task(task)
        cond, target = get_condition(batch["layout"], batch["image"], task,
                                     ids=batch.get("id"), retrieved=batch.get("retrieved"))
        cond.const_seq, cond.const_mask = build_constraint_sequence(cond, self.vocab)
        return cond, target

    @torch.inference_mode()
    def decode(self, memory: torch.Tensor, forced, sampling: SamplingConfig,
               generator: Optional[torch.Generator] = None, kv_quant: bool = False,
               self_quant: bool = False) -> torch.Tensor:
        """The KV-cached constrained decode -> tokens [B, 5S] on the device."""
        tok = self.tokenizer
        return ar_decode(
            self.core.decoder, memory, None, self.token_mask,
            torch.as_tensor(np.asarray(forced), device=self.device),
            tok.max_token_length, tok.bos_id, tok.pad_id, sampling, generator,
            kv_quant=kv_quant, self_quant=self_quant,
        )

    def sample(self, cond: Condition, sampling: SamplingConfig,
               generator: Optional[torch.Generator] = None, return_tokens: bool = False,
               kv_quant: bool = False, self_quant: bool = False):
        memory = self.encode_memory(cond)
        forced = build_forced_tokens(cond, self.tokenizer)
        seq = self.decode(memory, forced, sampling, generator, kv_quant, self_quant)
        layout = self.tokenizer.decode(seq)
        return (layout, seq) if return_tokens else layout
