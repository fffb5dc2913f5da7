"""CGL-GAN, the non-autoregressive transformer GAN baseline (and its
retrieval-augmented variant): the counterpart of `ralf_tpu/models/cgl_gan.py`
for sampling.

    memory = ImageEncoder(image + saliency, cgl FPN)               [B, M, D]
             (+ RetrievalAugmentation over the top-k neighbours)   [B, 2M+K, D]
    h      = PE1d(Conv1d + ReLU + MaxPool1d(packed init layout))   [B, S, D]
    h      = TransformerDecoder(h | memory, bidirectional)         [B, S, D]
    out    = fc_cls(h), sigmoid(fc_box(h))   (no bias, no head norm)

A sample is one forward pass.  Its randomness is host-side numpy, from the
caller's rng in JAX's order: the random initial layout (`random_init_layout`),
refinement's box noise, then one element permutation per row for every task
but `uncond`.  The task is the job's `auxiliary_task`, fixed at
construction.  The image encoder's self-attention takes K1 (6 launches at
the preset's 6 layers), the RA variant's FIDNet 4 more; the decoder's
self-attention has a [1, 1, S, S] zero bias and its cross-attention
unequal lengths, so both take the einsum path, as in JAX.

The discriminator and the losses are not ported yet (ROADMAP.md Queue A
item 14b).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.core.conditioning import normalize_task
from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.core.seq_length import SeqLengthDistribution
from ralf_tpu_torch.models.base import GeneratorConfig, build_core, device_image
from ralf_tpu_torch.models.gan_common import (
    pack_layout,
    random_init_layout,
    reorder,
    unpack_outputs,
)
from ralf_tpu_torch.models.nn import TransformerDecoder
from ralf_tpu_torch.models.positional import PositionalEncoding1D
from ralf_tpu_torch.models.ralf import RETRIEVED_KEYS, retrieved_tensors
from ralf_tpu_torch.models.resnet import ImageEncoder
from ralf_tpu_torch.models.retrieval_augment import RetrievalAugmentation
from ralf_tpu_torch.utils.device import resolve_device


class Conv1dLayoutEncoder(nn.Module):
    """Conv1d(k=3, same) + ReLU + MaxPool1d(3, stride 1, same) over the
    packed layout [B, S, 2, K] flattened to 2K channels -> [B, S, C]."""

    def __init__(self, in_channels: int, out_channels: int = 256) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels, out_channels, 3, padding=1)

    def forward(self, packed: torch.Tensor) -> torch.Tensor:
        B, S = packed.shape[:2]
        x = packed.reshape(B, S, -1).to(self.Conv_0.weight.dtype).transpose(1, 2)
        x = F.max_pool1d(F.relu(self.Conv_0(x)), 3, stride=1, padding=1)
        return x.transpose(1, 2)


class CGLGeneratorCore(nn.Module):
    def __init__(self, num_classes_total: int, cfg: GeneratorConfig = GeneratorConfig(),
                 with_retrieval: bool = False, num_labels: int = 3, max_seq_length: int = 10,
                 top_k: int = 16) -> None:
        super().__init__()
        self.with_retrieval = with_retrieval
        self.encoder = ImageEncoder(cfg.backbone, cfg.d_model, cfg.nhead, cfg.num_encoder_layers,
                                    2048, cfg.dropout, fpn_style="cgl")
        self.layout_encoder = Conv1dLayoutEncoder(2 * num_classes_total, cfg.d_model)
        self.pos_emb_1d = PositionalEncoding1D(cfg.d_model, cfg.dropout)
        self.decoder = TransformerDecoder(cfg.d_model, 8, cfg.num_decoder_layers, 2048,
                                          cfg.dropout)
        self.fc_cls = nn.Linear(cfg.d_model, num_classes_total, bias=False)
        self.fc_box = nn.Linear(cfg.d_model, 4, bias=False)
        if with_retrieval:
            self.retrieval_aug = RetrievalAugmentation(num_labels, max_seq_length, cfg.d_model,
                                                       top_k, cfg.dropout)

    def forward(self, image: torch.Tensor, packed_layout: torch.Tensor,
                retrieved: Optional[dict] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(class logits [B, S, K], boxes [B, S, 4] in (0, 1))."""
        memory = self.encoder(image)
        if self.with_retrieval:
            memory = self.retrieval_aug(memory, retrieved)
        h = self.pos_emb_1d(self.layout_encoder(packed_layout))
        h = self.decoder(h, memory, causal=False)
        return self.fc_cls(h), torch.sigmoid(self.fc_box(h))


class CGLGANGenerator:
    """The host-side conditioning and the one-pass sampler around
    `CGLGeneratorCore`.  Weights are random from `seed` until
    `utils.weights.load_jax_params` fills `self.core`; `device` defaults to
    the card and raises when there is none."""

    def __init__(self, num_labels: int, cfg: GeneratorConfig = GeneratorConfig(),
                 auxiliary_task: Optional[str] = "uncond", max_seq_length: int = 10,
                 image_hw: tuple[int, int] = (350, 240), with_retrieval: bool = False,
                 top_k: int = 16, use_reorder: bool = False, use_seq_dist: bool = False, *,
                 device="cuda", seed: int = 0) -> None:
        self.device = resolve_device(device)
        self.num_labels = num_labels
        self.K = num_labels + 1  # + no-object
        self.cfg = cfg
        self.task = normalize_task(auxiliary_task)
        self.S = max_seq_length
        self.image_hw = image_hw
        self.with_retrieval = with_retrieval
        self.top_k = top_k
        self.use_reorder = use_reorder
        self.tokenizer = None  # continuous outputs
        # the element-count EMA, always tracked; with use_seq_dist, uncond
        # inits start the positions past a drawn count as the no-object class
        self.use_seq_dist = use_seq_dist
        self.seq_dist = SeqLengthDistribution(max_seq_length)
        self.coef = tuple([1.0] * self.K)
        self.core = build_core(self._make_core, cfg, self.device, seed)

    def _make_core(self) -> nn.Module:
        return CGLGeneratorCore(self.K, self.cfg, self.with_retrieval, self.num_labels, self.S,
                                self.top_k)

    def preprocess(self, batch: dict, rng: np.random.Generator) -> tuple[dict, dict]:
        """(inputs, targets) of a batch, numpy: the random initial layout
        with the task's part of the ground truth in it, and the packed
        ground truth (reordered with use_reorder)."""
        layout: Layout = batch["layout"]
        target_packed = pack_layout(layout, self.K)
        if self.use_reorder:
            target_packed = self._reorder_packed(target_packed)
        self.seq_dist.update(layout.mask.cpu().numpy())
        n_elements = (self.seq_dist.sample(rng, target_packed.shape[0])
                      if self.use_seq_dist and self.task == "uncond" else None)
        init = random_init_layout(rng, target_packed.shape[0], self.S, self.K, self.coef,
                                  n_elements=n_elements)
        init = self._condition_init(init, target_packed, rng)
        inputs = {"image": batch["image"], "layout": init}
        if self.with_retrieval:
            if "retrieved" not in batch:
                raise ValueError("a retrieval-augmented GAN needs the batch's retrieved layouts")
            inputs["retrieved"] = {k: np.asarray(batch["retrieved"][k]) for k in RETRIEVED_KEYS}
        targets = {
            "packed": target_packed,
            "labels": target_packed[:, :, 0].argmax(-1).astype(np.int64),
            "boxes": target_packed[:, :, 1].astype(np.float32),
        }
        return inputs, targets

    def _reorder_packed(self, packed: np.ndarray) -> np.ndarray:
        out = packed.copy()
        # PosterLayout's class mapping: PKU (text, logo, underlay + bg); CGL
        # (embellishment, logo, text, underlay + bg)
        mapping = np.asarray([1, 2, 3, 0]) if self.K == 4 else np.asarray([3, 2, 1, 3, 0])[: self.K]
        for b in range(out.shape[0]):
            order = reorder(mapping[out[b, :, 0].argmax(-1)], out[b, :, 1, :4], self.S)
            order = order + [i for i in range(self.S) if i not in order]
            out[b] = out[b, order[: self.S]]
        return out

    def _condition_init(self, init: np.ndarray, target: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
        """Copy the task's part of the ground truth into the random init,
        then shuffle each row's elements.  cwh and partial copy box columns
        2:4 (width, height of cxcywh), as JAX does, where the reference
        copies 0:2."""
        task = self.task
        label_gt, box_gt = target[:, :, 0], target[:, :, 1]
        if task == "c":
            init[:, :, 0] = label_gt
        elif task == "cwh":
            init[:, :, 0] = label_gt
            init[:, :, 1, 2:4] = box_gt[:, :, 2:4]
        elif task == "partial":
            init[:, 0, 0] = label_gt[:, 0]
            init[:, 0, 1, 2:4] = box_gt[:, 0, 2:4]
        elif task == "refinement":
            noise = rng.normal(0, 0.01, box_gt.shape).astype(np.float32)
            pad = box_gt.sum(-1) == 0.0
            noisy = np.clip(box_gt + noise, 0.0, 1.0)
            noisy[pad] = 0.0
            init = np.stack([label_gt, noisy], axis=2)
        if task != "uncond":
            for b in range(init.shape[0]):
                init[b] = init[b, rng.permutation(self.S)]
        return init.astype(np.float32)

    @torch.inference_mode()
    def _forward(self, inputs: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The core on `preprocess`'s inputs: (class logits, boxes)."""
        image = device_image(inputs["image"], self.device)
        packed = torch.as_tensor(inputs["layout"], device=self.device)
        retrieved = None
        if self.with_retrieval:
            retrieved = retrieved_tensors(inputs["retrieved"], self.device)
        return self.core(image, packed, retrieved)

    def sample(self, batch: dict, rng: np.random.Generator) -> Layout:
        """Layouts for a batch (its image, ground-truth layout and, with
        retrieval, neighbours), the initial layout drawn from `rng`."""
        inputs, _ = self.preprocess(batch, rng)
        return unpack_outputs(*self._forward(inputs), self.K)
