"""CGL-GAN, the non-autoregressive transformer GAN baseline (and its
retrieval-augmented variant): the counterpart of `ralf_tpu/models/cgl_gan.py`.

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

Training (`train.gan_trainer.GANTrainer`) adds the discriminator, built by
`init_disc` when training asks for it (serving builds none):

    packed = straight-through argmax(packed layout)   (the class row one-hot)
    memory = ImageEncoder(image, resnet18, 4 layers, FFN 2048, cgl FPN)
    h      = TransformerDecoder(PE1d(Conv1d(packed)) | memory), 4 layers
    logit  = tanh(head(head_norm(h flattened to [B, S * D])))   (head: no bias)

The generator's loss is the Hungarian-matched 2 CE + 5 L1 + 2 gIoU, plus
`adv_weight` times the hinge of the discriminator (in eval mode, its
parameters not differentiated) on the packed prediction; the
discriminator's is `adv_weight` times the hinges of its fake pass (the
generator's prediction in eval mode, under no_grad) and its real pass
(the packed ground truth), both in train mode.  The BatchNorm statistics
it keeps are the real pass's update of those before the step, and both
passes draw the same dropout masks, as JAX's `disc_loss` gives them.  In
the generator step the discriminator's image encoder takes K1 (4
launches); in the discriminator step the generator's does (6) and the RA
variant's FIDNet (4).
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
from ralf_tpu_torch.models.base import GeneratorConfig, build_core, compute_dtype, device_image
from ralf_tpu_torch.models.gan_common import (
    hinge_embedding_loss,
    pack_layout,
    random_init_layout,
    reorder,
    set_criterion,
    straight_through_argmax,
    unpack_outputs,
)
from ralf_tpu_torch.models.nn import TransformerDecoder, layer_norm
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
        x = packed.reshape(B, S, -1).to(compute_dtype(self.Conv_0.weight)).transpose(1, 2)
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


class CGLDiscriminatorCore(nn.Module):
    """The scalar critic in (-1, 1) of a packed layout on its canvas."""

    def __init__(self, num_classes_total: int, cfg: GeneratorConfig = GeneratorConfig(),
                 max_seq_length: int = 10) -> None:
        super().__init__()
        self.encoder = ImageEncoder("resnet18", cfg.d_model, cfg.nhead, 4, 2048, cfg.dropout,
                                    fpn_style="cgl")
        self.layout_encoder = Conv1dLayoutEncoder(2 * num_classes_total, cfg.d_model)
        self.pos_emb_1d = PositionalEncoding1D(cfg.d_model, cfg.dropout)
        self.decoder = TransformerDecoder(cfg.d_model, 8, 4, 2048, cfg.dropout)
        self.head_norm = layer_norm(max_seq_length * cfg.d_model)
        self.head = nn.Linear(max_seq_length * cfg.d_model, 1, bias=False)

    def forward(self, image: torch.Tensor, packed_layout: torch.Tensor) -> torch.Tensor:
        """[B] critic values."""
        packed_layout = straight_through_argmax(packed_layout)
        memory = self.encoder(image)
        h = self.pos_emb_1d(self.layout_encoder(packed_layout))
        h = self.decoder(h, memory, causal=False)
        return torch.tanh(self.head(self.head_norm(h.reshape(h.shape[0], -1))))[:, 0]


def pack_prediction(logits: torch.Tensor, boxes: torch.Tensor, K: int) -> torch.Tensor:
    """The heads' outputs as a packed layout [B, S, 2, K]: the class row,
    then the boxes zero-padded to K."""
    return torch.stack([logits, F.pad(boxes, (0, K - 4))], dim=2)


def _snapshot(module: nn.Module):
    """A function that puts back `module`'s BatchNorm statistics and the
    states of its dropout generators as they are now."""
    buffers = {n: b for n, b in module.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    stats = {n: b.clone() for n, b in buffers.items()}
    gens = {id(m.generator): m.generator for m in module.modules()
            if getattr(m, "generator", None) is not None}
    states = {k: g.get_state() for k, g in gens.items()}

    def restore() -> None:
        with torch.no_grad():
            for n, b in stats.items():
                buffers[n].copy_(b)
        for k, g in gens.items():
            g.set_state(states[k])
    return restore


class CGLGANGenerator:
    """The host-side conditioning and the one-pass sampler around
    `CGLGeneratorCore`, and the losses of both nets.  Weights are random
    from `seed` until `utils.weights.load_jax_params` fills `self.core`;
    `device` defaults to the card and raises when there is none."""

    LR_MULT_DIS = 10.0  # the discriminator's base LR against the generator's
    FP32_TRAINING_ONLY = False  # GANTrainer refuses another model.dtype if set (DS-GAN)

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
        self.adv_weight = 1.0
        self.seed = seed
        self.core = build_core(self._make_core, cfg, self.device, seed)
        self.disc: Optional[nn.Module] = None  # built by init_disc

    def _make_core(self) -> nn.Module:
        return CGLGeneratorCore(self.K, self.cfg, self.with_retrieval, self.num_labels, self.S,
                                self.top_k)

    def _make_disc(self) -> nn.Module:
        return CGLDiscriminatorCore(self.K, self.cfg, self.S)

    def init_disc(self) -> nn.Module:
        """Build the discriminator (random weights from the generator's seed
        + 1) as `self.disc`, in eval mode."""
        self.disc = build_core(self._make_disc, self.cfg, self.device, self.seed + 1)
        return self.disc

    def update_per_epoch(self, epoch: int, warmup: int, max_epoch: int) -> None:
        """The adversarial weight of an epoch: 0 before `warmup`, then a
        linear ramp to 1 at `max_epoch`."""
        if epoch < warmup:
            self.adv_weight = 0.0
        elif epoch <= max_epoch:
            self.adv_weight = (epoch - warmup) / max(max_epoch - warmup, 1)
        else:
            self.adv_weight = 1.0

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

    def device_batch(self, inputs: dict, targets: dict) -> tuple[dict, dict]:
        """`preprocess`'s numpy (inputs, targets) as tensors on the device
        (the targets given)."""
        out = {"image": device_image(inputs["image"], self.device),
               "layout": torch.as_tensor(inputs["layout"], device=self.device)}
        if self.with_retrieval:
            out["retrieved"] = retrieved_tensors(inputs["retrieved"], self.device)
        dtypes = {"packed": torch.float32, "labels": torch.int64, "boxes": torch.float32}
        return out, {k: torch.as_tensor(targets[k], device=self.device).to(dt)
                     for k, dt in dtypes.items() if k in targets}

    def _core(self, inputs: dict) -> tuple[torch.Tensor, torch.Tensor]:
        return self.core(inputs["image"], inputs["layout"], inputs.get("retrieved"))

    @torch.inference_mode()
    def _forward(self, inputs: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The core on `preprocess`'s inputs: (class logits, boxes)."""
        return self._core(self.device_batch(inputs, {})[0])

    # ---- losses (`device_batch`'s tensors) ----------------------------------------

    def criterion(self, logits: torch.Tensor, boxes: torch.Tensor, targets: dict):
        """(the reconstruction loss, its terms and the assignment)."""
        empty_w = torch.tensor(self.coef, dtype=torch.float32, device=logits.device)
        terms = set_criterion(logits, boxes, targets["labels"], targets["boxes"], empty_w, self.K)
        weights = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0}
        return sum(terms[k] * w for k, w in weights.items()), terms

    def loss(self, inputs: dict, targets: dict,
             disc: Optional[nn.Module] = None) -> tuple[torch.Tensor, dict]:
        """The generator's loss (the core in its caller's mode) and its
        terms; with `disc` (in eval mode, its parameters not requiring
        grad) also adv_weight times the hinge of its critic of the packed
        prediction against the real label."""
        logits, boxes = self._core(inputs)
        total, aux = self.criterion(logits, boxes, targets)
        if disc is not None:
            fake = disc(inputs["image"], pack_prediction(logits, boxes, self.K))
            adv = hinge_embedding_loss(fake, torch.ones_like(fake))
            total = total + adv * self.adv_weight
            aux["adv_fake"] = adv
        aux["nll_loss"] = total
        return total, aux

    def disc_loss(self, inputs: dict, targets: dict) -> tuple[torch.Tensor, dict]:
        """The discriminator's loss, `self.disc` in train mode: adv_weight
        times (the hinge of its fake pass against -1 + that of its real pass
        against +1).  The generator's prediction (the core in its caller's
        mode, eval in the trainer) runs under no_grad.  The statistics kept
        are the real pass's update of those before the call, and both passes
        draw the same dropout masks."""
        with torch.no_grad():
            packed_pred = pack_prediction(*self._core(inputs), self.K)
        restore = _snapshot(self.disc)
        fake = self.disc(inputs["image"], packed_pred)
        restore()
        real = self.disc(inputs["image"], targets["packed"])
        loss_fake = hinge_embedding_loss(fake, -torch.ones_like(fake))
        loss_real = hinge_embedding_loss(real, torch.ones_like(real))
        total = (loss_fake + loss_real) * self.adv_weight
        return total, {"adv_fake": loss_fake, "adv_real": loss_real}

    def sample(self, batch: dict, rng: np.random.Generator) -> Layout:
        """Layouts for a batch (its image, ground-truth layout and, with
        retrieval, neighbours), the initial layout drawn from `rng`."""
        inputs, _ = self.preprocess(batch, rng)
        return unpack_outputs(*self._forward(inputs), self.K)
