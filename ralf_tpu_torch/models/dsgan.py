"""DS-GAN, the CNN-LSTM GAN baseline from PosterLayout (and its
retrieval-augmented variant): the counterpart of `ralf_tpu/models/dsgan.py`.

    c0     = Dense_hw->2L(ResNetFPN(image, ralf FPN) as [B, D, h*w]) [B, 2L, D]
             (+ RetrievalAugmentation, its first 2L rows)
    x      = MaxPool1d(ReLU(Conv1d(packed init layout)))           [B, S, 32]
    out    = 4-layer bidirectional LSTM(x; h0 = 0, c0)             [B, S, 2D]
    labels = softmax(fc_cls(out)), boxes = sigmoid(fc_box(out))

The image enters as the LSTM's initial cell state, h0 zero: flax's carry
(c, h) indexed [B, 2 * layer + direction] is torch's (h0 = 0, c0) with c0
transposed to [2L, B, D].  The LSTM is `nn.LSTM` (cuDNN on the card; a
library call in both packages, not a ported kernel).  It runs in fp32
whatever the model's dtype: flax's cells carry no dtype, so they compute in
the fp32 of their parameters.  The FPN map flattens in (h, w) row-major
order before the Dense over its h*w positions (330 at 350x240).

DS-GAN trains in fp32 only: JAX's cannot be built at model.dtype=bfloat16
(the initial carry comes from a bf16 Dense, the fp32 cells return an fp32
one, and flax's scan refuses the change), so `GANTrainer` refuses another
dtype (`FP32_TRAINING_ONLY`), as JAX's `init` raises.

DS-GAN reorders its ground truth by the IoU-grouping order by default
(`use_reorder=True`) and draws its random classes from `DS_COEF`.  Its
image path takes no K1; the RA variant's FIDNet takes 4 launches.

The discriminator (`init_disc`, for training) is

    c0    = ImageToLSTMState(image, resnet18, 2 layers)             [B, 4, D]
    out   = CNNLSTM(straight-through argmax(packed); c0), 2 layers  [B, S, 2D]
    logit = tanh(fc_tf(out[:, -1]))                                 [B]

Its LSTM stays in train mode whatever the discriminator's mode: the
generator step backpropagates through the discriminator in eval mode, and
cuDNN's RNN backward runs in training mode only.  The LSTM has no dropout,
so the mode changes nothing of its numbers; its BatchNorms follow the
discriminator's mode.  The generator's loss is the unweighted CE + L1 +
gIoU plus `adv_weight` times the adversarial hinge (`apply_weight` False),
and the adversarial weight ramps as (epoch - 1) / warmup, 1 after it.  The
class head's softmax probabilities go into the criterion as its logits
(it takes their softmax and log-softmax once more), as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.models.base import GeneratorConfig
from ralf_tpu_torch.models.cgl_gan import CGLGANGenerator
from ralf_tpu_torch.models.gan_common import DS_COEF, straight_through_argmax
from ralf_tpu_torch.models.resnet import ResNetFPNEncoder
from ralf_tpu_torch.models.retrieval_augment import RetrievalAugmentation


class CNNLSTM(nn.Module):
    """Conv1d + ReLU + MaxPool1d + the bidirectional LSTM (`BiLSTM_0`, the
    flax cells `l{layer}_d{d}`)."""

    def __init__(self, in_channels: int, conv_channels: int = 32, d_model: int = 256,
                 num_lstm_layers: int = 4) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels, conv_channels, 3, padding=1)
        self.BiLSTM_0 = nn.LSTM(conv_channels, d_model, num_layers=num_lstm_layers,
                                bidirectional=True, batch_first=True)

    def forward(self, packed: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
        """packed [B, S, 2, K], c0 [B, 2L, D] -> [B, S, 2D] fp32."""
        B, S = packed.shape[:2]
        x = packed.reshape(B, S, -1).to(self.Conv_0.weight.dtype).transpose(1, 2)
        x = F.max_pool1d(F.relu(self.Conv_0(x)), 3, stride=1, padding=1).transpose(1, 2)
        c = c0.transpose(0, 1).float().contiguous()
        self.BiLSTM_0.flatten_parameters()  # one cuDNN weight buffer after a move or cast
        out, _ = self.BiLSTM_0(x.float(), (torch.zeros_like(c), c))
        return out


class ImageToLSTMState(nn.Module):
    """ResNet-FPN map [B, h, w, D] -> the initial cell states [B, 2L, D] by
    a Dense over the h*w positions."""

    def __init__(self, backbone: str = "resnet50", d_model: int = 256, num_lstm_layers: int = 4,
                 image_hw: tuple[int, int] = (350, 240)) -> None:
        super().__init__()
        self.ResNetFPNEncoder_0 = ResNetFPNEncoder(backbone, d_model, fpn_style="ralf")
        positions = -(-image_hw[0] // 16) * -(-image_hw[1] // 16)  # the stride-16 map
        self.Dense_0 = nn.Linear(positions, 2 * num_lstm_layers)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        fmap = self.ResNetFPNEncoder_0(image)
        B, H, W, D = fmap.shape
        return self.Dense_0(fmap.reshape(B, H * W, D).transpose(1, 2)).transpose(1, 2)


class DSGeneratorCore(nn.Module):
    def __init__(self, num_classes_total: int, cfg: GeneratorConfig = GeneratorConfig(),
                 with_retrieval: bool = False, num_labels: int = 3, max_seq_length: int = 10,
                 top_k: int = 16, image_hw: tuple[int, int] = (350, 240),
                 conv_channels: int = 32, num_lstm_layers: int = 4) -> None:
        super().__init__()
        self.with_retrieval = with_retrieval
        self.encoder = ImageToLSTMState(cfg.backbone, cfg.d_model, num_lstm_layers, image_hw)
        self.cnnlstm = CNNLSTM(2 * num_classes_total, conv_channels, cfg.d_model,
                               num_lstm_layers)
        self.fc_cls = nn.Linear(2 * cfg.d_model, num_classes_total)
        self.fc_box = nn.Linear(2 * cfg.d_model, 4)
        if with_retrieval:
            self.retrieval_aug = RetrievalAugmentation(num_labels, max_seq_length, cfg.d_model,
                                                       top_k, cfg.dropout)

    def _apply(self, fn, recurse=True):
        # the LSTM stays fp32 when the model is cast (flax's cells have no dtype)
        out = super()._apply(fn, recurse)
        self.cnnlstm.BiLSTM_0.float()
        return out

    def forward(self, image: torch.Tensor, packed_layout: torch.Tensor,
                retrieved: Optional[dict] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(class probabilities [B, S, K], boxes [B, S, 4] in (0, 1))."""
        c0 = self.encoder(image)
        if self.with_retrieval:
            c0 = self.retrieval_aug(c0, retrieved)[:, : c0.shape[1]]
        out = self.cnnlstm(packed_layout, c0).to(self.fc_cls.weight.dtype)
        return torch.softmax(self.fc_cls(out), dim=-1), torch.sigmoid(self.fc_box(out))


class DSDiscriminatorCore(nn.Module):
    """The scalar critic in (-1, 1) of a packed layout on its canvas."""

    def __init__(self, num_classes_total: int, cfg: GeneratorConfig = GeneratorConfig(),
                 image_hw: tuple[int, int] = (350, 240)) -> None:
        super().__init__()
        self.encoder = ImageToLSTMState("resnet18", cfg.d_model, 2, image_hw)
        self.cnnlstm = CNNLSTM(2 * num_classes_total, 32, cfg.d_model, 2)
        self.fc_tf = nn.Linear(2 * cfg.d_model, 1)

    def train(self, mode: bool = True) -> "DSDiscriminatorCore":
        super().train(mode)
        self.cnnlstm.BiLSTM_0.train()  # cuDNN's RNN backward needs it; no LSTM dropout
        return self

    def forward(self, image: torch.Tensor, packed_layout: torch.Tensor) -> torch.Tensor:
        """[B] critic values."""
        packed_layout = straight_through_argmax(packed_layout)
        out = self.cnnlstm(packed_layout, self.encoder(image))[:, -1]
        return torch.tanh(self.fc_tf(out))[:, 0]


class DSGANGenerator(CGLGANGenerator):
    """DS-GAN behind CGL-GAN's wrapper (the same conditioning, sampler and
    discriminator step): its own cores, class coefs, adversarial ramp and
    unweighted criterion, and the reorder on by default."""

    FP32_TRAINING_ONLY = True  # JAX's cannot be built at a low dtype (module docstring)

    def __init__(self, num_labels: int, cfg: GeneratorConfig = GeneratorConfig(),
                 auxiliary_task: Optional[str] = "uncond", max_seq_length: int = 10,
                 image_hw: tuple[int, int] = (350, 240), with_retrieval: bool = False,
                 top_k: int = 16, use_reorder: bool = True, *, device="cuda",
                 seed: int = 0) -> None:
        super().__init__(num_labels, cfg, auxiliary_task, max_seq_length, image_hw,
                         with_retrieval, top_k, use_reorder, device=device, seed=seed)
        self.coef = DS_COEF[self.K]

    def _make_core(self) -> nn.Module:
        return DSGeneratorCore(self.K, self.cfg, self.with_retrieval, self.num_labels, self.S,
                               self.top_k, self.image_hw)

    def _make_disc(self) -> nn.Module:
        return DSDiscriminatorCore(self.K, self.cfg, self.image_hw)

    def update_per_epoch(self, epoch: int, warmup: int, max_epoch: int) -> None:
        self.adv_weight = 1.0 if epoch > warmup else (epoch - 1) / max(warmup, 1)

    def criterion(self, logits: torch.Tensor, boxes: torch.Tensor, targets: dict):
        _, terms = super().criterion(logits, boxes, targets)
        return terms["loss_ce"] + terms["loss_bbox"] + terms["loss_giou"], terms
