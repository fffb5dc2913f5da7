"""ResNet image backbone with its mini-FPN head, the counterpart of
`ralf_tpu/models/resnet.py`.

Images enter in the JAX package's layout, [B, H, W, 4] (RGB + saliency),
float in [0, 1] or uint8 0..255 (normalized here).  Inside, the NHWC tensor
is viewed as NCHW, which is PyTorch's channels_last layout, so no copy is
made.  BatchNorm follows flax's `nn.BatchNorm(momentum=0.9)`: in eval mode
the running statistics, folded into a per-channel scale and shift; in train
mode the batch's (ROADMAP.md Queue C).  Each block hands its residual add and
its ReLUs to the BatchNorm before them, which in eval mode on the card with
grad off runs all three as one pass (K11, `ops.batchnorm_act`): one launch a
BatchNorm, 53 a ResNet50 forward and 20 a ResNet18 one.

Two heads, as in JAX.  `fpn_style="ralf"` (RALF and autoreg):

    f4p = 1x1(layer3); f5p = 1x1(layer4); f5up = nearest(f5p, size of f4p)
    out = 1x1(concat[f5up, 3x3(f5up + f4p)]) -> [B, H/16, W/16, d_model]

`fpn_style="cgl"` (MaskGIT, LayoutDM, VQDiffusion): ImageNet normalisation
of the RGB channels first (in the image's dtype, after the uint8 cast),
then d_model/2-channel laterals:

    f_up = bilinear(1x1(layer4), size of layer3); out = concat[f_up, 1x1(f_up + 1x1(layer3))]

The nearest upsample is `nearest-exact`: `jax.image.resize(..., "nearest")`
samples at half-pixel centres, and at a 350x240 canvas the 11x8 -> 22x15
width factor is not an integer, where torch's legacy `nearest` picks other
pixels.  The bilinear one is torch's with `align_corners=False`: JAX's
also samples at half-pixel centres and renormalises its triangle kernel
over the pixels inside the map, which at an edge is torch's clamp (its
antialiasing acts only when it shrinks a map).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.models.base import compute_dtype
from ralf_tpu_torch.models.nn import TransformerEncoder, on_card
from ralf_tpu_torch.models.positional import PositionEmbeddingSine2D
from ralf_tpu_torch.ops import batchnorm_act as bn_act
from ralf_tpu_torch.ops.batchnorm_act import batchnorm_act
from ralf_tpu_torch.parallel import rows
from ralf_tpu_torch.utils import tracing

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_MOMENTUM = 0.9  # flax's convention: ra = 0.9 ra + 0.1 batch (torch's momentum 0.1)


def eval_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
               residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """The eval-mode BatchNorm's plain path, then the optional residual add
    and ReLU: the scale and shift worked in fp32 and cast to x's dtype, then
    x * scale + shift, + residual and relu, each rounded to x's dtype (the
    JAX package's order).  The CPU's path, and the card's for what K11 does
    not take."""
    scale = weight.float() * torch.rsqrt(running_var.float() + eps)
    shift = bias.float() - running_mean.float() * scale
    y = x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
    y = y if residual is None else y + residual
    return F.relu(y) if relu else y


class BatchNorm(nn.Module):
    """BatchNorm over NCHW with flax's semantics, then the optional residual
    add and ReLU of the block: relu?(bn(x) (+ residual)).

    eval: x * (w / sqrt(ra_var + eps)) + (b - ra_mean * that).  With grad off
    and x (and residual) on the card in a layout K11 takes (`bn_act.takes`:
    channels_last, fp32 or bf16, C a multiple of 8), one K11 launch computes
    it all in fp32 with one rounding; otherwise `eval_plain` rounds to x's
    dtype after the scale, the shift, the residual add, and the call counts
    `bn.eval.plain` (`utils.tracing`).
    train: the batch's mean and BIASED variance, E[x^2] - E[x]^2 clipped at
    0 (flax's fast variance), in fp32; y = (x - mean) * (rsqrt(var + eps) w)
    + b; and the running statistics move to momentum * ra + (1 - momentum)
    * batch (0.9 here, flax's default 0.99 in the saliency nets), the biased
    variance included, where torch's F.batch_norm would store the unbiased
    one, n/(n-1) larger.  In a data-parallel step (`parallel.rows`) the
    statistics are the global batch's, as flax's mean over JAX's
    batch-sharded array is: the sums of x and x^2 go through an all-reduce
    that carries the gradient."""

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM) -> None:
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        if not self.training:
            params = (self.weight, self.bias, self.running_mean, self.running_var)
            if (not torch.is_grad_enabled() and on_card(x)
                    and bn_act.takes(x, residual, params)):
                return batchnorm_act(x, *params, self.eps, residual, relu)
            tracing.count("bn.eval.plain")
            return eval_plain(x, *params, self.eps, residual, relu)
        y = self._train_forward(x)
        y = y if residual is None else y + residual
        return F.relu(y) if relu else y

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if rows.group_size() == 1:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
        else:  # a data-parallel step: the global batch's statistics, as in JAX
            n = xf.numel() // xf.shape[1] * rows.group_size()
            sums = rows.global_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                                xf.square().sum(dim=(0, 2, 3))]))
            mean = sums[0] / n
            var = (sums[1] / n - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            for ra, batch in ((self.running_mean, mean), (self.running_var, var)):
                ra.copy_(self.momentum * ra + (1.0 - self.momentum) * batch)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1) -> None:
        super().__init__()
        cout = features * 4
        self.conv1, self.bn1 = conv(cin, features, 1), BatchNorm(features)
        self.conv2, self.bn2 = conv(features, features, 3, stride), BatchNorm(features)
        self.conv3, self.bn3 = conv(features, cout, 1), BatchNorm(cout)
        self.has_down = cin != cout or stride != 1
        if self.has_down:
            self.down_conv, self.down_bn = conv(cin, cout, 1, stride), BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x), relu=True)
        y = self.conv3(self.bn2(self.conv2(y), relu=True))
        residual = self.down_bn(self.down_conv(x)) if self.has_down else x
        return self.bn3(y, residual, relu=True)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1, self.bn1 = conv(cin, features, 3, stride), BatchNorm(features)
        self.conv2, self.bn2 = conv(features, features, 3), BatchNorm(features)
        self.has_down = cin != features or stride != 1
        if self.has_down:
            self.down_conv, self.down_bn = conv(cin, features, 1, stride), BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.bn1(self.conv1(x), relu=True))
        residual = self.down_bn(self.down_conv(x)) if self.has_down else x
        return self.bn2(y, residual, relu=True)


_STAGES = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}
_WIDTHS = (64, 128, 256, 512)


class ResNetTrunk(nn.Module):
    """4-channel-stem ResNet returning the (layer3, layer4) maps, NCHW."""

    def __init__(self, backbone: str = "resnet50", in_channels: int = 4) -> None:
        super().__init__()
        block, depths = _STAGES[backbone]
        self.depths = depths
        self.conv1, self.bn1 = conv(in_channels, 64, 7, 2), BatchNorm(64)
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(depths, _WIDTHS)):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_{b}", block(cin, width, stride))
                cin = width * block.expansion
        self.out_channels = (_WIDTHS[2] * block.expansion, _WIDTHS[3] * block.expansion)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        y = F.max_pool2d(self.bn1(self.conv1(x), relu=True), 3, stride=2, padding=1)
        taps = []
        for stage, n_blocks in enumerate(self.depths):
            for b in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_{b}")(y)
            if stage in (2, 3):
                taps.append(y)
        return taps[0], taps[1]


class ResNetFPNEncoder(nn.Module):
    """Trunk + mini-FPN: [B, H, W, 4] -> [B, H/16, W/16, d_model]."""

    def __init__(self, backbone: str = "resnet50", d_model: int = 256,
                 fpn_style: str = "ralf") -> None:
        super().__init__()
        if fpn_style not in ("ralf", "cgl"):
            raise ValueError(f"fpn_style {fpn_style!r}: 'ralf' or 'cgl'")
        self.fpn_style = fpn_style
        self.normalize_rgb = fpn_style == "cgl"
        self.trunk = ResNetTrunk(backbone)
        c3, c4 = self.trunk.out_channels
        if fpn_style == "cgl":
            half = d_model // 2
            self.conv11 = conv(c4, half, 1, bias=True)
            self.conv22 = conv(c3, half, 1, bias=True)
            self.conv33 = conv(half, half, 1, bias=True)
        else:
            self.fpn_conv11_4 = conv(c3, 256, 1, bias=True)
            self.fpn_conv11_5 = conv(c4, 256, 1, bias=True)
            self.fpn_conv33 = conv(256, 256, 3, bias=True)
            self.proj = conv(512, d_model, 1, bias=True)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        if img.is_floating_point():
            img = img.to(self.trunk.conv1.weight.dtype)
        else:  # uint8 ingress: normalized on the device, in the compute dtype
            dtype = compute_dtype(self.trunk.conv1.weight)
            img = img.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype)
        if self.normalize_rgb:
            mean = torch.tensor(IMAGENET_MEAN + (0.0,), dtype=img.dtype, device=img.device)
            std = torch.tensor(IMAGENET_STD + (1.0,), dtype=img.dtype, device=img.device)
            img = (img - mean) / std
        x = img.permute(0, 3, 1, 2)  # NHWC storage viewed as NCHW (channels_last)
        f3, f4 = self.trunk(x)
        if self.fpn_style == "cgl":
            f_up = F.interpolate(self.conv11(f4), size=f3.shape[-2:], mode="bilinear",
                                 align_corners=False, antialias=False)
            fused = self.conv33(f_up + self.conv22(f3))
            return torch.cat([f_up, fused], dim=1).permute(0, 2, 3, 1)
        f4p = self.fpn_conv11_4(f3)
        f5p = self.fpn_conv11_5(f4)
        f5up = F.interpolate(f5p, size=f4p.shape[-2:], mode="nearest-exact")
        fused = torch.cat([f5up, self.fpn_conv33(f5up + f4p)], dim=1)
        return self.proj(fused).permute(0, 2, 3, 1)


class ImageEncoder(nn.Module):
    """extractor -> 2-d sine PE -> pre-LN TransformerEncoder: [B, H'W', d_model]."""

    def __init__(self, backbone: str = "resnet50", d_model: int = 256, nhead: int = 8,
                 num_layers: int = 6, dim_feedforward: int = 1024, dropout: float = 0.1,
                 fpn_style: str = "ralf") -> None:
        super().__init__()
        self.extractor = ResNetFPNEncoder(backbone, d_model, fpn_style)
        self.pos_2d = PositionEmbeddingSine2D(d_model)
        self.transformer = TransformerEncoder(d_model, nhead, num_layers, dim_feedforward,
                                              dropout=dropout)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """Backbone + 2-d sine PE, before the transformer: [B, H'W', D]."""
        return self.pos_2d(self.extractor(img))

    def encode_seq(self, h: torch.Tensor) -> torch.Tensor:
        """The shared transformer over any token sequence [B, S, D] (RALF's
        `pre_encoder` fusion runs it over [features, CA, ref])."""
        return self.transformer(h)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.encode_seq(self.features(img))
