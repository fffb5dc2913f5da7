"""The pretrained image towers, the counterpart of `ralf_tpu/models/towers.py`:
VGG16, AlexNet's LPIPS taps, InceptionV3, ViT-B/16 and the DreamSim ensemble.

  * VGG16 (timm `vgg16`, `num_classes=0`): 4096-d pre-logits features, for
    R_shm and the `vgg` retrieval backbone; `return_taps` gives LPIPS-VGG's
    five taps.
  * AlexNet (torchvision `alexnet.features` up to relu5): the five taps of
    LPIPS-Alex (`retrieval/lpips.py`).
  * InceptionV3 (timm `inception_v3`, `num_classes=0`): 2048-d pooled
    features of layout-masked canvases, image FID's extractor.
  * ViT-B/16 (timm layout): the `clip` retrieval backbone (`pre_norm`: the
    CLIP variant, a bias-free patch embedding and a LayerNorm before the
    blocks) and each tower of DreamSim, whose ensemble concatenates the
    three towers' CLS features, each divided by max(norm, 1e-6).

The modules are NCHW with the flax modules' names (`features_{i}`,
`Mixed_5b.branch1x1.conv`, `block_{i}.qkv`, ...), so
`utils/weights.py::load_jax_params` loads JAX's variables into them and
`utils/checkpoints.py` maps the reference's torch checkpoints onto them.
They run in fp32, as JAX's feature functions do, on cuDNN convolutions and
plain torch ops: JAX computes them in XLA, outside any Pallas kernel.  The
ViT's attention is JAX's q kᵀ Dh^-0.5, softmax, then v, in fp32.

flax's conventions kept here (ROADMAP.md Queue C 72): `nn.Conv` pads
"SAME" unless told otherwise (the ViT's patch embedding at stride 16 and
VGG's 1x1 `pre_logits_fc2` need no padding at the sizes they run);
`nn.max_pool` is VALID; InceptionV3's BatchNorm has eps 1e-3 and runs on
its statistics; `_avg3` counts the padding; the ViT's LayerNorms have eps
1e-5 and its GELU is exact.

`resize_normalize` is `jax.image.resize(method="cubic", antialias=True)`:
torch's bicubic with `antialias=True` (Keys' a = -0.5; plain bicubic uses
-0.75), clipped to [0, 1] after the resize (Queue C 71).

`build_feature_fn(kind, cache_dir, device)` loads `{cache_dir}/{ckpt}` when
the file is there (`utils/checkpoints.py`) and otherwise runs the tower
randomly initialised with a loud warning, as JAX does: from flax's
initialisers' distributions (`flax_init`), drawn from a seeded torch
generator.  The draws differ by framework (ROADMAP.md Queue C 73), so
features without a checkpoint differ between the packages.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.models.resnet import BatchNorm
from ralf_tpu_torch.utils.device import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)  # timm IMAGENET_INCEPTION_MEAN
INCEPTION_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)  # OPENAI_CLIP_MEAN
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

log = logging.getLogger(__name__)


def resize_normalize(img: torch.Tensor, size: int, mean: Sequence[float],
                     std: Sequence[float]) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> resized, normalised [B, 3, size, size]."""
    x = img.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=False,
                      antialias=True).clamp(0.0, 1.0)
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)[:, None, None]
    s = torch.tensor(std, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - m) / s


# ---- VGG16 (timm layout: features + ConvMlp pre_logits) ----------------------

_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")


class VGG16Features(nn.Module):
    """conv stack -> 7x7 pre-logits -> 1x1 -> global mean: [B, 4096]."""

    # the last conv of each block (relu1_2, 2_2, 3_3, 4_3, 5_3): LPIPS-VGG's taps
    LPIPS_TAPS = (1, 4, 8, 12, 16)

    def __init__(self) -> None:
        super().__init__()
        cin = 3
        for i, spec in enumerate(_VGG16_PLAN):
            if spec != "M":
                self.add_module(f"features_{i}", nn.Conv2d(cin, spec, 3, padding=1))
                cin = spec
        self.pre_logits_fc1 = nn.Conv2d(512, 4096, 7)
        self.pre_logits_fc2 = nn.Conv2d(4096, 4096, 1)

    def forward(self, img: torch.Tensor, return_taps: bool = False):
        """img [B, 3, H, W], resized and normalised; the pooled feature, or the
        five LPIPS taps with `return_taps` (the pre-logits then go unused)."""
        h, taps = img.float(), []
        for i, spec in enumerate(_VGG16_PLAN):
            if spec == "M":
                h = F.max_pool2d(h, 2, 2)
            else:
                h = F.relu(getattr(self, f"features_{i}")(h))
                if i in self.LPIPS_TAPS:
                    taps.append(h)
        if return_taps:
            return taps
        h = F.relu(self.pre_logits_fc2(F.relu(self.pre_logits_fc1(h))))
        return h.mean(dim=(2, 3))


# ---- AlexNet's LPIPS taps (torchvision `alexnet.features`) -------------------

# lpips.ScalingLayer, applied to [-1, 1] input
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
# (out channels, kernel, stride, padding) or "M" = MaxPool(3, 2); the index
# of each conv is torchvision's (a conv and its ReLU take two)
_ALEXNET_PLAN = ((64, 11, 4, 2), "M", (192, 5, 1, 2), "M",
                 (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))


class AlexNetFeatures(nn.Module):
    """Input already through `retrieval.lpips.lpips_scale`; returns the five
    post-ReLU taps (64, 192, 384, 256, 256 channels)."""

    def __init__(self) -> None:
        super().__init__()
        cin, i = 3, 0
        for spec in _ALEXNET_PLAN:
            if spec == "M":
                i += 1
                continue
            ch, k, s, p = spec
            self.add_module(f"features_{i}", nn.Conv2d(cin, ch, k, stride=s, padding=p))
            cin, i = ch, i + 2

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h, taps, i = x.float(), [], 0
        for spec in _ALEXNET_PLAN:
            if spec == "M":
                h = F.max_pool2d(h, 3, 2)
                i += 1
            else:
                h = F.relu(getattr(self, f"features_{i}")(h))
                taps.append(h)
                i += 2
        return taps


# ---- InceptionV3 (timm layout) -----------------------------------------------


class BasicConv(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-3, running statistics) -> ReLU, the
    last two one K11 pass where the BatchNorm takes it (`resnet.BatchNorm`)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), relu=True)


def _avg3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean with the padding counted (over 9 always)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


_P17, _P71 = (0, 3), (3, 0)  # (1, 7) and (7, 1) kernels' padding
_P13, _P31 = (0, 1), (1, 0)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg3(x)),
        ], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=_P17)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=_P71)
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=_P17)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=_P71)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=_P17)
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=_P17)
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=_P71)
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)],
                         dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=_P13)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=_P31)
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=_P13)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=_P31)
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionV3Features(nn.Module):
    """[B, 3, H, W] resized and normalised (299 canonical) -> [B, 2048]."""

    def __init__(self) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(img.float())))
        h = F.max_pool2d(h, 3, 2)
        h = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)), 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            h = getattr(self, f"Mixed_{name}")(h)
        return h.mean(dim=(2, 3))


# ---- ViT-B/16 (timm layout) and the DreamSim ensemble -------------------------


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(B, N, 3, H, D // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, N, Dh] each
        attn = torch.softmax((q @ k.transpose(-2, -1)) * (D // H) ** -0.5, dim=-1)
        x = x + self.proj((attn @ v).transpose(1, 2).reshape(B, N, D))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))


class ViTB16(nn.Module):
    """[B, 3, S, S] resized and normalised, S = `img_size` -> the CLS feature
    [B, dim].  `pre_norm`: the CLIP variant."""

    def __init__(self, dim: int = 768, depth: int = 12, num_heads: int = 12, patch: int = 16,
                 pre_norm: bool = False, img_size: int = 224) -> None:
        super().__init__()
        if img_size % patch:
            raise ValueError(f"image size {img_size} is no multiple of the patch {patch}")
        self.dim, self.depth, self.img_size = dim, depth, img_size
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch, bias=not pre_norm)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, (img_size // patch) ** 2 + 1, dim) * 0.02)
        if pre_norm:
            self.norm_pre = nn.LayerNorm(dim, eps=1e-5)
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(dim, num_heads))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed(img.float()).flatten(2).transpose(1, 2)  # [B, N, dim]
        h = torch.cat([self.cls_token.expand(h.shape[0], -1, -1), h], dim=1) + self.pos_embed
        if hasattr(self, "norm_pre"):
            h = self.norm_pre(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h)
        return self.norm(h)[:, 0]


DREAMSIM_TOWERS = (("dino", False), ("clip", True), ("open_clip", True))  # (name, pre_norm)


class DreamSimEnsemble(nn.Module):
    """Three ViT-B/16 towers; each CLS feature divided by max(its norm,
    1e-6), concatenated: [B, 3 dim]."""

    def __init__(self, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 img_size: int = 224) -> None:
        super().__init__()
        for name, pre_norm in DREAMSIM_TOWERS:
            self.add_module(name, ViTB16(dim, depth, num_heads, pre_norm=pre_norm,
                                         img_size=img_size))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        feats = []
        for name, _ in DREAMSIM_TOWERS:
            f = getattr(self, name)(img)
            feats.append(f / f.norm(dim=-1, keepdim=True).clamp_min(1e-6))
        return torch.cat(feats, dim=-1)


# ---- the feature functions (retrieval backbones, image metrics) -------------

# kind -> (module factory, input size, mean, std, checkpoint file, loader kind);
# DreamSim's transform is a resize only
TOWER_SPECS = {
    "dreamsim": (DreamSimEnsemble, 224, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                 "dreamsim_ensemble.pt", "dreamsim"),
    "clip": (lambda: ViTB16(pre_norm=True), 224, CLIP_MEAN, CLIP_STD, "clip_vit_b16.pt", "clip"),
    "vgg": (VGG16Features, 224, IMAGENET_MEAN, IMAGENET_STD, "vgg16.pt", "vgg16"),
    "inception": (InceptionV3Features, 299, INCEPTION_MEAN, INCEPTION_STD, "inception_v3.pt",
                  "inception_v3"),
}


# flax's lecun_normal: a normal truncated at two standard deviations, scaled so
# that the truncated draw has variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def flax_init(module: nn.Module) -> nn.Module:
    """Redraw every Conv2d and Linear as flax's `nn.Conv` / `nn.Dense` draw
    theirs: lecun_normal kernels and zero biases.  torch's own default
    (kaiming_uniform at a = sqrt(5), uniform biases) shrinks the signal by
    about sqrt(6) a layer, so a deep random tower's features come out as
    its biases, the same for every canvas (Queue C 73)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                w = m.weight.normal_().view(-1)
                # redrawn until inside: torch's trunc_normal_ (erfinv) is several times slower
                out = (w.abs() > 2).nonzero().squeeze(1)
                while out.numel():
                    w[out] = redraw = torch.randn(out.numel())
                    out = out[redraw.abs() > 2]
                w.mul_((1.0 / m.weight[0].numel()) ** 0.5 / _TRUNCATED_STD)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def seeded(make, seed: int = 0) -> nn.Module:
    """`make()` with flax's initialisers (`flax_init`) under torch's global
    generator seeded with `seed`, the caller's stream left as it was: a
    tower without its checkpoint is the same random tower in every run."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return flax_init(make())


def load_tower(module: nn.Module, path: str, kind: str, label: str) -> None:
    """Load the checkpoint at `path` into `module` (every tensor filled);
    without the file, warn loudly."""
    from ralf_tpu_torch.utils.checkpoints import load_tower_if_available

    state = load_tower_if_available(path, kind)
    if state is None:
        log.warning("%s tower: no checkpoint at %s — running RANDOMLY INITIALIZED "
                    "(features are deterministic but not the pretrained space)", label, path)
        return
    module.load_state_dict(state, strict=True)
    log.info("%s tower: loaded %s", label, path)


def build_feature_fn(kind: str, cache_dir: str = "cache", device="cuda"):
    """`fn(images [B, H, W, C >= 3] in [0, 1], numpy or tensor) -> [B, D]`
    float32 features on `device` (the card by default; raises without CUDA)."""
    make, size, mean, std, ckpt, loader_kind = TOWER_SPECS[kind]
    dev = resolve_device(device)
    module = seeded(make)
    load_tower(module, os.path.join(cache_dir, ckpt), loader_kind, kind)
    module = module.to(dev).eval()

    @torch.inference_mode()
    def feature_fn(images) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                            device=dev)
        return module(resize_normalize(x[..., :3], size, mean, std)).float()

    return feature_fn
