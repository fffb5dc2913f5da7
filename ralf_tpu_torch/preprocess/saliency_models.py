"""The saliency nets of the offline dataset build, the counterpart of
`ralf_tpu/preprocess/saliency_models.py`: ISNet (DIS; U^2-Net's RSU blocks,
run at 1024^2 after x - 0.5) and BASNet (a resnet34 encoder with two more
512 stages, a dilated bridge, a six-stage decoder, side outputs and a
residual refinement UNet, run at 256^2 after the batch's max and ImageNet's
normalisation).  `cli/build_dataset.py` takes the pixel max of their maps.

The modules are NCHW with the flax modules' names, which are the released
torch checkpoints' names, so `utils/weights.py::load_jax_params` fills them
from JAX's variables and `isnet_state_dict` / `basnet_state_dict` rename
`isnet-general-use.pth` / `gdi-basnet.pth` onto them (both sides torch:
nothing is transposed).  They run in fp32 on cuDNN's convolutions: JAX
computes them in XLA, outside any Pallas kernel.

JAX's conventions kept here (ROADMAP.md Queue C 76):
  * `_pool2` floors (flax's `max_pool`, VALID), where upstream torch pools
    with ceil_mode=True: the same at the CLI's sizes (every stage is even).
  * `_upsample_to` is `jax.image.resize(..., "bilinear")`, which here only
    ever upsamples: torch's bilinear with align_corners=False.
  * Every conv passes its padding: `padding=dilation`; ResNet's 1x1
    downsample pads nothing.  ISNet's `conv_in` is a plain stride-2 conv
    (no BatchNorm).  BASNet's `conv6d_m`, `conv6d_2` and the bridge are
    dilation-2; `TorchBasicBlock`'s convs have no bias.
  * BASNet's `hd6` runs through `bn5d_2` (an upstream layer-sharing typo
    baked into the released weights): the port has no `bn6d_2`, and
    `basnet_state_dict` drops the checkpoint's.
  * BatchNorm is flax's (momentum 0.99, eps 1e-5): module.train() uses the
    batch's statistics and moves the running ones, as `train=True` does.

`forward(x)` returns the map the tester reads, [B, H, W] (ISNet's side 1,
BASNet's refined output); `full=True` returns every side output as JAX's
does.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.models.resnet import IMAGENET_MEAN, IMAGENET_STD, BatchNorm

log = logging.getLogger(__name__)

FLAX_BN_MOMENTUM = 0.99  # flax nn.BatchNorm's default


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, momentum=FLAX_BN_MOMENTUM)


def _conv(cin: int, cout: int, dil: int = 1, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=dil, dilation=dil, bias=bias)


def _upsample_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear", align_corners=False,
                         antialias=False)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class REBNConv(nn.Module):
    """conv3x3 (dilation `dirate`) + BatchNorm + relu."""

    def __init__(self, cin: int, cout: int, dirate: int = 1, stride: int = 1) -> None:
        super().__init__()
        self.conv_s1 = _conv(cin, cout, dirate, stride)
        self.bn_s1 = _bn(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn_s1(self.conv_s1(x)))


class RSUBlock(nn.Module):
    """Residual U-block RSU{height}: rebnconvin, rebnconv1..{height} (the
    bottom one dilation 2), rebnconv{k}d back up."""

    def __init__(self, height: int, cin: int, mid_ch: int, out_ch: int) -> None:
        super().__init__()
        self.height = height
        self.rebnconvin = REBNConv(cin, out_ch)
        self.rebnconv1 = REBNConv(out_ch, mid_ch)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNConv(mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNConv(mid_ch, mid_ch, dirate=2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNConv(2 * mid_ch, mid_ch))
        self.rebnconv1d = REBNConv(2 * mid_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h = self.rebnconv1(hxin)
        encs = [h]
        for i in range(2, self.height):
            h = getattr(self, f"rebnconv{i}")(_pool2(h))
            encs.append(h)
        h = getattr(self, f"rebnconv{self.height}")(h)
        for i in range(self.height - 1, 1, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, encs[i - 1]], 1))
            h = _upsample_to(h, encs[i - 2])
        return hxin + self.rebnconv1d(torch.cat([h, encs[0]], 1))


class RSU4F(nn.Module):
    """The dilation-only residual block (dilations 1, 2, 4, 8, then back)."""

    def __init__(self, cin: int, mid_ch: int, out_ch: int) -> None:
        super().__init__()
        self.rebnconvin = REBNConv(cin, out_ch)
        self.rebnconv1 = REBNConv(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNConv(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNConv(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNConv(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNConv(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNConv(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNConv(2 * mid_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat([h4, h3], 1))
        d2 = self.rebnconv2d(torch.cat([d3, h2], 1))
        return hxin + self.rebnconv1d(torch.cat([d2, h1], 1))


class ISNetDIS(nn.Module):
    """ISNet: a plain stride-2 conv stem, six RSU stages with 2x pools, the
    mirrored RSU decoder, six 3x3 side convs upsampled to the input."""

    def __init__(self) -> None:
        super().__init__()
        self.conv_in = nn.Conv2d(3, 64, 3, stride=2, padding=1)
        self.stage1 = RSUBlock(7, 64, 32, 64)
        self.stage2 = RSUBlock(6, 64, 32, 128)
        self.stage3 = RSUBlock(5, 128, 64, 256)
        self.stage4 = RSUBlock(4, 256, 128, 512)
        self.stage5 = RSU4F(512, 256, 512)
        self.stage6 = RSU4F(512, 256, 512)
        self.stage5d = RSU4F(1024, 256, 512)
        self.stage4d = RSUBlock(4, 1024, 128, 256)
        self.stage3d = RSUBlock(5, 512, 64, 128)
        self.stage2d = RSUBlock(6, 256, 32, 64)
        self.stage1d = RSUBlock(7, 128, 16, 64)
        for k, ch in zip(range(1, 7), (64, 64, 128, 256, 512, 512)):
            setattr(self, f"side{k}", nn.Conv2d(ch, 1, 3, padding=1))

    def forward(self, x: torch.Tensor, full: bool = False):
        s1 = self.stage1(self.conv_in(x))
        s2 = self.stage2(_pool2(s1))
        s3 = self.stage3(_pool2(s2))
        s4 = self.stage4(_pool2(s3))
        s5 = self.stage5(_pool2(s4))
        s6 = self.stage6(_pool2(s5))
        d5 = self.stage5d(torch.cat([_upsample_to(s6, s5), s5], 1))
        d4 = self.stage4d(torch.cat([_upsample_to(d5, s4), s4], 1))
        d3 = self.stage3d(torch.cat([_upsample_to(d4, s3), s3], 1))
        d2 = self.stage2d(torch.cat([_upsample_to(d3, s2), s2], 1))
        d1 = self.stage1d(torch.cat([_upsample_to(d2, s1), s1], 1))
        feats = [d1, d2, d3, d4, d5, s6]
        if not full:
            return torch.sigmoid(_upsample_to(self.side1(d1), x))[:, 0]
        sides = [torch.sigmoid(_upsample_to(getattr(self, f"side{k}")(h), x))
                 for k, h in enumerate(feats, 1)]
        return sides, feats


class TorchBasicBlock(nn.Module):
    """resnet34's BasicBlock, its convs without bias."""

    def __init__(self, cin: int, ch: int, stride: int = 1, downsample: bool = False) -> None:
        super().__init__()
        self.conv1 = _conv(cin, ch, stride=stride, bias=False)
        self.bn1 = _bn(ch)
        self.conv2 = _conv(ch, ch, bias=False)
        self.bn2 = _bn(ch)
        if downsample:
            self.downsample_conv = nn.Conv2d(cin, ch, 1, stride=stride, bias=False)
            self.downsample_bn = _bn(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        res = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        return F.relu(h + res)


class RefUnet(nn.Module):
    """The residual refinement UNet: four pooled conv-BN-relu stages, a
    bottom one, four upsampled ones, and a 1-channel residual."""

    def __init__(self) -> None:
        super().__init__()
        self.conv0 = _conv(1, 64)
        for i in range(1, 6):
            setattr(self, f"conv{i}", _conv(64, 64))
            setattr(self, f"bn{i}", _bn(64))
        for i in range(1, 5):
            setattr(self, f"conv_d{i}", _conv(128, 64))
            setattr(self, f"bn_d{i}", _bn(64))
        self.conv_d0 = _conv(64, 1)

    def _cbr(self, h: torch.Tensor, conv: str, bn: str) -> torch.Tensor:
        return F.relu(getattr(self, bn)(getattr(self, conv)(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hx = self.conv0(x)
        encs = []
        for i in range(1, 5):
            hx = self._cbr(hx, f"conv{i}", f"bn{i}")
            encs.append(hx)
            hx = _pool2(hx)
        hx = self._cbr(hx, "conv5", "bn5")
        for i in range(4, 0, -1):
            hx = _upsample_to(hx, encs[i - 1])
            hx = self._cbr(torch.cat([hx, encs[i - 1]], 1), f"conv_d{i}", f"bn_d{i}")
        return x + self.conv_d0(hx)


# resnet34's layers: (blocks, channels, stride); the first block of 2-4 downsamples
_ENCODER = {"encoder1": (3, 64, 1), "encoder2": (4, 128, 2), "encoder3": (6, 256, 2),
            "encoder4": (3, 512, 2)}
# the decoder's stages k: (channels in, conv_1's out, conv_m's out, conv_2's out, dilation)
_DECODER = {6: (1024, 512, 512, 512, 2), 5: (1024, 512, 512, 512, 1),
            4: (1024, 512, 512, 256, 1), 3: (512, 256, 256, 128, 1),
            2: (256, 128, 128, 64, 1), 1: (128, 64, 64, 64, 1)}


class BASNet(nn.Module):
    """BASNet: a 3x3 stem with BatchNorm, resnet34's layer1-4, two pooled 512
    BasicBlock stages, the dilated 512 bridge, six decoder stages (hd6's last
    BatchNorm is bn5d_2) with x2 bilinear upsampling between, side convs and
    the refinement UNet on side 1."""

    def __init__(self) -> None:
        super().__init__()
        self.inconv = _conv(3, 64)
        self.inbn = _bn(64)
        cin = 64
        for name, (n, ch, stride) in _ENCODER.items():
            for b in range(n):
                down = b == 0 and stride != 1
                setattr(self, f"{name}_{b}", TorchBasicBlock(cin, ch, stride if b == 0 else 1, down))
                cin = ch
        for s in (5, 6):
            for b in (1, 2, 3):
                setattr(self, f"resb{s}_{b}", TorchBasicBlock(512, 512))
        for part in ("1", "m", "2"):
            setattr(self, f"convbg_{part}", _conv(512, 512, 2))
            setattr(self, f"bnbg_{part}", _bn(512))
        for k, (c_in, c1, cm, c2, dil) in _DECODER.items():
            setattr(self, f"conv{k}d_1", _conv(c_in, c1))
            setattr(self, f"bn{k}d_1", _bn(c1))
            setattr(self, f"conv{k}d_m", _conv(c1, cm, dil))
            setattr(self, f"bn{k}d_m", _bn(cm))
            setattr(self, f"conv{k}d_2", _conv(cm, c2, dil))
            if k != 6:  # hd6 runs through bn5d_2
                setattr(self, f"bn{k}d_2", _bn(c2))
        self.outconvb = _conv(512, 1)
        for k, ch in zip(range(1, 7), (64, 64, 128, 256, 512, 512)):
            setattr(self, f"outconv{k}", _conv(ch, 1))
        self.refunet = RefUnet()

    def _blocks(self, h: torch.Tensor, names) -> torch.Tensor:
        for n in names:
            h = getattr(self, n)(h)
        return h

    def _dstage(self, k: int, skip: torch.Tensor, prev: torch.Tensor, bn2: str) -> torch.Tensor:
        h = torch.cat([prev, skip], 1)
        h = F.relu(getattr(self, f"bn{k}d_1")(getattr(self, f"conv{k}d_1")(h)))
        h = F.relu(getattr(self, f"bn{k}d_m")(getattr(self, f"conv{k}d_m")(h)))
        return F.relu(getattr(self, bn2)(getattr(self, f"conv{k}d_2")(h)))

    def forward(self, x: torch.Tensor, full: bool = False):
        h = F.relu(self.inbn(self.inconv(x)))
        hs = []
        for name, (n, _, _) in _ENCODER.items():
            h = self._blocks(h, [f"{name}_{b}" for b in range(n)])
            hs.append(h)
        h1, h2, h3, h4 = hs
        h5 = self._blocks(_pool2(h4), [f"resb5_{b}" for b in (1, 2, 3)])
        h6 = self._blocks(_pool2(h5), [f"resb6_{b}" for b in (1, 2, 3)])
        h = h6
        for part in ("1", "m", "2"):
            h = F.relu(getattr(self, f"bnbg_{part}")(getattr(self, f"convbg_{part}")(h)))
        hbg = h
        hd6 = self._dstage(6, h6, hbg, "bn5d_2")  # bn5d_2 shared: the upstream quirk
        hd5 = self._dstage(5, h5, _upsample_to(hd6, h5), "bn5d_2")
        hd4 = self._dstage(4, h4, _upsample_to(hd5, h4), "bn4d_2")
        hd3 = self._dstage(3, h3, _upsample_to(hd4, h3), "bn3d_2")
        hd2 = self._dstage(2, h2, _upsample_to(hd3, h2), "bn2d_2")
        hd1 = self._dstage(1, h1, _upsample_to(hd2, h1), "bn1d_2")
        d1 = self.outconv1(hd1)  # already at the input's resolution
        dout = torch.sigmoid(self.refunet(d1))
        if not full:
            return dout[:, 0]
        side = lambda conv, h: torch.sigmoid(_upsample_to(conv(h), x))  # noqa: E731
        return (dout, torch.sigmoid(d1), side(self.outconv2, hd2), side(self.outconv3, hd3),
                side(self.outconv4, hd4), side(self.outconv5, hd5), side(self.outconv6, hd6),
                side(self.outconvb, hbg))


# ---------------------------------------------------------------------------
# the testers' preprocessing, NHWC numpy as JAX's
# ---------------------------------------------------------------------------

def isnet_preprocess(img01: np.ndarray) -> np.ndarray:
    """[B, 1024, 1024, 3] float in [0, 1] -> the net's input (mean 0.5, std 1)."""
    return np.asarray(img01, np.float32) - 0.5


def basnet_preprocess(img01: np.ndarray) -> np.ndarray:
    """[B, 256, 256, 3] float in [0, 1] -> the net's input: divided by the
    max of the WHOLE batch (as JAX's; ToTensorLab divides each image by its
    own), then ImageNet's mean and std."""
    img = np.asarray(img01, np.float32)
    img = img / max(float(img.max()), 1e-6)
    return (img - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)


# ---------------------------------------------------------------------------
# the released checkpoints -> the port's state_dicts
# ---------------------------------------------------------------------------

def _renamed(sd: dict, rename) -> dict:
    """{new name: tensor} of `sd` without BatchNorm's step counters and the
    keys `rename` maps to None."""
    out = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        new = rename(key)
        if new is not None:
            out[new] = torch.as_tensor(val)
    return out


def isnet_state_dict(sd: dict) -> dict:
    """isnet-general-use.pth -> ISNetDIS's state_dict: the names are the
    same, `convert_isnet_state_dict`'s identity."""
    return _renamed(sd, lambda k: k)


def _basnet_name(key: str):
    segs = key.split(".")
    if segs[0] == "bn6d_2":
        return None  # in the checkpoint, never used in the forward
    out, i = [], 0
    while i < len(segs):
        s = segs[i]
        if s.startswith("encoder") and i + 1 < len(segs) and segs[i + 1].isdigit():
            out.append(f"{s}_{segs[i + 1]}")
            i += 2
        elif s == "downsample":
            out.append("downsample_conv" if segs[i + 1] == "0" else "downsample_bn")
            i += 2
        else:
            out.append(s)
            i += 1
    return ".".join(out)


def basnet_state_dict(sd: dict) -> dict:
    """gdi-basnet.pth -> BASNet's state_dict, `convert_basnet_state_dict`'s
    renames: encoderN.B -> encoderN_B, downsample.0/.1 -> downsample_conv /
    downsample_bn, bn6d_2 dropped."""
    return _renamed(sd, _basnet_name)


def load_released(module: nn.Module, path: str, kind: str) -> None:
    """Load the released torch checkpoint at `path` (a state_dict, or a dict
    holding one under "state_dict") into `module`, every tensor filled."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    state = (isnet_state_dict if kind == "isnet" else basnet_state_dict)(sd)
    module.load_state_dict(state, strict=True)
    log.info("%s: loaded %s", kind, path)
