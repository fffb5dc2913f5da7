"""LaMa (big-lama), the inpainting generator of the offline dataset build:
the counterpart of `ralf_tpu/preprocess/lama.py`.

The FFC-ResNet generator inside the released `big-lama.pt` TorchScript file
(input_nc 4: the masked RGB and the mask; output_nc 3; ngf 64; 3
downsamplings; 18 blocks; global ratio 0.75 from the last downsampling on;
no LFU; sigmoid out), as `nn.Module`s whose names are the file's
(`model.N....`), so its state_dict loads with strict=True and nothing is
transposed.  It runs in fp32 on cuDNN's convolutions and cuFFT: JAX
computes it in XLA, outside any Pallas kernel.

As JAX's `lama_forward` (ROADMAP.md Queue C 77):
  * the Fourier unit is `rfft2` over H, W with norm="ortho" in fp32, its
    channels interleaved [c0_re, c0_im, c1_re, ...], a 1x1 conv, BatchNorm,
    relu, then `irfft2` back to (H, W);
  * every FFC conv pads by reflection; the upsampling is
    ConvTranspose2d(k=3, s=2, p=1, output_padding=1); BatchNorm's eps 1e-5;
  * the output blends `mask * pred + (1 - mask) * image`;
  * an FFC's four paths exist by the state_dict's keys (upstream puts an
    Identity where a ratio is 0): `LamaGenerator(cfg, shapes)` builds each
    conv, spectral transform and BatchNorm from the keys and shapes it is
    given, and the default tree (`shapes=None`) from the config and the
    ratio.

JAX keeps its params as a flat dict of the same names with every 4-D weight
permuted (2, 3, 1, 0); `lama_state_dict_from_jax` undoes that.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ralf_tpu_torch.models.resnet import BatchNorm

GLOBAL_RATIO = 0.75  # ratio_gin / ratio_gout of big-lama's FFC blocks


@dataclass(frozen=True)
class LamaConfig:
    input_nc: int = 4  # masked RGB + mask
    output_nc: int = 3
    ngf: int = 64
    n_downsampling: int = 3
    n_blocks: int = 18
    max_features: int = 1024


BIG_LAMA = LamaConfig()


class FourierUnit(nn.Module):
    """rfft2 -> 1x1 conv on the interleaved re/im channels -> BatchNorm, relu -> irfft2."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * cin, 2 * cout, 1, bias=False)
        self.bn = BatchNorm(2 * cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        f = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
        ff = torch.stack([f.real, f.imag], 2).reshape(B, 2 * C, H, W // 2 + 1)
        ff = F.relu(self.bn(self.conv_layer(ff.to(x.dtype)))).float()
        ff = ff.reshape(B, -1, 2, H, W // 2 + 1)
        out = torch.fft.irfft2(torch.complex(ff[:, :, 0], ff[:, :, 1]), s=(H, W),
                               dim=(-2, -1), norm="ortho")
        return out.to(x.dtype)


class SpectralTransform(nn.Module):
    """Stride 1, no LFU: 1x1 conv, BatchNorm, relu; x + FourierUnit(x); 1x1 conv."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout // 2, 1, bias=False), BatchNorm(cout // 2))
        self.fu = FourierUnit(cout // 2, cout // 2)
        self.conv2 = nn.Conv2d(cout // 2, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        return self.conv2(x + self.fu(x))


PATHS = ("convl2l", "convg2l", "convl2g", "convg2g")  # (local|global) to (local|global)


class FFC(nn.Module):
    """The four paths local/global -> local/global; `paths` names those that
    exist (by default each whose two sides have channels)."""

    def __init__(self, in_l: int, in_g: int, out_l: int, out_g: int, k: int, stride: int,
                 pad: int, paths=None) -> None:
        super().__init__()
        sides = {"convl2l": (in_l, out_l), "convg2l": (in_g, out_l), "convl2g": (in_l, out_g),
                 "convg2g": (in_g, out_g)}
        if paths is None:
            paths = [p for p, (i, o) in sides.items() if i and o]
        for p in paths:
            i, o = sides[p]
            setattr(self, p, SpectralTransform(i, o) if p == "convg2g" else nn.Conv2d(
                i, o, k, stride, pad, bias=False, padding_mode="reflect"))

    def forward(self, x_l, x_g):
        def path(name, x):
            return getattr(self, name)(x) if hasattr(self, name) and x is not None else None

        def add(a, b):
            return b if a is None else a if b is None else a + b

        return (add(path("convl2l", x_l), path("convg2l", x_g)),
                add(path("convl2g", x_l), path("convg2g", x_g)))


class FFCBnAct(nn.Module):
    """FFC, then BatchNorm and relu on each branch that exists."""

    def __init__(self, in_l: int, in_g: int, out_l: int, out_g: int, k: int = 3,
                 stride: int = 1, pad: int = 1, paths=None) -> None:
        super().__init__()
        self.ffc = FFC(in_l, in_g, out_l, out_g, k, stride, pad, paths)
        if out_l:
            self.bn_l = BatchNorm(out_l)
        if out_g:
            self.bn_g = BatchNorm(out_g)

    def forward(self, x_l, x_g):
        out_l, out_g = self.ffc(x_l, x_g)
        if out_l is not None:
            out_l = F.relu(self.bn_l(out_l))
        if out_g is not None:
            out_g = F.relu(self.bn_g(out_g))
        return out_l, out_g


class FFCResnetBlock(nn.Module):
    def __init__(self, conv1: FFCBnAct, conv2: FFCBnAct) -> None:
        super().__init__()
        self.conv1 = conv1
        self.conv2 = conv2

    def forward(self, x_l, x_g):
        l, g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + l, x_g + g


def _from_keys(shapes: dict, prefix: str) -> dict:
    """The FFC_BN_ACT at `prefix` as its keys give it: its channels
    (in_l, in_g, out_l, out_g; 0 where no key carries one) and its paths."""
    def dim(key, axis):
        return shapes[key][axis] if key in shapes else 0

    f = f"{prefix}.ffc"
    first = {p: f"{f}.{p}.conv1.0.weight" if p == "convg2g" else f"{f}.{p}.weight"
             for p in PATHS}
    return {"in_l": max(dim(first["convl2l"], 1), dim(first["convl2g"], 1)),
            "in_g": max(dim(first["convg2l"], 1), dim(first["convg2g"], 1)),
            "out_l": dim(f"{prefix}.bn_l.weight", 0), "out_g": dim(f"{prefix}.bn_g.weight", 0),
            "paths": [p for p in PATHS if first[p] in shapes]}


class LamaGenerator(nn.Module):
    """The FFC-ResNet generator: `model.0` reflection pad, `model.1` the 7x7
    FFC, `model.2..` the strided FFCs, then the blocks, the concat, the
    (ConvTranspose, BatchNorm, relu) triples, the reflection pad and the 7x7
    conv, indexed as in the released file.  `shapes` ({state_dict key:
    shape}) decides each FFC's paths and widths; without it the default tree
    of `cfg` at GLOBAL_RATIO."""

    def __init__(self, cfg: LamaConfig = BIG_LAMA, shapes: Optional[dict] = None) -> None:
        super().__init__()
        self.cfg = cfg
        mf, ngf, nd = cfg.max_features, cfg.ngf, cfg.n_downsampling

        def ffc(idx, cin, cout, gin, gout, **kw):
            prefix = f"model.{idx}"
            if shapes is not None:
                return FFCBnAct(**_from_keys(shapes, prefix), **kw)
            in_g, out_g = int(cin * gin), int(cout * gout)
            return FFCBnAct(cin - in_g, in_g, cout - out_g, out_g, **kw)

        model = {"1": ffc(1, cfg.input_nc, ngf, 0, 0, k=7, pad=0)}
        idx = 2
        for i in range(nd):
            gout = GLOBAL_RATIO if i == nd - 1 else 0
            model[str(idx)] = ffc(idx, min(mf, ngf * 2**i), min(mf, ngf * 2 ** (i + 1)), 0, gout,
                                  stride=2)
            idx += 1
        dim = min(mf, ngf * 2**nd)
        for _ in range(cfg.n_blocks):
            convs = [ffc(f"{idx}.{c}", dim, dim, GLOBAL_RATIO, GLOBAL_RATIO)
                     for c in ("conv1", "conv2")]
            model[str(idx)] = FFCResnetBlock(*convs)
            idx += 1
        idx += 1  # the concat of the two branches
        self.up = []
        for i in range(nd):
            mult = 2 ** (nd - i)
            cin, cout = min(mf, ngf * mult), min(mf, ngf * mult // 2)
            model[str(idx)] = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                                 output_padding=1)
            model[str(idx + 1)] = BatchNorm(cout)
            self.up.append((str(idx), str(idx + 1)))
            idx += 3  # ConvTranspose, BatchNorm, relu
        idx += 1  # the reflection pad
        model[str(idx)] = nn.Conv2d(ngf, cfg.output_nc, 7)
        self.final = str(idx)
        self.model = nn.ModuleDict(model)

    def forward(self, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """image [B, 3, H, W] in [0, 1], mask [B, 1, H, W] in {0, 1} -> the
        mask-blended inpainting; H and W multiples of 2**n_downsampling."""
        m = self.model
        x = F.pad(torch.cat([image * (1.0 - mask), mask], 1), (3, 3, 3, 3), mode="reflect")
        x_l, x_g = m["1"](x, None)
        for i in range(2, 2 + self.cfg.n_downsampling + self.cfg.n_blocks):  # strided, blocks
            x_l, x_g = m[str(i)](x_l, x_g)
        x = torch.cat([x_l, x_g], 1)
        for conv_t, bn in self.up:
            x = F.relu(m[bn](m[conv_t](x)))
        x = F.pad(x, (3, 3, 3, 3), mode="reflect")
        pred = torch.sigmoid(m[self.final](x))
        return mask * pred + (1.0 - mask) * image


def convert_lama_state_dict(sd: dict) -> dict:
    """A TorchScript or module state_dict -> the generator's: wrapper
    prefixes ('generator.', 'model.model.', ...) stripped down to
    'model.N...', BatchNorm's step counters and keys outside the generator
    dropped, fp32, no permutation (both sides torch)."""
    out = {}
    for k, v in sd.items():
        m = re.search(r"(?:^|\.)(model\.\d+\..+)$", k)
        if not m or k.endswith("num_batches_tracked"):
            continue  # discriminator / loss towers / BatchNorm's step counters
        out[m.group(1)] = torch.as_tensor(v).detach().to("cpu", torch.float32)
    return out


def lama_state_dict_from_jax(params: dict) -> dict:
    """JAX's flat params (`ralf_tpu.preprocess.lama.convert_lama_state_dict`:
    every 4-D weight permuted (2, 3, 1, 0)) -> the generator's state_dict:
    (3, 2, 0, 1) undoes the permutation of plain and transposed convs alike."""
    out = {}
    for k, v in params.items():
        v = np.array(v, np.float32)
        if k.endswith(".weight") and v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def infer_config(sd: dict) -> LamaConfig:
    """(input_nc, output_nc, ngf, n_downsampling, n_blocks) from the
    generator's state_dict (torch layout): the file carries no config."""
    block_idxs = sorted({int(m.group(1)) for k in sd
                         if (m := re.match(r"model\.(\d+)\.conv1\.", k))})
    w_init = sd["model.1.ffc.convl2l.weight"]  # (ngf, input_nc, 7, 7)
    final_idx = max(int(m.group(1)) for k in sd if (m := re.match(r"model\.(\d+)\.weight$", k)))
    return LamaConfig(input_nc=w_init.shape[1], output_nc=sd[f"model.{final_idx}.weight"].shape[0],
                      ngf=w_init.shape[0], n_downsampling=block_idxs[0] - 2,
                      n_blocks=len(block_idxs))


def build_generator(sd: dict) -> LamaGenerator:
    """The generator of `sd`'s config and keys, with `sd` loaded (strict)."""
    gen = LamaGenerator(infer_config(sd), {k: tuple(v.shape) for k, v in sd.items()})
    gen.load_state_dict(sd, strict=True)
    return gen.eval()


def pad_to_modulo(arr: np.ndarray, mod: int = 8) -> tuple[np.ndarray, tuple]:
    """numpy "symmetric" pad of H and W (axes 1, 2) up to a multiple of `mod`;
    returns (padded, the original (H, W))."""
    H, W = arr.shape[1], arr.shape[2]
    Hp, Wp = -(-H // mod) * mod, -(-W // mod) * mod
    pad = [(0, 0), (0, Hp - H), (0, Wp - W)] + [(0, 0)] * (arr.ndim - 3)
    return np.pad(arr, pad, mode="symmetric"), (H, W)


def load_lama_params(path: str) -> dict:
    """The generator's state_dict from a big-lama TorchScript file, or else
    a `.pth` (a state_dict, or a dict holding one under "state_dict")."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return convert_lama_state_dict(sd)
