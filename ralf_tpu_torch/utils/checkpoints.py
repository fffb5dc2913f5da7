"""Load the reference's pretrained tower checkpoints into the port's towers:
the counterpart of `ralf_tpu/utils/torch_port.py`'s tower converters
(`port_vgg16`, `port_alexnet`, `port_lpips_lins`, `port_inception_v3`,
`port_vit_b16`, `port_dreamsim`, `load_tower_if_available`).

A checkpoint is a torch state_dict (`torch.load(..., weights_only=True)`)
with timm's or torchvision's names; both sides are torch, so nothing is
transposed: the keys are renamed onto the modules of `models/towers.py`,
whose names are the flax modules'.  Keys that JAX's converters do not read
(a classifier head, InceptionV3's AuxLogits, BatchNorm's
num_batches_tracked) are left out and logged; `tower_state_dict` returns
them, so a test can ask that a checkpoint be consumed whole.

    kind          file (models/towers.TOWER_SPECS)     returns
    vgg16         vgg16.pt                             VGG16Features' state_dict
    inception_v3  inception_v3.pt                      InceptionV3Features'
    clip, dino    clip_vit_b16.pt                      ViTB16's
    dreamsim      dreamsim_ensemble.pt                 DreamSimEnsemble's ({dino,clip,open_clip}.<timm vit keys>)
    alexnet       -                                    AlexNetFeatures'
    lpips_alex    lpips_alex.pth                       (AlexNetFeatures', [5 lins, [C] each])

`alexnet` and `lpips_alex` take torchvision's `features.{i}.*` keys or the
lpips package's re-sliced `net.slice{k}.{i}.*`; the lins are
`lin{k}.model.1.weight` or `lins.{k}.model.1.weight` ([1, C, 1, 1]).
"""

from __future__ import annotations

import logging
import os
import re

import torch

log = logging.getLogger(__name__)

# timm vgg16 `features.{i}` conv indices -> VGG16Features `features_{j}` (the plan's index)
_VGG16_IDX = ((0, 0), (2, 1), (5, 3), (7, 4), (10, 6), (12, 7), (14, 8),
              (17, 10), (19, 11), (21, 12), (24, 14), (26, 15), (28, 16))
_ALEXNET_CONVS = (0, 3, 6, 8, 10)
# the lpips package's slices of torchvision's alexnet.features: slice k starts at index
_LPIPS_SLICE_BASE = {1: 0, 2: 2, 3: 5, 4: 8, 5: 10}


def _vgg16(sd: dict) -> dict:
    out = {}
    for i, j in _VGG16_IDX:
        for leaf in ("weight", "bias"):
            out[f"features_{j}.{leaf}"] = sd[f"features.{i}.{leaf}"]
    for fc in ("fc1", "fc2"):
        for leaf in ("weight", "bias"):
            out[f"pre_logits_{fc}.{leaf}"] = sd[f"pre_logits.{fc}.{leaf}"]
    return out


def _flat_alexnet(sd: dict) -> dict:
    """lpips's `net.slice{k}.{i}.*` -> torchvision's `features.{base + i}.*`."""
    if any(k.startswith("features.") for k in sd):
        return sd
    flat = {}
    for key, v in sd.items():
        m = re.fullmatch(r"net\.slice(\d)\.(\d+)\.(.+)", key)
        if m:
            flat[f"features.{_LPIPS_SLICE_BASE[int(m.group(1))] + int(m.group(2))}.{m.group(3)}"] = v
    return flat


def _alexnet(sd: dict) -> dict:
    sd = _flat_alexnet(sd)
    return {f"features_{i}.{leaf}": sd[f"features.{i}.{leaf}"]
            for i in _ALEXNET_CONVS for leaf in ("weight", "bias")}


def lpips_lins(sd: dict, num_taps: int = 5) -> list[torch.Tensor]:
    """The five learned per-channel weights [C] of LPIPS (NetLinLayer is a
    bias-free 1x1 conv to one channel)."""
    out = []
    for k in range(num_taps):
        key = next((f for f in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight")
                    if f in sd), None)
        if key is None:
            raise KeyError(f"lpips lins head {k} not found in the state_dict")
        w = sd[key]
        if w.dim() != 4 or w.shape[0] != 1:
            raise ValueError(f"{key}: shape {tuple(w.shape)}, want [1, C, 1, 1]")
        out.append(w.reshape(-1).float())
    return out


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _inception_v3(sd: dict) -> dict:
    """Every BasicConv2d's conv weight and BatchNorm (the names are the port's)."""
    out = {}
    for key in sd:
        if key.endswith(".conv.weight") and not key.startswith("AuxLogits."):
            name = key[: -len(".conv.weight")]
            out[key] = sd[key]
            for leaf in _BN_LEAVES:
                out[f"{name}.bn.{leaf}"] = sd[f"{name}.bn.{leaf}"]
    return out


def _vit_b16(sd: dict, prefix: str = "", out_prefix: str = "") -> dict:
    g = lambda k: sd[f"{prefix}{k}"]  # noqa: E731
    depth = 1 + max(int(k[len(prefix) + 7:].split(".", 1)[0])
                    for k in sd if k.startswith(f"{prefix}blocks."))
    out = {"cls_token": g("cls_token"), "pos_embed": g("pos_embed"),
           "patch_embed.weight": g("patch_embed.proj.weight"),
           "norm.weight": g("norm.weight"), "norm.bias": g("norm.bias")}
    if f"{prefix}patch_embed.proj.bias" in sd:
        out["patch_embed.bias"] = g("patch_embed.proj.bias")
    if f"{prefix}norm_pre.weight" in sd:
        out["norm_pre.weight"], out["norm_pre.bias"] = g("norm_pre.weight"), g("norm_pre.bias")
    names = {"norm1": "norm1", "attn.qkv": "qkv", "attn.proj": "proj", "norm2": "norm2",
             "mlp.fc1": "mlp_fc1", "mlp.fc2": "mlp_fc2"}
    for i in range(depth):
        for src, dst in names.items():
            for leaf in ("weight", "bias"):
                out[f"block_{i}.{dst}.{leaf}"] = g(f"blocks.{i}.{src}.{leaf}")
    return {f"{out_prefix}{k}": v for k, v in out.items()}


def _dreamsim(sd: dict) -> dict:
    out = {}
    for name in ("dino", "clip", "open_clip"):
        out.update(_vit_b16(sd, f"{name}.", f"{name}."))
    return out


_MAPS = {"vgg16": _vgg16, "inception_v3": _inception_v3, "clip": _vit_b16, "dino": _vit_b16,
         "dreamsim": _dreamsim, "alexnet": _alexnet, "lpips_alex": _alexnet}


def tower_state_dict(sd: dict, kind: str):
    """(the port's state_dict for `kind` — for `lpips_alex` (the tower's,
    the lins) —, the keys of `sd` it did not read)."""
    if kind not in _MAPS:
        raise ValueError(f"unknown tower kind {kind!r}; choose from {sorted(_MAPS)}")
    state = _MAPS[kind](sd)
    read = {id(v) for v in state.values()}
    if kind == "lpips_alex":
        lins = lpips_lins(sd)
        read |= {id(sd[k]) for k in sd if re.fullmatch(r"lins?\.?\d\.model\.1\.weight", k)}
        state = (state, lins)
    unread = sorted(k for k, v in sd.items() if id(v) not in read)
    return state, unread


def load_tower_if_available(path: str, kind: str):
    """The checkpoint at `path` as the port's state_dict for `kind` (see the
    module docstring); None when the file is absent."""
    if not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    state, unread = tower_state_dict(sd, kind)
    if unread:
        log.info("%s: %d keys not read by the %s tower (%s)", path, len(unread), kind,
                 ", ".join(unread[:8]))
    return state
