"""The saliency maps of the offline dataset build, the counterpart of
`ralf_tpu/cli/saliency.py`: ISNet at 1024^2 -> `saliency/*.png`, BASNet at
256^2 -> `saliency_sub/*.png` (`cli.build_dataset` takes their pixel max).

    python -m ralf_tpu_torch.cli.saliency --model isnet \\
        --input-dir .../image/train/input --output-dir .../image/train/saliency \\
        [--weights isnet-general-use.pth] [--batch-size 4] [--device cuda]

`--weights` takes the released torch files (`isnet-general-use.pth`,
`gdi-basnet.pth`: `preprocess/saliency_models.py::load_released`) or a flat
`.npz` of JAX's flax variables (`utils/weights.py::save_params_npz`); an
orbax checkpoint directory is refused with a hint.  Without weights the
nets draw flax's initialisers' laws from a seeded torch generator
(`models/towers.py::seeded`), with a loud UNTRAINED warning: fine for a
pipeline's smoke test, not for a real dataset.  The nets run on `--device`
(the card by default; it raises without CUDA).

`saliency_maps` is the array work (preprocess, forward, the per-map min-max
normalisation); `main` adds only the PNG reads, resizes and writes.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np
import torch

SIZES = {"isnet": 1024, "basnet": 256}


def build_net(model: str, weights=None, device="cuda") -> torch.nn.Module:
    """ISNet or BASNet in eval mode on `device`: from `weights` (see the
    module docstring), else seeded with flax's initialisers' laws."""
    from ralf_tpu_torch.models.towers import seeded
    from ralf_tpu_torch.preprocess.saliency_models import BASNet, ISNetDIS, load_released
    from ralf_tpu_torch.utils.device import resolve_device
    from ralf_tpu_torch.utils.weights import load_jax_params, load_params_npz

    dev = resolve_device(device)
    net = seeded(ISNetDIS if model == "isnet" else BASNet)
    if weights and os.path.isdir(weights):
        raise ValueError(f"{weights} is a directory (an orbax checkpoint?), which the port "
                         "does not read; pass the released .pth, or a flat .npz of the flax "
                         "variables (utils/weights.py::save_params_npz, README.md)")
    if weights and os.path.exists(weights):
        if weights.endswith(".npz"):
            load_jax_params(net, *load_params_npz(weights))
        else:
            load_released(net, weights, model)
    else:
        logging.warning("running with UNTRAINED %s weights", model)
    return net.to(dev).eval()


def raw_maps(net: torch.nn.Module, model: str, images01: np.ndarray) -> torch.Tensor:
    """[B, size, size, 3] float images in [0, 1] -> the net's maps [B, size,
    size] on its device (sigmoid outputs, before the min-max)."""
    from ralf_tpu_torch.preprocess.saliency_models import basnet_preprocess, isnet_preprocess

    x = (isnet_preprocess if model == "isnet" else basnet_preprocess)(images01)
    dev = next(net.parameters()).device
    with torch.inference_mode():
        return net(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2).contiguous())


def saliency_maps(net: torch.nn.Module, model: str, images01: np.ndarray) -> np.ndarray:
    """The CLI's array work: resized float images [B, size, size, 3] in [0,
    1] -> the maps [B, size, size], float32 numpy, each scaled to [0, 1] by
    its own min and max (JAX's CLI)."""
    maps = raw_maps(net, model, images01).float().cpu().numpy()
    lo, hi = maps.min((1, 2), keepdims=True), maps.max((1, 2), keepdims=True)
    return (maps - lo) / np.maximum(hi - lo, 1e-8)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["isnet", "basnet"], default="isnet")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    size = SIZES[args.model]
    net = build_net(args.model, args.weights, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.input_dir, "*.png")))
    for s in range(0, len(paths), args.batch_size):
        chunk = paths[s: s + args.batch_size]
        imgs, shapes = [], []
        for path in chunk:
            im = Image.open(path).convert("RGB")
            shapes.append(im.size)
            imgs.append(np.asarray(im.resize((size, size)), np.float32) / 255.0)
        for path, m, wh in zip(chunk, saliency_maps(net, args.model, np.stack(imgs)), shapes):
            out = Image.fromarray((m * 255).astype(np.uint8)).resize(wh)
            out.save(os.path.join(args.output_dir, os.path.basename(path)))
    logging.info("wrote %d maps", len(paths))


if __name__ == "__main__":
    main()
