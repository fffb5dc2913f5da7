"""Synthetic poster dataset and the fixed-shape batch iterator, the
counterpart of `ralf_tpu/data/dataset.py` (`SyntheticPosterDataset`,
`BatchLoader`).  Host-side numpy: the same seeds give the same layouts and
canvases as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.data.transforms import compose

IMAGE_H, IMAGE_W = 350, 240  # the reference canvas (H x W)
PKU_LABELS = ("logo", "text", "underlay")
CGL_LABELS = ("embellishment", "logo", "text", "underlay")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str = "pku10"
    max_seq_length: int = 10
    image_h: int = IMAGE_H
    image_w: int = IMAGE_W

    @property
    def label_names(self) -> Sequence[str]:
        return CGL_LABELS if "cgl" in self.name else PKU_LABELS

    @property
    def num_labels(self) -> int:
        return len(self.label_names)


class SyntheticPosterDataset:
    """Deterministic procedural posters: 1..S boxes; the image is a smooth
    colour gradient with box-shaped brightness bumps, the saliency channel
    the union of the boxes."""

    def __init__(self, cfg: DatasetConfig, size: int, seed: int = 0,
                 image_hw: tuple[int, int] | None = None) -> None:
        self.cfg = cfg
        self._size = size
        self._seed = seed
        self._hw = image_hw or (cfg.image_h, cfg.image_w)
        S = cfg.max_seq_length
        rng = np.random.default_rng(seed)
        n = rng.integers(1, S + 1, size=size)
        mask = np.arange(S)[None, :] < n[:, None]
        label = rng.integers(0, cfg.num_labels, size=(size, S))
        cx = rng.uniform(0.1, 0.9, (size, S))
        cy = rng.uniform(0.1, 0.9, (size, S))
        w = rng.uniform(0.08, 0.5, (size, S))
        h = rng.uniform(0.04, 0.3, (size, S))
        z = np.zeros_like(cx)
        self._data = {
            "label": np.where(mask, label, 0).astype(np.int64),
            "center_x": np.where(mask, cx, z).astype(np.float32),
            "center_y": np.where(mask, cy, z).astype(np.float32),
            "width": np.where(mask, w, z).astype(np.float32),
            "height": np.where(mask, h, z).astype(np.float32),
            "mask": mask,
        }

    def __len__(self) -> int:
        return self._size

    def get_layouts(self, indices: np.ndarray) -> dict:
        return {k: v[indices] for k, v in self._data.items()}

    def get_ids(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(indices, np.int64)

    def get_images(self, indices: np.ndarray, dtype=np.float32) -> np.ndarray:
        """[N, H, W, 4] RGB + saliency: float32 in [0, 1], or uint8 with dtype=np.uint8."""
        H, W = self._hw
        out = np.empty((len(indices), H, W, 4), np.float32)
        yy, xx = np.meshgrid(np.linspace(0, 1, H, dtype=np.float32),
                             np.linspace(0, 1, W, dtype=np.float32), indexing="ij")
        for o, idx in enumerate(indices):
            rng = np.random.default_rng(self._seed * 1_000_003 + int(idx))
            phase = rng.uniform(0, 2 * np.pi, 3)
            freq = rng.uniform(1.0, 3.0, 3)
            rgb = 0.5 + 0.35 * np.stack(
                [np.sin(2 * np.pi * f * (xx + yy) + p) for f, p in zip(freq, phase)], axis=-1)
            sal = np.zeros((H, W), np.float32)
            lay = {k: self._data[k][idx] for k in self._data}
            for e in range(self.cfg.max_seq_length):
                if not lay["mask"][e]:
                    continue
                l = lay["center_x"][e] - lay["width"][e] / 2
                r = lay["center_x"][e] + lay["width"][e] / 2
                t = lay["center_y"][e] - lay["height"][e] / 2
                b = lay["center_y"][e] + lay["height"][e] / 2
                inside = ((xx >= l) & (xx <= r) & (yy >= t) & (yy <= b)).astype(np.float32)
                sal = np.maximum(sal, inside)
                rgb += 0.15 * inside[..., None] * (lay["label"][e] + 1) / 4.0
            out[o, ..., :3] = np.clip(rgb, 0, 1)
            out[o, ..., 3] = sal
        if dtype == np.uint8:
            return (out * 255.0 + 0.5).astype(np.uint8)
        return out


class BatchLoader:
    """Shuffling fixed-shape batch iterator with instance transforms:
    batches {'layout': Layout (CPU tensors), 'id', 'indices', 'image'}; the
    last partial batch is dropped."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 transforms: Sequence[str] = ("sort_label", "sort_lexicographic"),
                 seed: int = 0, image_dtype=np.float32) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.image_dtype = image_dtype
        self._transform = compose(list(transforms))
        self._rng = np.random.default_rng(seed)

    def _apply_transforms(self, lay: dict) -> dict:
        out = {k: v.copy() for k, v in lay.items()}
        for b in range(lay["label"].shape[0]):
            n = int(lay["mask"][b].sum())
            if n <= 1:
                continue
            sample = {k: lay[k][b, :n] for k in ("label", "center_x", "center_y", "width", "height")}
            for k, v in self._transform(sample).items():
                out[k][b, :n] = v
        return out

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        b = self.batch_size
        for s in range(0, n - n % b, b):
            idx = order[s : s + b]
            lay = self._apply_transforms(self.dataset.get_layouts(idx))
            yield {"layout": Layout.fromdict(lay), "id": self.dataset.get_ids(idx),
                   "indices": idx, "image": self.dataset.get_images(idx, dtype=self.image_dtype)}
