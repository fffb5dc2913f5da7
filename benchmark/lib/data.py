"""Inputs made from the run's seed: layouts (the gallery's and the pool
canvases' own), each canvas's top-k neighbours in the gallery, and the
canvases themselves; for training, a split of layouts with its canvases
and its own top-k table.  One seed gives the same inputs on every run; the
port and the plain reference are handed the same arrays.

Layouts: 1 to S elements (uniform), labels uniform over the dataset's
classes, widths and heights uniform in [0.05, 0.6] and [0.03, 0.4],
centres uniform where the box stays on the canvas.  Neighbours: k distinct
gallery rows a canvas, uniform (the reference ships its retrieval tables as
files; their content is set-up input, not traffic).  Canvases: uint8
RGB and saliency, uniform noise drawn on the card in one call."""

from __future__ import annotations

import numpy as np

from benchmark.lib.weights import subseed


def layouts(n: int, S: int, num_labels: int, rng: np.random.Generator) -> dict:
    """{'label', 'center_x', 'center_y', 'width', 'height', 'mask'} [n, S]."""
    count = rng.integers(1, S + 1, n)
    mask = np.arange(S)[None, :] < count[:, None]
    w = rng.uniform(0.05, 0.6, (n, S))
    h = rng.uniform(0.03, 0.4, (n, S))
    cx = w / 2 + rng.uniform(0, 1, (n, S)) * (1 - w)
    cy = h / 2 + rng.uniform(0, 1, (n, S)) * (1 - h)
    out = {"label": rng.integers(0, num_labels, (n, S)) * mask}
    for k, v in (("center_x", cx), ("center_y", cy), ("width", w), ("height", h)):
        out[k] = (v * mask).astype(np.float32)
    out["mask"] = mask
    return out


def neighbours(n: int, gallery: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """[n, k] distinct gallery rows a canvas."""
    return np.stack([rng.choice(gallery, k, replace=False) for _ in range(n)])


def take(arrays: dict, idx: np.ndarray) -> dict:
    """The rows `idx` (any shape) of each [N, S] array: [*idx.shape, S]."""
    return {key: v[idx] for key, v in arrays.items()}


def canvases(torch, n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """[n, h, w, 4] uint8 in host memory, drawn on `device`."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, "canvases"))
    x = torch.randint(0, 256, (n, h, w, 4), generator=g, device=device, dtype=torch.uint8)
    return x.cpu().numpy()


def split_neighbours(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """[n, k] distinct rows of a split of n for each of its rows, never the
    row itself (a train split retrieves within itself): row i takes
    i + 1 + s_i + t_i j (mod n), j < k, for a start s_i and a stride t_i
    drawn for each row; vectorised, as n is a whole split."""
    t = rng.integers(1, (n - 1) // k + 1, n)
    s = (rng.random(n) * (n - 1 - t * (k - 1))).astype(np.int64)
    offsets = s[:, None] + t[:, None] * np.arange(k)[None, :]
    return (np.arange(n)[:, None] + 1 + offsets) % n


class Split:
    """A dataset the port's BatchLoader reads: the split's layouts [n, S]
    and a pool of canvases, row i drawing canvas i mod pool."""

    def __init__(self, layouts: dict, canvases: np.ndarray) -> None:
        self.layouts, self.canvases = layouts, canvases

    def __len__(self) -> int:
        return self.layouts["label"].shape[0]

    def get_layouts(self, indices: np.ndarray) -> dict:
        return take(self.layouts, np.asarray(indices))

    def get_ids(self, indices: np.ndarray) -> np.ndarray:
        return np.asarray(indices, np.int64)

    def get_images(self, indices: np.ndarray, dtype=np.float32) -> np.ndarray:
        x = self.canvases[np.asarray(indices) % len(self.canvases)]
        return x if dtype == np.uint8 else x.astype(np.float32) / 255.0
