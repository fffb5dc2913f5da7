"""Instance-wise layout transforms, the counterpart of
`ralf_tpu/data/transforms.py` (host-side numpy on one sample's arrays):
`shuffle` (a random permutation of the elements, from the caller's numpy
rng: the GAN and diffusion presets), `sort_label` (stable by label id) and
`sort_lexicographic` (raster order: top edge, then left edge; the AR
presets).  Every transform takes the rng, as in JAX, so that a composition
draws from it in JAX's order."""

from __future__ import annotations

import numpy as np

GEO = ("center_x", "center_y", "width", "height")


def _apply_order(sample: dict, order: np.ndarray) -> dict:
    out = dict(sample)
    for key in ("label", *GEO):
        out[key] = np.asarray(sample[key])[order]
    return out


def shuffle(sample: dict, rng: np.random.Generator) -> dict:
    return _apply_order(sample, rng.permutation(len(sample["label"])))


def sort_label(sample: dict, rng=None) -> dict:
    return _apply_order(sample, np.argsort(np.asarray(sample["label"]), kind="stable"))


def sort_lexicographic(sample: dict, rng=None) -> dict:
    top = np.asarray(sample["center_y"]) - np.asarray(sample["height"]) / 2
    left = np.asarray(sample["center_x"]) - np.asarray(sample["width"]) / 2
    return _apply_order(sample, np.lexsort((left, top)))


TRANSFORMS = {"shuffle": shuffle, "sort_label": sort_label,
              "sort_lexicographic": sort_lexicographic}


def compose(names):
    """The named transforms applied in order, each given the rng; an unknown
    name raises KeyError."""
    fns = [TRANSFORMS[n] for n in names]

    def apply(sample: dict, rng: np.random.Generator) -> dict:
        for fn in fns:
            sample = fn(sample, rng)
        return sample

    return apply
