"""Instance-wise layout transforms, the counterpart of
`ralf_tpu/data/transforms.py` (host-side numpy on one sample's arrays):
`sort_label` (stable by label id) and `sort_lexicographic` (raster order:
top edge, then left edge), the two the sample path's loader applies."""

from __future__ import annotations

import numpy as np

GEO = ("center_x", "center_y", "width", "height")


def _apply_order(sample: dict, order: np.ndarray) -> dict:
    out = dict(sample)
    for key in ("label", *GEO):
        out[key] = np.asarray(sample[key])[order]
    return out


def sort_label(sample: dict) -> dict:
    return _apply_order(sample, np.argsort(np.asarray(sample["label"]), kind="stable"))


def sort_lexicographic(sample: dict) -> dict:
    top = np.asarray(sample["center_y"]) - np.asarray(sample["height"]) / 2
    left = np.asarray(sample["center_x"]) - np.asarray(sample["width"]) / 2
    return _apply_order(sample, np.lexsort((left, top)))


TRANSFORMS = {"sort_label": sort_label, "sort_lexicographic": sort_lexicographic}


def compose(names):
    """The named transforms applied in order; an unknown name raises KeyError."""
    fns = [TRANSFORMS[n] for n in names]

    def apply(sample: dict) -> dict:
        for fn in fns:
            sample = fn(sample)
        return sample

    return apply
