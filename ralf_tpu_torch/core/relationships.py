"""Pairwise layout relationships (size and location, canvas included), the
counterpart of `ralf_tpu/core/relationships.py`.

  * RelSize: smaller / equal / larger with a +-10% area band;
  * RelLoc between elements: top / bottom / left / right by strict
    separation of the two boxes, else center;
  * RelLoc of an element against the canvas: the third of center_y;
  * `compute_relation`: the sparsified bitmask edge list over (canvas,
    elements) that relation-task conditions carry;
  * `describe_relationships`: every clause
    (label_A, letter_A, relation, label_B or 'canvas', letter_B or 'pad').

Host-side numpy: the output is ragged; the fixed-shape consumers are in
core/conditioning.py and ops/relation_decode.py.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from ralf_tpu_torch.core.layout import Layout

REL_SIZE_ALPHA = 0.1
EDGE_RATIO = 0.1


class RelSize(IntEnum):
    UNKNOWN = 0
    SMALLER = 1
    EQUAL = 2
    LARGER = 3


class RelLoc(IntEnum):
    UNKNOWN = 4
    LEFT = 5
    TOP = 6
    RIGHT = 7
    BOTTOM = 8
    CENTER = 9


# per-sample element identifiers used inside relation clauses
ELEM_LETTERS = tuple("ABCDEFGHIJK")


def detect_size_relation(area_a: float, area_b: float) -> RelSize:
    """Relation of B's area to A's, with a +-alpha equality band."""
    if (1 - REL_SIZE_ALPHA) * area_a < area_b < (1 + REL_SIZE_ALPHA) * area_a:
        return RelSize.EQUAL
    return RelSize.LARGER if area_a < area_b else RelSize.SMALLER


def detect_loc_relation(ltrb_a, ltrb_b) -> RelLoc:
    """Where box B sits relative to box A (strict separation, else CENTER)."""
    la, ta, ra, ba = ltrb_a
    lb, tb, rb, bb = ltrb_b
    if bb <= ta:
        return RelLoc.TOP
    if ba <= tb:
        return RelLoc.BOTTOM
    if rb <= la:
        return RelLoc.LEFT
    if ra <= lb:
        return RelLoc.RIGHT
    return RelLoc.CENTER


def detect_canvas_relation(center_y: float) -> RelLoc:
    """Vertical third of the canvas an element's center falls in."""
    if center_y < 1.0 / 3:
        return RelLoc.TOP
    if center_y < 2.0 / 3:
        return RelLoc.CENTER
    return RelLoc.BOTTOM


def _ltrb(cx, cy, w, h):
    return (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)


def compute_relation(layout: Layout, rng: np.random.Generator,
                     edge_ratio: float = EDGE_RATIO) -> dict[str, np.ndarray]:
    """Sparse bitmask edges over (canvas, elements), each pair kept with
    probability `edge_ratio` (one draw of `rng` per pair, in order).  Index
    0 is the canvas.  edge_indexes int64 [B, E, 2] (-1 fill) and
    edge_attributes int64 [B, E] (a bitmask over RelSize | RelLoc), with
    E = (S + 1)(S + 2) / 2."""
    lay = layout.numpy()
    mask = lay["mask"]
    B, S = mask.shape

    def with_canvas(key, value):
        return np.concatenate([np.full((B, 1), value), lay[key]], 1)

    cx, cy = with_canvas("center_x", 0.5), with_canvas("center_y", 0.5)
    w, h = with_canvas("width", 1.0), with_canvas("height", 1.0)
    aug_n = 1 + mask.sum(1)

    rel_unk = (1 << RelSize.UNKNOWN) | (1 << RelLoc.UNKNOWN)
    E = (S + 1) * (S + 2) // 2
    edge_idx = np.full((B, E, 2), -1, np.int64)
    edge_attr = np.full((B, E), rel_unk, np.int64)
    for b in range(B):
        cnt = 0
        for i in range(aug_n[b]):
            for j in range(i + 1, aug_n[b]):
                if rng.random() > edge_ratio:
                    continue
                rel = 1 << detect_size_relation(w[b, i] * h[b, i], w[b, j] * h[b, j])
                if i == 0:
                    rel |= 1 << detect_canvas_relation(cy[b, j])
                else:
                    rel |= 1 << detect_loc_relation(
                        _ltrb(cx[b, i], cy[b, i], w[b, i], h[b, i]),
                        _ltrb(cx[b, j], cy[b, j], w[b, j], h[b, j]),
                    )
                edge_idx[b, cnt] = (i, j)
                edge_attr[b, cnt] = rel
                cnt += 1
    return {"edge_indexes": edge_idx, "edge_attributes": edge_attr}


def describe_relationships(layout: Layout) -> list[list[tuple]]:
    """Every clause per sample: the location and size clauses of each pair,
    then each element's canvas clause.  Elements take letters over the
    REVERSED valid order (A = the last valid element)."""
    lay = layout.numpy()
    label, mask = lay["label"], lay["mask"]
    B, S = label.shape
    keys = ("center_x", "center_y", "width", "height")
    out = []
    for b in range(B):
        valid = [i for i in range(S) if mask[b, i]][::-1]
        letters = {elem: ELEM_LETTERS[pos] for pos, elem in enumerate(valid)}
        loc_clauses, size_clauses, canvas_clauses = [], [], []
        for idx, i in enumerate(valid):
            bi = tuple(lay[k][b, i] for k in keys)
            a_i = bi[2] * bi[3]
            for j in valid[idx + 1:]:
                bj = tuple(lay[k][b, j] for k in keys)
                loc = detect_loc_relation(_ltrb(*bi), _ltrb(*bj))
                size = detect_size_relation(a_i, bj[2] * bj[3])
                loc_clauses.append((int(label[b, i]), letters[i], loc, int(label[b, j]), letters[j]))
                size_clauses.append((int(label[b, i]), letters[i], size, int(label[b, j]),
                                     letters[j]))
            canvas_clauses.append(
                (int(label[b, i]), letters[i], detect_canvas_relation(bi[1]), "canvas", "pad"))
        out.append(loc_clauses + size_clauses + canvas_clauses)
    return out
