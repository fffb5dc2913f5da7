"""Constraint-violation measurement, the counterpart of
`ralf_tpu/eval/violations.py`:

  * c / cwh / refinement: token equality between the condition and the
    generated sequence at the known positions (label slots only for
    refinement);
  * relation: every conditioned clause re-detected on the generated layout;
  * uncond / partial / gt: nothing to violate.

Each returns {'total', 'viorated'} (sic, the reference's column name).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ralf_tpu_torch.core.conditioning import MASK_ID, Condition, normalize_task
from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.core.relationships import (
    RelSize,
    detect_canvas_relation,
    detect_loc_relation,
    detect_size_relation,
)
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer
from ralf_tpu_torch.utils import tracing


def calculate_violation(cond: Condition, seq, layout: Optional[Layout],
                        tokenizer: LayoutSequenceTokenizer) -> dict[str, int]:
    """seq: the generated tokens [B, 5S] (no BOS), a tensor or an array."""
    with tracing.span("eval.violations"):
        task = normalize_task(cond.task)
        if task in ("uncond", "partial", "gt"):
            return {"total": 1, "viorated": 0}
        if task == "relation":
            assert layout is not None
            return calculate_relation_violation(cond, layout)
        off = 1 if tokenizer.has_bos_eos else 0
        ctok = np.asarray(cond.seq)[:, off:]
        known = np.asarray(cond.seq_mask)[:, off:] & (ctok != tokenizer.pad_id) & (ctok != MASK_ID)
        if "mask" in tokenizer.config.special_tokens:
            known &= ctok != tokenizer.name_to_id("mask")
        if tokenizer.has_bos_eos:
            known &= ctok != tokenizer.eos_id
        if task == "refinement":
            known &= (np.arange(ctok.shape[1]) % tokenizer.N_var_per_element == 0)[None, :]
        seq = np.asarray(seq.cpu() if hasattr(seq, "cpu") else seq)
        return {"total": int(known.sum()), "viorated": int((seq[known] != ctok[known]).sum())}


def calculate_relation_violation(cond: Condition, layout: Layout) -> dict[str, int]:
    """Re-detect each conditioned clause (the sampled ones, else all) on the
    generated layout, whose elements the clause letters index by position."""
    lay = layout.numpy()
    cx, cy, w, h = (lay[k] for k in ("center_x", "center_y", "width", "height"))
    S = cx.shape[1]

    def ltrb(b, i):
        return (cx[b, i] - w[b, i] / 2, cy[b, i] - h[b, i] / 2,
                cx[b, i] + w[b, i] / 2, cy[b, i] + h[b, i] / 2)

    total = violated = 0
    for b, clauses in enumerate(cond.sampled_relations or cond.relations or []):
        for la, ea, rel, lb, eb in clauses:
            i = ord(ea) - ord("A")
            if i >= S:
                continue
            total += 1
            if lb == "canvas":
                detected = detect_canvas_relation(cy[b, i])
                if isinstance(rel, RelSize):
                    detected = detect_size_relation(w[b, i] * h[b, i], 1.0)
            else:
                j = ord(eb) - ord("A")
                if j >= S:
                    continue
                if isinstance(rel, RelSize):
                    detected = detect_size_relation(w[b, i] * h[b, i], w[b, j] * h[b, j])
                else:
                    detected = detect_loc_relation(ltrb(b, i), ltrb(b, j))
            if detected != rel:
                violated += 1
    return {"total": max(total, 1), "viorated": violated}
