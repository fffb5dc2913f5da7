"""Task conditioning for the `uncond` task, the counterpart of
`ralf_tpu/core/conditioning.py`.

Host-side numpy: a `Condition` bundle, the extended constraint vocabulary
of the constraint encoder, the constraint sequence, and the forced-token
array the decode loop consumes (-1 = free).  Only `uncond` (and its aliases
`none` / None) is ported; the other tasks raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer

MASK_ID = -1  # unknown-slot / free-step marker

TASK_TOKENS = (
    "end_of_task", "label", "label_size", "relationship", "refinement",
    "completion", "uncondition",
)
CONST_SPECIAL_TOKENS = ("sep", "relation_sep", "canvas")
# relation names of the constraint vocabulary, in the JAX package's
# RelLoc / RelSize enum order (core/relationships.py there)
REL_LOC_NAMES = ("UNKNOWN", "LEFT", "TOP", "RIGHT", "BOTTOM", "CENTER")
REL_SIZE_NAMES = ("UNKNOWN", "SMALLER", "EQUAL", "LARGER")
TASK_OF = {"uncond": "uncondition"}


def normalize_task(task: Optional[str]) -> str:
    return "uncond" if task in (None, "none", "uncond") else task


def _require_uncond(task: Optional[str]) -> str:
    task = normalize_task(task)
    if task != "uncond":
        raise NotImplementedError(f"task {task!r}: only 'uncond' is ported")
    return task


@dataclasses.dataclass
class Condition:
    """Fixed-shape conditioning bundle handed to a generator."""

    image: Any  # [B, H, W, 4]: float32 in [0, 1] or uint8
    task: str
    const_seq: Optional[np.ndarray] = None  # [B, Lc] int32
    const_mask: Optional[np.ndarray] = None  # [B, Lc] bool, True = valid
    retrieved: Optional[dict] = None  # retrieval arrays (RALF)
    ids: Optional[np.ndarray] = None


class ConstraintVocabulary:
    """Extended vocabulary of the constraint encoder: the layout tokenizer's
    ids, then task tokens, separators, element letters and relations."""

    def __init__(self, tokenizer: LayoutSequenceTokenizer) -> None:
        self.tokenizer = tokenizer
        S = tokenizer.max_seq_length
        self.extra_tokens = (
            list(TASK_TOKENS)
            + list(CONST_SPECIAL_TOKENS)
            + [f"elem_{i}" for i in range(S)]
            + [f"loc_{n}" for n in REL_LOC_NAMES]
            + [f"size_{n}" for n in REL_SIZE_NAMES]
        )
        self._extra = {t: tokenizer.N_total + i for i, t in enumerate(self.extra_tokens)}

    @property
    def N_total(self) -> int:
        return self.tokenizer.N_total + len(self.extra_tokens)

    def id(self, name: str) -> int:
        if name in self._extra:
            return self._extra[name]
        return self.tokenizer.name_to_id(name)

    def const_len(self, task: str) -> int:
        _require_uncond(task)
        return 4  # bos task end_of_task eos


def get_condition(layout: Layout, image: Any, task: Optional[str],
                  ids: Optional[np.ndarray] = None,
                  retrieved: Optional[dict] = None) -> tuple[Condition, Layout]:
    """(condition, target layout) for `uncond`: nothing of the layout is given."""
    task = _require_uncond(task)
    return Condition(image=image, task=task, ids=ids, retrieved=retrieved), layout


def build_constraint_sequence(cond: Condition, vocab: ConstraintVocabulary
                              ) -> tuple[np.ndarray, np.ndarray]:
    """(const_seq [B, Lc], const_mask [B, Lc]) = [bos, uncondition, end_of_task, eos]."""
    task = _require_uncond(cond.task)
    tok = vocab.tokenizer
    B = len(cond.image)
    row = [tok.bos_id, vocab.id(TASK_OF[task]), vocab.id("end_of_task"), tok.eos_id]
    out = np.full((B, vocab.const_len(task)), tok.pad_id, np.int32)
    out[:, : len(row)] = row
    return out, out != tok.pad_id


def build_forced_tokens(cond: Condition, tokenizer: LayoutSequenceTokenizer) -> np.ndarray:
    """forced [B, L] int32: every step of an `uncond` decode is free (-1)."""
    _require_uncond(cond.task)
    assert tokenizer.has_bos_eos, "forced-token decode is for AR tokenizers"
    B = len(cond.image)
    return np.full((B, tokenizer.max_token_length), MASK_ID, np.int32)
