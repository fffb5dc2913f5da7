"""Task conditioning, the counterpart of `ralf_tpu/core/conditioning.py`.

Host-side numpy with an explicit numpy `rng`, drawn from in the same order
as the JAX package, so that the same seed gives identical conditions:

  * `get_condition` builds the per-task partial token sequence (-1 marks
    an unknown slot) for `uncond`, `partial`, `c`, `cwh`, `relation`, `gt`
    and `refinement`;
  * `build_constraint_sequence` serialises the user constraint into the
    constraint encoder's own token language (task tokens, `sep`, relation
    clauses);
  * `build_forced_tokens` collapses the per-task decode restriction into
    one `forced [B, L]` array (-1 free, else the token the step must emit)
    that the decode loop consumes on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ralf_tpu_torch.core.layout import GEO_KEYS, Layout
from ralf_tpu_torch.core.relationships import (
    RelLoc,
    RelSize,
    compute_relation,
    describe_relationships,
)
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer

MASK_ID = -1  # unknown-slot / free-step marker
REFINEMENT_NOISE_STD = 0.01
RELATION_SIZE = 10  # percent of the relation clauses sampled as conditions

COND_TYPES = ("c", "cwh", "partial", "gt", "refinement", "relation", "none", "uncond")

# attributes each task fixes
TASK_VARS = {
    "c": ("label",),
    "cwh": ("label", "width", "height"),
    "relation": ("label",),
    "refinement": ("label", "width", "height", "center_x", "center_y"),
    "partial": ("label", "width", "height", "center_x", "center_y"),
}

TASK_TOKENS = (
    "end_of_task", "label", "label_size", "relationship", "refinement",
    "completion", "uncondition",
)
CONST_SPECIAL_TOKENS = ("sep", "relation_sep", "canvas")
TASK_OF = {
    "uncond": "uncondition",
    "c": "label",
    "cwh": "label_size",
    "gt": "uncondition",  # full copy-through: no constraint head of its own
    "partial": "completion",
    "refinement": "refinement",
    "relation": "relationship",
}


def normalize_task(task: Optional[str]) -> str:
    return "uncond" if task in (None, "none", "uncond") else task


@dataclasses.dataclass
class Condition:
    """Fixed-shape conditioning bundle handed to a generator."""

    image: Any  # [B, H, W, 4]: float32 in [0, 1] or uint8
    task: str
    seq: Optional[np.ndarray] = None  # [B, 1+5S] int32, -1 = unknown
    seq_mask: Optional[np.ndarray] = None  # [B, 1+5S] bool, True = known
    const_seq: Optional[np.ndarray] = None  # [B, Lc] int32
    const_mask: Optional[np.ndarray] = None  # [B, Lc] bool, True = valid
    retrieved: Optional[dict] = None  # retrieval arrays (RALF)
    edges: Optional[dict] = None  # relation bitmask edges
    relations: Optional[list] = None  # every relation clause per sample
    sampled_relations: Optional[list] = None  # the clauses conditioned on
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
            + [f"loc_{r.name}" for r in RelLoc]
            + [f"size_{r.name}" for r in RelSize]
        )
        self._extra = {t: tokenizer.N_total + i for i, t in enumerate(self.extra_tokens)}

    @property
    def N_total(self) -> int:
        return self.tokenizer.N_total + len(self.extra_tokens)

    def id(self, name: str) -> int:
        if name in self._extra:
            return self._extra[name]
        return self.tokenizer.name_to_id(name)

    def elem_id(self, letter_index: int) -> int:
        return self._extra[f"elem_{letter_index}"]

    def rel_id(self, rel) -> int:
        kind = "loc" if isinstance(rel, RelLoc) else "size"
        return self._extra[f"{kind}_{rel.name}"]

    def const_len(self, task: str) -> int:
        """Static constraint-sequence length of a task (its worst case)."""
        S = self.tokenizer.max_seq_length
        task = normalize_task(task)
        if task in ("uncond", "gt"):
            return 4  # bos task end_of_task eos
        n_var = len(TASK_VARS[task])
        body = n_var if task == "partial" else n_var * S + (S - 1)  # tokens + separators
        n = 4 + body
        if task == "relation":
            # worst-case sampled clauses, 6 tokens each
            total_rel = S * (S - 1) + S  # location and size pairs, and the canvas
            n += (total_rel * RELATION_SIZE // 100 + 1) * 6
        return n


def _lookup_relationships(relationships: Optional[dict], ids: Optional[np.ndarray],
                          layout: Layout) -> list:
    """Per-sample clause lists: from a precomputed {str(id): clauses} table
    when it holds every row of the batch, else computed from the layout."""
    if relationships is None or ids is None:
        return describe_relationships(layout)
    rows = [str(i) for i in np.asarray(ids).tolist()]
    if all(r in relationships for r in rows):
        return [relationships[r] for r in rows]
    return describe_relationships(layout)


def get_condition(layout: Layout, image: Any, task: Optional[str],
                  tokenizer: LayoutSequenceTokenizer, rng: np.random.Generator,
                  ids: Optional[np.ndarray] = None, retrieved: Optional[dict] = None,
                  relationships: Optional[dict] = None) -> tuple[Condition, Layout]:
    """(condition, target layout) of a task.  The target is the layout the
    training loss encodes: for refinement the NOISED layout."""
    if task not in COND_TYPES and task is not None:
        raise ValueError(f"unknown task {task!r}; one of {COND_TYPES}")
    task_n = normalize_task(task)
    enc = tokenizer.encode(layout)
    seq = enc["seq"].cpu().numpy().astype(np.int32)
    mask = enc["mask"].cpu().numpy()
    B, T = seq.shape
    C = tokenizer.N_var_per_element
    pad_id = tokenizer.pad_id
    # AR tokenizers prepend BOS; tokenizers without BOS mark unknowns with [MASK]
    off = 1 if tokenizer.has_bos_eos else 0
    sp = tokenizer.config.special_tokens
    mask_id = tokenizer.name_to_id("mask") if "mask" in sp else MASK_ID

    cond = Condition(image=image, task=task_n, ids=ids, retrieved=retrieved)
    target = layout

    if task_n == "partial":
        # keep (BOS and) the first element's tokens, everything else unknown
        new_seq = np.full_like(seq, mask_id)
        new_mask = np.zeros_like(mask)
        new_seq[:, : off + C] = seq[:, : off + C]
        new_mask[:, : off + C] = True
        cond.seq, cond.seq_mask = new_seq, new_mask
    elif task_n in ("c", "cwh", "relation"):
        if task_n == "relation":
            cond.edges = compute_relation(layout, rng)
            cond.relations = _lookup_relationships(relationships, ids, layout)
        attr_ind = (np.arange(T) - off) % C
        keep = np.zeros((B, T), bool)
        keep[:, :off] = True  # BOS
        var_order = list(tokenizer.config.var_order)
        for attr in TASK_VARS[task_n]:
            keep |= (attr_ind == var_order.index(attr))[None, :]
        seq_c = np.where(keep, seq, mask_id)
        cond.seq = np.where(mask, seq_c, pad_id)  # the element count is given
        cond.seq_mask = (mask & keep) | ~mask
    elif task_n == "gt":
        cond.seq, cond.seq_mask = seq, mask
    elif task_n == "refinement":
        lay = layout.numpy()
        noisy = {}
        for key in GEO_KEYS:
            v = np.clip(lay[key] + rng.normal(0, REFINEMENT_NOISE_STD, lay[key].shape), 0.0, 1.0)
            noisy[key] = np.where(lay["mask"], v, 0.0).astype(np.float32)
        target = Layout.fromdict({**lay, **noisy}, device=layout.label.device)
        cond.seq = tokenizer.encode(target)["seq"].cpu().numpy().astype(np.int32)
        cond.seq_mask = mask  # every given position is trusted
    return cond, target


def _parse_cond_elements(cond_seq: np.ndarray, tokenizer: LayoutSequenceTokenizer
                         ) -> tuple[np.ndarray, np.ndarray]:
    """cond seq [B, 1+5S] -> (per-var token table [B, 5, S] in var_order,
    valid [B, S]); an element whose label slot holds pad / eos / unknown is
    invalid."""
    tok = tokenizer
    off = 1 if tok.has_bos_eos else 0
    body = cond_seq[:, off:].reshape(cond_seq.shape[0], tok.max_seq_length, -1)
    body = np.swapaxes(body, 1, 2)  # [B, C, S]
    labels = body[:, list(tok.config.var_order).index("label")]
    valid = (labels != tok.pad_id) & (labels != MASK_ID)
    if tok.has_bos_eos:
        valid &= labels != tok.eos_id
    if "mask" in tok.config.special_tokens:
        valid &= labels != tok.name_to_id("mask")
    return body, valid


def build_constraint_sequence(cond: Condition, vocab: ConstraintVocabulary,
                              rng: np.random.Generator, shuffle: Optional[bool] = None
                              ) -> tuple[np.ndarray, np.ndarray]:
    """(const_seq [B, Lc] int32, const_mask [B, Lc]) =
    [bos, <task>, end_of_task, BODY..., eos, pad...], the body `sep`-separated
    per-element groups; relation adds `relation_sep` and clause groups.
    c / partial / relation shuffle the elements (one permutation of `rng`
    per row), and relation draws its clauses from `rng` too."""
    tok = vocab.tokenizer
    task = normalize_task(cond.task)
    Lc = vocab.const_len(task)
    pad, bos, eos = tok.pad_id, tok.bos_id, tok.eos_id
    sep = vocab.id("sep")
    B = len(cond.image) if cond.seq is None else cond.seq.shape[0]
    out = np.full((B, Lc), pad, np.int32)
    head = [bos, vocab.id(TASK_OF[task]), vocab.id("end_of_task")]
    if shuffle is None:
        shuffle = task in ("c", "partial", "relation")

    if task in ("uncond", "gt"):
        row = head + [eos]
        out[:, : len(row)] = row
        return out, out != pad

    var_order = list(tok.config.var_order)
    body_rows = [var_order.index(v) for v in TASK_VARS[task]]
    table, valid = _parse_cond_elements(cond.seq, tok)
    for b in range(B):
        idx = np.nonzero(valid[b])[0]
        if shuffle and len(idx) > 1:
            idx = rng.permutation(idx)
        body: list[int] = []
        for gi, e in enumerate(idx):
            if gi:
                body.append(sep)
            body.extend(int(table[b, r, e]) for r in body_rows)

        if task == "relation":
            body.append(vocab.id("relation_sep"))
            rels = cond.relations[b] if cond.relations else []
            n_sample = max(len(rels) * RELATION_SIZE // 100, 1)
            if cond.sampled_relations is None:
                cond.sampled_relations = [[] for _ in range(B)]
            if len(rels) > 0:
                chosen = [rels[i] for i in rng.permutation(len(rels))[:n_sample]]
                cond.sampled_relations[b] = chosen
                for ci, (la, ea, rel, lb, eb) in enumerate(chosen):
                    if ci:
                        body.append(sep)
                    body.extend([
                        int(la),
                        vocab.elem_id(ord(ea) - ord("A")),
                        vocab.rel_id(rel),
                        vocab.id("canvas") if lb == "canvas" else int(lb),
                        pad if eb == "pad" else vocab.elem_id(ord(eb) - ord("A")),
                    ])

        row = head + body + [eos]
        assert len(row) <= Lc, (task, len(row), Lc)
        out[b, : len(row)] = row
    return out, out != pad


def build_forced_tokens(cond: Condition, tokenizer: LayoutSequenceTokenizer) -> np.ndarray:
    """forced [B, L] int32: -1 where step t samples freely, else the token
    step t must emit.
      c / cwh / gt: every known condition token (positions at and after the
                    condition's first pad force EOS);
      refinement / relation: the same at label slots only;
      partial: the kept first element verbatim;
      uncond: free."""
    assert tokenizer.has_bos_eos, "forced-token decode is for AR tokenizers"
    L = tokenizer.max_token_length
    C = tokenizer.N_var_per_element
    task = normalize_task(cond.task)
    if cond.seq is None or task == "uncond":
        return np.full((len(cond.image), L), MASK_ID, np.int32)
    body = cond.seq[:, 1:].astype(np.int32)  # [B, L]
    forced = np.where(body == tokenizer.pad_id, tokenizer.eos_id, body)
    if task in ("refinement", "relation"):
        label_slot = (np.arange(L) % C) == 0
        forced = np.where(label_slot[None, :], forced, MASK_ID)
    elif task == "partial":
        forced = np.full_like(body, MASK_ID)
        forced[:, :C] = body[:, :C]
    return forced.astype(np.int32)
