"""Relation-constrained decode with batched retries from KV snapshots, the
counterpart of `ralf_tpu/ops/relation_decode.py`.

Generation goes element by element (5 cached decoder steps each).  For each
element the sampler runs `max_retries` candidate attempts, every one from
the same cache snapshot, decodes each candidate's geometry on the device,
counts the relation clauses it violates against the accepted prefix (plus
out-of-vocabulary geometry), and keeps per row the first attempt with the
fewest violations; retries sample at `retry_temperature`.  Every attempt
runs for every row, as in the JAX package.

The port's decoder step writes its caches in place (`models/nn.py`), where
JAX works on immutable snapshots: each attempt therefore starts from a copy
of the element's snapshot, and the best attempt's caches are picked per row
with `torch.where` over every cache tensor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ralf_tpu_torch.core.conditioning import Condition
from ralf_tpu_torch.core.relationships import REL_SIZE_ALPHA, RelLoc, RelSize
from ralf_tpu_torch.core.sampling import NEG_INF, SamplingConfig, sample
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer
from ralf_tpu_torch.models.nn import TokenDecoder

MAX_CONSTRAINTS = 16  # per element; 10% sampling yields 1-2 on average
CANVAS = -1
GEO_SHORT = (("center_x", "cx"), ("center_y", "cy"), ("width", "w"), ("height", "h"))


def build_relation_tensors(cond: Condition, S: int) -> dict:
    """Sampled clauses -> fixed-shape per-element constraint tensors
    {anchor_a, anchor_b, rel (int64), valid (bool)} each [B, S, 16].  A clause
    (label_A, ea, rel, label_B, eb) is checked while element max(ea, eb) is
    generated (its own element for a canvas clause); letters map to
    positions (A -> element 0)."""
    rels = cond.sampled_relations or []
    B = len(rels) if rels else len(cond.image)
    a = np.zeros((B, S, MAX_CONSTRAINTS), np.int64)
    b = np.zeros((B, S, MAX_CONSTRAINTS), np.int64)
    r = np.zeros((B, S, MAX_CONSTRAINTS), np.int64)
    valid = np.zeros((B, S, MAX_CONSTRAINTS), bool)
    counts = np.zeros((B, S), np.int64)
    for bi, clauses in enumerate(rels):
        for la, ea, rel, lb, eb in clauses:
            i = ord(ea) - ord("A")
            j = CANVAS if lb == "canvas" else ord(eb) - ord("A")
            if i >= S or (j != CANVAS and j >= S):
                continue
            anchor = i if j == CANVAS else max(i, j)
            c = counts[bi, anchor]
            if c >= MAX_CONSTRAINTS:
                continue
            a[bi, anchor, c], b[bi, anchor, c], r[bi, anchor, c] = i, j, int(rel)
            valid[bi, anchor, c] = True
            counts[bi, anchor] = c + 1
    out = {"anchor_a": a, "anchor_b": b, "rel": r, "valid": valid}
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _detect_size(area_a: torch.Tensor, area_b: torch.Tensor) -> torch.Tensor:
    eq = (area_b > (1 - REL_SIZE_ALPHA) * area_a) & (area_b < (1 + REL_SIZE_ALPHA) * area_a)
    larger = torch.where(area_a < area_b, int(RelSize.LARGER), int(RelSize.SMALLER))
    return torch.where(eq, int(RelSize.EQUAL), larger)


def _detect_loc(la, ta, ra, ba, lb, tb, rb, bb) -> torch.Tensor:
    out = torch.where(ra <= lb, int(RelLoc.RIGHT), int(RelLoc.CENTER))
    out = torch.where(rb <= la, int(RelLoc.LEFT), out)
    out = torch.where(ba <= tb, int(RelLoc.BOTTOM), out)
    return torch.where(bb <= ta, int(RelLoc.TOP), out)  # the first test that holds wins


def _detect_canvas(cy: torch.Tensor) -> torch.Tensor:
    return torch.where(cy < 1 / 3, int(RelLoc.TOP),
                       torch.where(cy < 2 / 3, int(RelLoc.CENTER), int(RelLoc.BOTTOM)))


def count_violations(geo: dict, elem_idx: torch.Tensor, tensors: dict) -> torch.Tensor:
    """[B] violated-clause count of the element being generated.  geo:
    {'cx', 'cy', 'w', 'h'} [B, S] of the accepted geometry with the
    candidate written at elem_idx [B]."""
    def at(t):  # [B, S, C] -> the row of elem_idx, [B, C]
        return torch.gather(t, 1, elem_idx[:, None, None].expand(-1, 1, t.shape[2]))[:, 0]

    a_at, b_at, rel_at, val_at = (at(tensors[k]) for k in ("anchor_a", "anchor_b", "rel", "valid"))
    is_canvas = b_at == CANVAS
    b_safe = b_at.clamp_min(0)

    def gather(key, idx):  # geo [B, S] at idx [B, C]
        return torch.gather(geo[key], 1, idx)

    cx_a, cy_a, w_a, h_a = (gather(k, a_at) for k in ("cx", "cy", "w", "h"))
    cx_b, cy_b, w_b, h_b = (gather(k, b_safe) for k in ("cx", "cy", "w", "h"))
    area_a, area_b = w_a * h_a, w_b * h_b
    det_size = _detect_size(area_a, torch.where(is_canvas, torch.ones_like(area_b), area_b))
    det_loc = _detect_loc(
        cx_a - w_a / 2, cy_a - h_a / 2, cx_a + w_a / 2, cy_a + h_a / 2,
        cx_b - w_b / 2, cy_b - h_b / 2, cx_b + w_b / 2, cy_b + h_b / 2,
    )
    det_loc = torch.where(is_canvas, _detect_canvas(cy_a), det_loc)
    detected = torch.where(rel_at <= int(RelSize.LARGER), det_size, det_loc)
    return (val_at & (detected != rel_at)).sum(dim=1)


def _clone_cache(cache: dict) -> dict:
    return {k: [t.clone() for t in ts] for k, ts in cache.items()}


@torch.inference_mode()
def relation_aware_decode(
    decoder: TokenDecoder,
    memory: torch.Tensor,  # [B, M, D]
    tokenizer: LayoutSequenceTokenizer,
    forced: torch.Tensor,  # [B, 5S] label forcing from the relation condition
    tensors: dict,  # build_relation_tensors; moved to the memory's device
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    max_retries: int = 8,
    retry_temperature: float = 1.5,
    kv_quant: bool = False,  # int8 shared cross-memory, as in ar_decode
    self_quant: bool = False,  # int8 per-token self caches, as in ar_decode
    q8_mxu: bool = False,  # with kv_quant: K4 instead of K3, as in ar_decode
) -> torch.Tensor:
    """Token sequences [B, 5S] (int64).  With max_retries=0 no attempt runs
    and every token is 0, as in the JAX package."""
    B, dev = memory.shape[0], memory.device
    S = tokenizer.max_seq_length
    Cvar = tokenizer.N_var_per_element
    L = tokenizer.max_token_length
    V = tokenizer.N_total
    var_order = list(tokenizer.config.var_order)
    dtype = decoder.emb.weight.dtype
    token_ok = torch.as_tensor(tokenizer.token_mask, device=dev)
    centers = {k: torch.as_tensor(tokenizer.bucketizers[k].centers, device=dev)
               for k, _ in GEO_SHORT}
    offs = {k: tokenizer.geo_offset(k) for k, _ in GEO_SHORT}
    nbin = tokenizer.N_bbox_per_var
    label_col = var_order.index("label")
    forced = forced.to(device=dev, dtype=torch.long)
    tensors = {k: t.to(dev) for k, t in tensors.items()}

    cache = decoder.stack.init_cache(B, L, self_quant, dtype=dtype, device=dev)
    cross = decoder.stack.cross_kv(memory, kv_quant, dtype=dtype)
    positions = torch.arange(L, device=dev)
    vocab_iota = torch.arange(V, device=dev)

    def run_segment(cache, prev, elem, temperature):
        """Decode one element's Cvar tokens, writing `cache` in place."""
        toks = []
        for s in range(Cvar):
            t = elem * Cvar + s
            keep = (positions <= t)[None, :].expand(B, L)  # no pad is fed before EOS here
            x = decoder.embed_step(prev, t)
            x = decoder.stack.step(x, t, cache, cross, keep, None, q8_mxu)
            logits = decoder.head(x)[:, 0].float()
            logits = torch.where(token_ok[t][None], logits, NEG_INF)
            f = forced[:, t]
            flog = torch.where(vocab_iota[None] == f[:, None], 0.0, NEG_INF)
            logits = torch.where((f >= 0)[:, None], flog, logits)
            prev = sample(logits, sampling, generator, temperature=sampling.temperature * temperature)
            toks.append(prev)
        return prev, torch.stack(toks, dim=1)  # [B, Cvar]

    def bins(toks, gk):  # [B] bin index of attribute gk (out of range for a non-bin token)
        return toks[:, var_order.index(gk)] - offs[gk]

    def tokens_to_geo(toks, elem, geo):
        new = {}
        for gk, short in GEO_SHORT:
            new[short] = geo[short].clone()
            new[short][:, elem] = centers[gk][bins(toks, gk).clamp(0, nbin - 1)]
        return new

    prev = torch.full((B,), tokenizer.bos_id, dtype=torch.long, device=dev)
    geo = {short: torch.zeros((B, S), device=dev) for _, short in GEO_SHORT}
    out = []
    for elem in range(S):
        best_cache, best_prev = cache, prev
        best_toks = torch.zeros((B, Cvar), dtype=torch.long, device=dev)
        best_viol = torch.full((B,), 10**6, dtype=torch.long, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for r in range(max_retries):
            cand_cache = _clone_cache(cache)
            cand_prev, cand_toks = run_segment(cand_cache, prev, elem,
                                               retry_temperature if r > 0 else 1.0)
            viol = count_violations(tokens_to_geo(cand_toks, elem, geo),
                                    torch.full((B,), elem, device=dev), tensors)
            # out-of-vocabulary geometry (pad / eos in a geometry slot) decodes
            # to nothing and breaks the element's clauses at evaluation
            oov = sum(((bins(cand_toks, gk) < 0) | (bins(cand_toks, gk) >= nbin)).long()
                      for gk, _ in GEO_SHORT)
            viol = viol + torch.where(cand_toks[:, label_col] < tokenizer.N_label, oov, 0)
            better = ~done & (viol < best_viol)
            best_cache = {k: [torch.where(better.view(B, *(1,) * (c.dim() - 1)), c, o)
                              for c, o in zip(cand_cache[k], best_cache[k])]
                          for k in cache}
            best_prev = torch.where(better, cand_prev, best_prev)
            best_toks = torch.where(better[:, None], cand_toks, best_toks)
            best_viol = torch.where(better, viol, best_viol)
            done = done | (best_viol == 0)
        cache, prev = best_cache, best_prev
        geo = tokens_to_geo(best_toks, elem, geo)
        out.append(best_toks)
    return torch.stack(out, dim=1).reshape(B, L)
