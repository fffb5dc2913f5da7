"""Layout <-> token-sequence codec, the counterpart of `ralf_tpu/core/tokenizer.py`.

A layout flattens into (label_1, v1_1, .., v4_1, label_2, ...) in
`var_order`, geometry quantized into `num_bin` linear bins with a
per-attribute ("unshared") or shared location vocabulary.  Vocabulary::

    [0, N_label)                          element classes
    [N_label, N_label + N_bbox)           geometry bins (per attribute: offset by GEO_KEYS index)
    [N_label + N_bbox, N_total)           special tokens (pad, bos, eos[, mask])

Every shape is static: sequences always hold max_seq_length elements.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ralf_tpu_torch.core.bucketizer import Bucketizer, linear_bucketizer
from ralf_tpu_torch.core.layout import GEO_KEYS, Layout

SPECIAL_TOKENS = ("pad", "bos", "eos", "mask")
DEFAULT_VAR_ORDER = ("label", "width", "height", "center_x", "center_y")


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    num_labels: int = 3
    max_seq_length: int = 10
    num_bin: int = 128
    var_order: Sequence[str] = DEFAULT_VAR_ORDER
    special_tokens: Sequence[str] = ("pad", "bos", "eos")
    is_loc_vocab_shared: bool = False

    def __post_init__(self) -> None:
        assert "pad" in self.special_tokens
        assert all(t in SPECIAL_TOKENS for t in self.special_tokens)
        if "mask" in self.special_tokens:
            assert self.special_tokens[-1] == "mask"
        assert set(self.var_order) == {"label", *GEO_KEYS}


class LayoutSequenceTokenizer:
    def __init__(self, config: TokenizerConfig) -> None:
        self.config = config
        self.bucketizers: dict[str, Bucketizer] = {
            key: linear_bucketizer(config.num_bin) for key in GEO_KEYS
        }

    # ---- vocabulary arithmetic -------------------------------------------

    @property
    def N_label(self) -> int:
        return self.config.num_labels

    @property
    def N_bbox_per_var(self) -> int:
        return self.config.num_bin

    @property
    def N_bbox(self) -> int:
        return self.N_bbox_per_var * (1 if self.config.is_loc_vocab_shared else 4)

    @property
    def N_sp_token(self) -> int:
        return len(self.config.special_tokens)

    @property
    def N_total(self) -> int:
        return self.N_label + self.N_bbox + self.N_sp_token

    @property
    def N_var_per_element(self) -> int:
        return len(self.config.var_order)

    @property
    def max_seq_length(self) -> int:
        return self.config.max_seq_length

    @property
    def max_token_length(self) -> int:
        """Generated tokens per layout (no BOS): 5 * S."""
        return self.max_seq_length * self.N_var_per_element

    def name_to_id(self, name: str) -> int:
        return self.N_label + self.N_bbox + list(self.config.special_tokens).index(name)

    @property
    def pad_id(self) -> int:
        return self.name_to_id("pad")

    @property
    def bos_id(self) -> int:
        return self.name_to_id("bos")

    @property
    def eos_id(self) -> int:
        return self.name_to_id("eos")

    @property
    def has_bos_eos(self) -> bool:
        st = self.config.special_tokens
        return "bos" in st and "eos" in st

    def geo_offset(self, key: str) -> int:
        if self.config.is_loc_vocab_shared:
            return self.N_label
        return self.N_label + GEO_KEYS.index(key) * self.N_bbox_per_var

    # ---- encode / decode -------------------------------------------------

    def encode(self, layout: Layout) -> dict[str, torch.Tensor]:
        """Layout [B, S] -> {'seq': int64 [B, T], 'mask': bool [B, T]}, with
        T = 5S + 1 when BOS/EOS exist (EOS in the first padded slot)."""
        cfg = self.config
        S, C = cfg.max_seq_length, self.N_var_per_element
        assert layout.label.shape[1] == S, (layout.label.shape, S)
        elem_mask = layout.mask
        pad = torch.full_like(layout.label, self.pad_id)
        cols = {"label": torch.where(elem_mask, layout.label, pad)}
        for key in GEO_KEYS:
            tok = self.bucketizers[key].encode(layout.geo(key)) + self.geo_offset(key)
            cols[key] = torch.where(elem_mask, tok, pad)
        seq = torch.stack([cols[k] for k in cfg.var_order], dim=-1).reshape(-1, S * C)
        mask = elem_mask.repeat_interleave(C, dim=-1)
        if self.has_bos_eos:
            B = seq.shape[0]
            n_tokens = elem_mask.sum(dim=-1) * C
            pos = torch.arange(S * C, device=seq.device)[None, :]
            eos_here = pos == n_tokens[:, None]  # empty when the layout is full
            seq = torch.where(eos_here, torch.full_like(seq, self.eos_id), seq)
            mask = mask | eos_here
            bos = torch.full((B, 1), self.bos_id, dtype=seq.dtype, device=seq.device)
            seq = torch.cat([bos, seq], dim=-1)
            mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=-1)
        return {"seq": seq, "mask": mask}

    def decode(self, seq: torch.Tensor) -> Layout:
        """int [B, 5S] tokens (no BOS) -> Layout [B, S].  Elements at or after
        the first EOS, or holding an out-of-range token, are invalid."""
        cfg = self.config
        S, C = cfg.max_seq_length, self.N_var_per_element
        seq = seq.long().reshape(seq.shape[0], S, C)
        vals = {}
        for i, key in enumerate(cfg.var_order):
            v = seq[..., i]
            vals[key] = v if key == "label" else v - self.geo_offset(key)
        valid = (vals["label"] >= 0) & (vals["label"] < self.N_label)
        bound = self.N_bbox if cfg.is_loc_vocab_shared else self.N_bbox_per_var
        for key in GEO_KEYS:
            valid &= (vals[key] >= 0) & (vals[key] < bound)
        if self.has_bos_eos:
            label_tok = seq[..., list(cfg.var_order).index("label")]
            valid &= ~(torch.cumsum((label_tok == self.eos_id).long(), dim=1) > 0)
        zero = torch.zeros_like(vals["label"])
        geo = {}
        for key in GEO_KEYS:
            centers = self.bucketizers[key].decode(torch.where(valid, vals[key], zero))
            geo[key] = torch.where(valid, centers, torch.zeros_like(centers))
        return Layout(label=torch.where(valid, vals["label"], zero), mask=valid, **geo)

    # ---- static validity table ------------------------------------------

    @property
    def token_mask(self) -> np.ndarray:
        """bool [5S, N_total]: legal vocabulary entries per position.  BOS
        and MASK are never legal; geometry slots admit only their own
        attribute's bins, label slots only classes (+ legal specials)."""
        cfg = self.config
        sp_ok = np.array([t not in ("bos", "mask") for t in cfg.special_tokens], bool)
        per_var = {
            "label": np.concatenate(
                [np.ones(self.N_label, bool), np.zeros(self.N_bbox, bool), sp_ok]
            )
        }
        for key in GEO_KEYS:
            geo = np.zeros(self.N_bbox, bool)
            if cfg.is_loc_vocab_shared:
                geo[:] = True
            else:
                off = GEO_KEYS.index(key) * self.N_bbox_per_var
                geo[off : off + self.N_bbox_per_var] = True
            per_var[key] = np.concatenate([np.zeros(self.N_label, bool), geo, sp_ok])
        rows = np.stack([per_var[k] for k in cfg.var_order], axis=0)  # [C, V]
        return np.tile(rows, (cfg.max_seq_length, 1))
