"""Retrieval-augmented batch loading, the counterpart of
`ralf_tpu/retrieval/wrapper.py`: every batch gains
batch['retrieved'] = {k: [B, K, S]} from one precomputed top-k table, plus
the gathered rows of the frozen-FIDNet feature table when one is given."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ralf_tpu_torch.data.dataset import BatchLoader
from ralf_tpu_torch.retrieval.retriever import Retriever


class RetrievalAugmentedLoader:
    def __init__(self, loader: BatchLoader, retriever: Retriever, top_k: int = 16,
                 is_train_split: bool = False, table: Optional[np.ndarray] = None,
                 feats_table: Optional[np.ndarray] = None) -> None:
        self.loader = loader
        self.retriever = retriever
        self.top_k = top_k
        self.feats_table = feats_table  # [G, 256] (RALFGenerator.precompute_retrieved_feats)
        if table is None:
            table = retriever.precompute_table(loader.dataset, top_k,
                                               is_train_split=is_train_split)
        self.table = table

    def __iter__(self) -> Iterator[dict]:
        for batch in self.loader:
            nbrs = self.table[batch["indices"]][:, : self.top_k]
            batch["retrieved"] = self.retriever.gather_neighbors(nbrs)
            if self.feats_table is not None:
                batch["retrieved"]["feats"] = self.feats_table[nbrs]
            batch["retrieved_indices"] = nbrs
            yield batch
