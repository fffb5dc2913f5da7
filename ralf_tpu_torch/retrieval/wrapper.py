"""Retrieval-augmented batch loading, the counterpart of
`ralf_tpu/retrieval/wrapper.py`: every batch gains
batch['retrieved'] = {k: [B, K, S]} and batch['retrieved_indices'] [B, K].

The neighbours come from one precomputed top-k table (given, or computed
here for the loader's split; `is_train_split` keeps a canvas from
retrieving itself), or with `random_retrieval` from the same numpy draws as
JAX's ablation.  The neighbours' layouts are gathered by the native library
or, when the loader has use_native=False, by numpy.  With `feats_table` the
batch also carries the gathered rows of the frozen-FIDNet feature table.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ralf_tpu_torch.data.dataset import BatchLoader
from ralf_tpu_torch.retrieval.retriever import Retriever
from ralf_tpu_torch.utils import tracing


class RetrievalAugmentedLoader:
    def __init__(self, loader: BatchLoader, retriever: Retriever, top_k: int = 16,
                 is_train_split: bool = False, random_retrieval: bool = False,
                 table: Optional[np.ndarray] = None, seed: int = 0,
                 feats_table: Optional[np.ndarray] = None) -> None:
        self.loader = loader
        self.retriever = retriever
        self.top_k = top_k
        self._rng = np.random.default_rng(seed)
        self.random_retrieval = random_retrieval
        self.feats_table = feats_table  # [G, 256] (RALFGenerator.precompute_retrieved_feats)
        if table is None and not random_retrieval:
            table = retriever.precompute_table(loader.dataset, top_k,
                                               is_train_split=is_train_split)
        self.table = table

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    def __iter__(self) -> Iterator[dict]:
        n_gallery = self.retriever.features.shape[0]
        for batch in self.loader:
            with tracing.span("data.retrieval"):
                idx = batch["indices"]
                if self.random_retrieval:
                    nbrs = self._rng.integers(0, n_gallery, size=(len(idx), self.top_k))
                else:
                    nbrs = self.table[idx][:, : self.top_k]
                batch["retrieved"] = self.retriever.gather_neighbors(nbrs, self.loader.use_native)
                if self.feats_table is not None:
                    batch["retrieved"]["feats"] = self.feats_table[nbrs]
                batch["retrieved_indices"] = nbrs
            yield batch
