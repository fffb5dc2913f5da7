"""The top-1 retrieval copy baseline as a generator, the counterpart of
`ralf_tpu/models/retriever_baseline.py`: a model with no parameters that
answers every canvas with the layout of its nearest gallery canvas
(`Retriever.predict_top1`, saliency thumbnails on the device).  Built over
the train split; a cross-dataset run builds it over another dataset's."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.retrieval.retriever import Retriever


class RetrieverGenerator:
    def __init__(self, retriever: Retriever) -> None:
        self.retriever = retriever
        self.device = retriever.device
        self.tokenizer = None
        self.task = "uncond"

    @classmethod
    def build(cls, gallery_dataset, backbone: str = "saliency",
              device="cuda") -> "RetrieverGenerator":
        return cls(Retriever.build(gallery_dataset, backbone, device=device))

    def sample(self, batch: dict, rng: Optional[np.random.Generator] = None) -> Layout:
        """The nearest gallery layout of each of the batch's canvases; `rng`
        is not drawn from (the baseline has no randomness)."""
        return self.retriever.predict_top1(np.asarray(batch["image"]))
