"""FIDNetV3's trainer, the counterpart of `ralf_tpu/train/fid_trainer.py`:
it builds the per-dataset layout feature extractor that layout-FID (and
RALF's retrieval fusion) read.

Half of each batch, drawn at random, gets N(0, 0.05) noise on its geometry
("fake"); the loss is the real/fake BCE of the discriminator head, plus the
label CE over the valid elements, plus 10 times the box squared error
summed over the 4 coordinates, over the valid elements.  AdamW (optax's
`adamw`: b1 0.9, b2 0.999, eps 1e-8) decays every parameter, biases,
LayerNorm scales, embeddings and both tokens included, with no clip and no
schedule: unlike the generators' optimizer (`train/optim.py`), optax's
adamw here has no mask.

FIDNet trains deterministic: JAX's `loss_fn` applies the model with its
default `train=False`, so there is no dropout and every encoder layer takes
K1 (`ops.encoder_attention`) with its key mask, forward and backward
(`ops._build.RecomputedBackward`), 8 calls a step: 4 at S = 1 + S_max (the
CLS token and the elements), 4 at S = S_max (the decoder).

The checkpoint is `<job_dir>/fidnet_ckpt.npz`, the flax tree as a flat
`.npz` (`utils.weights.save_params_npz`), which `cli.evaluate --fidnet-dir`
reads; JAX writes an orbax directory `fidnet_ckpt/` instead (README.md
shows how a JAX job writes the `.npz`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ralf_tpu_torch.core.layout import FIELDS, GEO_KEYS, Layout
from ralf_tpu_torch.models.fidnet import FIDNetV3
from ralf_tpu_torch.utils.device import resolve_device
from ralf_tpu_torch.utils.weights import (
    export_params,
    load_jax_params,
    load_params_npz,
    save_params_npz,
)

logger = logging.getLogger(__name__)

CKPT = "fidnet_ckpt.npz"


def generate_fake_and_real(layout: Layout, rng: np.random.Generator,
                           std: float = 0.05) -> tuple[Layout, np.ndarray]:
    """Perturb a random half of the batch: (layout on the CPU, is_real
    float32 [B]).  The numpy draws of JAX's, in its order: the fake rows
    first, then one normal draw over the whole batch per coordinate; a fake
    row's padded slots become 0."""
    lay = layout.numpy()
    B = lay["label"].shape[0]
    is_fake = rng.integers(0, 2, size=B).astype(bool)
    mask = lay["mask"]

    def noisy(v: np.ndarray) -> np.ndarray:
        out = np.where(mask, v + rng.normal(0, std, v.shape), 0.0)
        return np.where(is_fake[:, None], out, v).astype(np.float32)

    out = Layout.fromdict({**lay, **{k: noisy(lay[k]) for k in GEO_KEYS}})
    return out, (~is_fake).astype(np.float32)


class FIDNetTrainer:
    def __init__(self, num_labels: int, max_seq_length: int = 10, lr: float = 3e-4,
                 weight_decay: float = 0.01, job_dir: str = "tmp/fidnet", device="cuda") -> None:
        self.device = resolve_device(device)
        self.num_labels = num_labels
        self.max_seq_length = max_seq_length
        self.lr = lr
        self.weight_decay = weight_decay
        self.job_dir = job_dir

    def init(self, seed: int = 0) -> tuple[FIDNetV3, torch.optim.Optimizer]:
        """A fresh FIDNetV3 with its auxiliary heads (fp32, weights from
        torch's generator seeded by `seed`) on the device, and its AdamW."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = FIDNetV3(self.num_labels, max_bbox=self.max_seq_length)
        model = model.to(self.device)
        opt = torch.optim.AdamW(model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)
        return model, opt

    def loss_fn(self, model: FIDNetV3, layout: Layout,
                is_real: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """(total, {'bce', 'label', 'bbox'}) on a layout on the device."""
        disc, cls_logits, bbox_pred = model(layout)
        bce = F.binary_cross_entropy_with_logits(disc, is_real)
        logp = torch.log_softmax(cls_logits, -1)
        ce_tok = -logp.gather(-1, layout.label[..., None])[..., 0]
        m = layout.mask.float()
        n = torch.clamp(m.sum(), min=1.0)
        ce = (ce_tok * m).sum() / n
        bbox = torch.stack([layout.geo(k) for k in GEO_KEYS], -1)
        mse = (((bbox_pred - bbox) ** 2).sum(-1) * m).sum() / n
        return bce + ce + 10.0 * mse, {"bce": bce, "label": ce, "bbox": mse}

    def step(self, model: FIDNetV3, opt: torch.optim.Optimizer, layout: Layout,
             is_real: np.ndarray) -> tuple[torch.Tensor, dict]:
        """One AdamW step on a host batch; the loss and its terms stay on the device."""
        layout = Layout(**{k: getattr(layout, k).to(self.device) for k in FIELDS})
        loss, aux = self.loss_fn(model, layout, torch.from_numpy(is_real).to(self.device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def fit(self, train_loader, epochs: int = 10, seed: int = 0,
            num_steps_cap: Optional[int] = None) -> FIDNetV3:
        """Train `epochs` epochs of at most `num_steps_cap` batches each,
        log each epoch's mean loss, save, and return the model."""
        rng = np.random.default_rng(seed)
        model, opt = self.init(seed)
        model.eval()  # JAX applies FIDNet deterministic: no dropout, K1 forward and backward
        for epoch in range(epochs):
            losses = []
            for i, batch in enumerate(train_loader):
                if num_steps_cap and i >= num_steps_cap:
                    break
                lay, is_real = generate_fake_and_real(batch["layout"], rng)
                losses.append(self.step(model, opt, lay, is_real)[0])
            mean = float(torch.stack(losses).mean()) if losses else float("nan")
            logger.info("fidnet epoch %d loss %.4f", epoch, mean)
        self.save(model)
        return model

    def save(self, model: FIDNetV3) -> None:
        path = os.path.join(self.job_dir, CKPT)
        tmp = path[: -len(".npz")] + ".tmp.npz"
        save_params_npz(tmp, export_params(model)[0])
        os.replace(tmp, path)

    def load(self, job_dir: Optional[str] = None) -> FIDNetV3:
        """The trained FIDNetV3 of `<job_dir>/fidnet_ckpt.npz`, in eval mode."""
        job_dir = job_dir or self.job_dir
        path = os.path.join(job_dir, CKPT)
        if not os.path.exists(path):
            orbax_dir = os.path.join(job_dir, "fidnet_ckpt")
            hint = (f"{orbax_dir} is an orbax checkpoint, which the port does not read; "
                    if os.path.isdir(orbax_dir) else "")
            raise FileNotFoundError(f"{hint}the port reads FIDNet's parameters from {path}, "
                                    "a flat .npz of the flax tree (README.md)")
        model, _ = self.init(0)
        load_jax_params(model, load_params_npz(path)[0])
        return model.eval()
