"""The adversarial training loop of the GAN baselines (CGL-GAN, DS-GAN and
their retrieval-augmented variants), the counterpart of
`ralf_tpu/train/gan_trainer.py`: each batch takes a generator step, then a
discriminator step.

  * generator step: the generator in train mode, the discriminator in eval
    mode with its parameters not requiring grad (JAX differentiates the
    generator's parameters only; the packed prediction stays
    differentiable through the straight-through argmax); the generator's
    loss (`gen.loss(..., disc=...)`), backward, clip and AdamW;
  * discriminator step: the generator in eval mode (its forward under
    no_grad, JAX's stop_gradient), the discriminator in train mode;
    `gen.disc_loss`, backward, clip and AdamW at `lr * LR_MULT_DIS`
    (10x), the trunk of its image encoder at 0.1x of that, the same weight
    decay and clip.  Its optimizer reads its groups from the same flax map
    (`train.optim`), so CGL-GAN's two Conv1d layout encoders, named
    `layout_encoder` as the FIDNet towers are, stay frozen as in JAX, their
    gradients counted in the clip's norm.

`fit_gan` applies both schedulers' scale(0) before epoch 1 (DS-GAN's stair
starts both nets at gamma times their LR), calls
`gen.update_per_epoch(epoch, warmup_dis_epoch, epochs)` before each epoch,
sets both LRs after it, and writes a `metrics.jsonl` line {epoch, g_loss,
d_loss, sec}.  It saves `epoch{N}` (the generator) when
`save_every_epochs` asks, and at the end `final` (the generator) and
`final_dis` (the discriminator): `ckpt_final.npz`, `ckpt_final_opt.pt`,
`ckpt_final_dis.npz`, `ckpt_final_dis_opt.pt`.  As in JAX it runs no
validation, writes no `best` or step checkpoint and does not resume.

With a mesh both steps are data-parallel as `Trainer`'s step is: each rank
runs its rows of the batch under the row shard (the discriminator's
BatchNorm takes the global batch's statistics, the matching loss the global
weight sum) and one all-reduce averages the stepped net's gradients; rank 0
broadcasts both nets' initial state and alone writes `metrics.jsonl` and the
checkpoints.

Both steps compute in the config's dtype, with both nets cast to fp32 as
`Trainer` casts its core (`models.base.autocast`); DS-GAN trains in fp32
only, as in JAX.  Dropout draws from two generators, the generator's and the
discriminator's, seeded before each step from (seed, step) as `Trainer`
seeds its one; the discriminator's two passes draw the same masks.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

import numpy as np
import torch

from ralf_tpu_torch.models.base import autocast
from ralf_tpu_torch.models.dropout import set_dropout_generator
from ralf_tpu_torch.parallel.mesh import replicate
from ralf_tpu_torch.train.optim import Optimizer
from ralf_tpu_torch.train.schedulers import build_scheduler
from ralf_tpu_torch.train.trainer import TrainConfig, Trainer, TrainState, step_seed

logger = logging.getLogger(__name__)


class GANTrainer(Trainer):
    def __init__(self, generator, cfg: TrainConfig, mesh=None, warmup_dis_epoch: int = 10) -> None:
        if generator.FP32_TRAINING_ONLY and generator.cfg.dtype not in (None, torch.float32):
            raise ValueError(
                f"model.dtype={generator.cfg.dtype}: {type(generator).__name__} trains in "
                "float32 only, as in JAX, whose DS-GAN cannot be built at a low dtype (flax's "
                "LSTM scan refuses the bf16 initial carry its fp32 cells return in fp32)")
        super().__init__(generator, cfg, mesh)
        self.warmup_dis_epoch = warmup_dis_epoch
        self.scheduler_dis = build_scheduler(
            cfg.scheduler, cfg.epochs, **{**cfg.scheduler_kwargs, "network": "discriminator"})
        self._dropout_dis = torch.Generator(device=generator.device)

    @property
    def lr_dis(self) -> float:
        return self.cfg.lr * self.gen.LR_MULT_DIS

    def init_states(self) -> tuple[TrainState, TrainState]:
        """The generator's state (`init_state`) and the discriminator's: the
        generator's `disc` if it has one, else a new one (`init_disc`), and
        its own optimizer."""
        state = self.init_state()
        disc = (self.gen.disc if self.gen.disc is not None else self.gen.init_disc()).float()
        for p in disc.parameters():
            p.requires_grad_(True)
        set_dropout_generator(disc, self._dropout_dis)
        if self.mesh is not None:
            replicate(self.mesh, disc)
        opt = Optimizer(disc, base_lr=self.lr_dis, weight_decay=self.cfg.weight_decay,
                        clip_max_norm=self.cfg.clip_max_norm)
        return state, TrainState(disc, opt, 0)

    # ---- steps ---------------------------------------------------------------

    def gen_step(self, state: TrainState, dis_state: TrainState, inputs: dict,
                 targets: dict) -> dict:
        """One generator step on `device_batch`'s tensors; the metrics stay
        on the device."""
        state.module.train()
        dis_state.module.eval().requires_grad_(False)
        self._dropout.manual_seed(step_seed(self.cfg.seed, state.step))
        inputs, targets, shard = self.shard(inputs, targets)
        try:
            with shard, autocast(self.gen.cfg, self.gen.device):
                loss, aux = self.gen.loss(inputs, targets, disc=dis_state.module)
            state.optimizer.zero_grad()
            loss.backward()
        finally:
            dis_state.module.requires_grad_(True)
        metrics = {**{k: v.detach().clone() for k, v in aux.items()},
                   "loss": loss.detach().clone()}
        self.sync(metrics, state.module)
        state.optimizer.step()
        state.step += 1
        return metrics

    def dis_step(self, dis_state: TrainState, state: TrainState, inputs: dict,
                 targets: dict) -> dict:
        """One discriminator step on `device_batch`'s tensors."""
        state.module.eval()
        dis_state.module.train()
        self._dropout_dis.manual_seed(step_seed(self.cfg.seed + 1, dis_state.step))
        inputs, targets, shard = self.shard(inputs, targets)
        with shard, autocast(self.gen.cfg, self.gen.device):
            loss, aux = self.gen.disc_loss(inputs, targets)
        dis_state.optimizer.zero_grad()
        loss.backward()
        metrics = {**{k: v.detach().clone() for k, v in aux.items()},
                   "loss_d": loss.detach().clone()}
        self.sync(metrics, dis_state.module)
        dis_state.optimizer.step()
        dis_state.step += 1
        return metrics

    # ---- the loop ------------------------------------------------------------

    def fit_gan(self, train_loader, num_steps_cap: Optional[int] = None
                ) -> tuple[TrainState, TrainState]:
        """Train both nets (see the module docstring); ends with both in eval mode."""
        cfg = self.cfg
        state, dis_state = self.init_states()
        rng = np.random.default_rng(cfg.seed)
        if (gs := self.scheduler.scale(0)) != 1.0:
            state.optimizer.set_learning_rate(cfg.lr * gs)
        if (ds := self.scheduler_dis.scale(0)) != 1.0:
            dis_state.optimizer.set_learning_rate(self.lr_dis * ds)
        for epoch in range(1, cfg.epochs + 1):
            self.gen.update_per_epoch(epoch, self.warmup_dis_epoch, cfg.epochs)
            t0 = time.time()
            g_losses, d_losses = [], []
            for i, batch in enumerate(train_loader):
                if num_steps_cap and i >= num_steps_cap:
                    break
                inputs, targets = self.gen.device_batch(*self.gen.preprocess(batch, rng))
                g_losses.append(self.gen_step(state, dis_state, inputs, targets)["loss"])
                d_losses.append(self.dis_step(dis_state, state, inputs, targets)["loss_d"])
            state.optimizer.set_learning_rate(cfg.lr * self.scheduler.scale(epoch))
            dis_state.optimizer.set_learning_rate(self.lr_dis * self.scheduler_dis.scale(epoch))
            g_loss = float(torch.stack(g_losses).mean()) if g_losses else float("nan")
            d_loss = float(torch.stack(d_losses).mean()) if d_losses else float("nan")
            logger.info("epoch %d: g_loss %.4f d_loss %.4f (%.1fs)", epoch, g_loss, d_loss,
                        time.time() - t0)
            if self.is_main:
                with open(self._metrics_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch, "g_loss": g_loss, "d_loss": d_loss,
                                        "sec": round(time.time() - t0, 2)}) + "\n")
            if cfg.save_every_epochs and epoch % cfg.save_every_epochs == 0:
                self.save(state, tag=f"epoch{epoch}")
        state.module.eval()
        dis_state.module.eval()
        self.save(state, tag="final")
        self.save(dis_state, tag="final_dis")
        return state, dis_state
