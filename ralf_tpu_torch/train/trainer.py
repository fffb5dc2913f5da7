"""The training loop, the counterpart of `ralf_tpu/train/trainer.py`: the
epoch loop with train and validation phases, grad clipping, the epoch
scheduler (plateau reads the val loss), periodic and final checkpoints,
and resume from a rolling mid-epoch checkpoint.

A train step is forward, loss, backward, clip and AdamW update
(`train.optim.Optimizer`) with the core in train mode; an eval step is the
loss under torch.no_grad() in eval mode.  The loss of each step stays on
the device until the epoch's mean (or a log line) reads it, as JAX keeps
its device arrays.  Dropout draws its masks from one torch.Generator
seeded before each step from (seed, global step) (`models.dropout`), so a
resumed run draws what an uninterrupted one draws, as JAX replays its key
stream; the numpy rng of `preprocess` is reseeded at a resume from
SeedSequence([seed, global step]), as in JAX.

A checkpoint `ckpt_<tag>` is two files in the job dir:
  * `ckpt_<tag>.npz`: the core's parameters and BatchNorm statistics as the
    flat flax tree (`utils.weights.export_params`), which the port's
    `cli.inference` reads as it is and JAX's modules load as numpy trees;
  * `ckpt_<tag>_opt.pt`: the optimizer's state and the step count.
Tags: `best` (lowest val loss), `epoch{N}`, `final`, and the rolling `step`
with `ckpt_step_meta.json` (epoch, step_in_epoch, global_step), written
after the checkpoint through a `.tmp` file and os.replace.

With `model.dtype=bfloat16` the steps compute in bf16 as JAX's do: `Trainer`
casts the core it trains to fp32 (fp32 parameters and BatchNorm statistics,
flax's param_dtype) and the forward and loss of each train and eval step run
under `torch.autocast` (`models.base.autocast`); the gradients, the clip's
norm, AdamW's moments and the checkpoints stay fp32.  A generator built at
bf16 was cast whole (`models.base.build_core`), so its random weights come
back rounded to bf16; weights loaded after the Trainer is built (a resume,
`utils.weights.load_jax_params`) keep their fp32 values.

With a `mesh` (`parallel.mesh`, one process per rank) the steps are
data-parallel, as JAX's step over its mesh is.  Rank 0 broadcasts the
initial state once.  Every rank runs the same loader stream and
`preprocess` on the whole batch (the numpy draws stay in step with a single
process's and with JAX's) and keeps its rows (`parallel.mesh.batch_rows`);
the loss runs under `parallel.rows.row_shard` with the batch group, so that
dropout draws its rows of the whole batch's masks, BatchNorm takes the
global batch's statistics and the count-normalised losses the global count.
After backward one flat, bucketed all-reduce averages the gradients (the
frozen leaves' too, which the clip's norm counts) and the step's scalar
metrics over the batch group; the update then runs alike on every rank.
It is no `DistributedDataParallel` wrapper: the clip's norm, K1, K5 and K6's
recomputed backward and the GAN step's frozen discriminator stay as they
are.  Rank 0 alone writes the checkpoints, `metrics.jsonl`, profiles and
renders, and a barrier follows each checkpoint; every rank resumes from it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.core.layout import FIELDS, Layout
from ralf_tpu_torch.models.base import autocast
from ralf_tpu_torch.models.dropout import set_dropout_generator
from ralf_tpu_torch.parallel import mesh as pmesh
from ralf_tpu_torch.parallel.rows import row_shard
from ralf_tpu_torch.train.optim import Optimizer
from ralf_tpu_torch.train.schedulers import build_scheduler
from ralf_tpu_torch.utils import tracing
from ralf_tpu_torch.utils.weights import (
    export_params,
    load_jax_params,
    load_params_npz,
    save_params_npz,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    """Defaults follow the JAX package's `TrainConfig`."""

    epochs: int = 50
    batch_size: int = 32
    lr: float = 1e-4
    weight_decay: float = 0.01
    clip_max_norm: float = 1.0
    scheduler: str = "void"
    scheduler_kwargs: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    job_dir: str = "tmp/jobs/default"
    save_every_epochs: int = 0  # 0 = only final/best
    save_every_steps: int = 0  # rolling "step" checkpoint every N train steps
    save_every_secs: float = 0.0  # ... or every T wall-clock seconds
    log_every_steps: int = 50
    profile_steps: Optional[tuple] = None  # torch.profiler over train steps [a, b] of epoch 1
    tensorboard: bool = False
    render_every_epochs: int = 0
    gallery_shards: int = 1  # cli.train: the retrieval gallery's rows over this many ranks


@dataclasses.dataclass
class TrainState:
    """The generator's core (trained in place), its optimizer and the
    number of steps taken."""

    module: nn.Module
    optimizer: Optimizer
    step: int = 0


def step_seed(seed: int, global_step: int) -> int:
    """The dropout generator's seed for one step."""
    return int(np.random.SeedSequence([seed, global_step]).generate_state(1, np.uint64)[0])


class Trainer:
    def __init__(self, generator, cfg: TrainConfig, mesh: Optional[pmesh.Mesh] = None) -> None:
        self.mesh = mesh
        self.is_main = mesh is None or mesh.device_mesh.get_rank() == 0
        generator.core.float()  # fp32 parameters and statistics; the steps cast at the ops
        self.gen = generator
        self.cfg = cfg
        self.scheduler = build_scheduler(cfg.scheduler, cfg.epochs, **cfg.scheduler_kwargs)
        self._dropout = torch.Generator(device=generator.device)
        os.makedirs(cfg.job_dir, exist_ok=True)
        self._metrics_path = os.path.join(cfg.job_dir, "metrics.jsonl")
        self._tb = None
        if cfg.tensorboard and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:  # keep training without tensorboard
                logger.warning("tensorboard unavailable: %s", e)
            else:
                self._tb = SummaryWriter(os.path.join(cfg.job_dir, "tb"))

    # ---- state -------------------------------------------------------------

    def init_state(self) -> TrainState:
        """The generator's core as it stands, every parameter requiring grad
        (as jax.grad differentiates the whole tree: a frozen leaf's gradient
        counts in the clip's norm, `train.optim`), and a fresh optimizer."""
        core = self.gen.core
        for p in core.parameters():
            p.requires_grad_(True)
        set_dropout_generator(core, self._dropout)
        if self.mesh is not None:
            pmesh.replicate(self.mesh, core)
        opt = Optimizer(core, base_lr=self.cfg.lr, weight_decay=self.cfg.weight_decay,
                        clip_max_norm=self.cfg.clip_max_norm)
        return TrainState(core, opt, 0)

    # ---- steps ---------------------------------------------------------------

    def shard(self, inputs: dict, targets: dict):
        """(this rank's rows of a whole batch's inputs and targets, the row
        shard its loss runs under); the batch and a null context without a mesh."""
        if self.mesh is None:
            return inputs, targets, contextlib.nullcontext()
        B = pmesh.leading_size(inputs)
        lo, hi = pmesh.batch_rows(self.mesh, B)
        return (pmesh.shard_batch(self.mesh, inputs), pmesh.shard_batch(self.mesh, targets),
                row_shard(B, lo, hi, self.mesh.batch_group, self.mesh.num_shards))

    def sync(self, metrics: dict, module: Optional[nn.Module] = None) -> None:
        """Average the scalar metrics and the module's gradients over the batch
        group in place (one flat all-reduce a bucket); nothing without a mesh.
        A metric with a batch axis keeps this rank's rows."""
        if self.mesh is None:
            return
        tensors = [] if module is None else [p.grad for p in module.parameters()
                                             if p.grad is not None]
        tensors += [v for v in metrics.values() if v.dim() == 0 and v.is_floating_point()]
        pmesh.all_reduce_mean(tensors, self.mesh.batch_group, self.mesh.num_shards)

    def train_step(self, state: TrainState, inputs: dict, targets: dict) -> dict:
        """Forward, loss, backward, clip and update on a whole batch (this
        rank's rows of it with a mesh); the metrics stay on the device."""
        state.module.train()
        self._dropout.manual_seed(step_seed(self.cfg.seed, state.step))
        inputs, targets, shard = self.shard(inputs, targets)
        with tracing.span("train.forward"), shard, autocast(self.gen.cfg, self.gen.device):
            loss, aux = self.gen.loss(inputs, targets)
        with tracing.span("train.backward"):
            state.optimizer.zero_grad()
            loss.backward()
        metrics = {**{k: v.detach().clone() for k, v in aux.items()},
                   "loss": loss.detach().clone()}
        self.sync(metrics, state.module)
        state.optimizer.step()
        state.step += 1
        return metrics

    def eval_step(self, state: TrainState, inputs: dict, targets: dict) -> dict:
        state.module.eval()
        inputs, targets, shard = self.shard(inputs, targets)
        with torch.no_grad(), shard, autocast(self.gen.cfg, self.gen.device):
            loss, _ = self.gen.loss(inputs, targets)
        metrics = {"loss": loss}
        self.sync(metrics)
        return metrics

    # ---- loops ---------------------------------------------------------------

    def fit(self, train_loader, val_loader=None, num_steps_cap: Optional[int] = None,
            resume: bool = False) -> TrainState:
        """Run the epoch loop.  With resume=True and a rolling "step"
        checkpoint present (cfg.save_every_steps / save_every_secs), training
        continues from the recorded (epoch, step_in_epoch): earlier epochs
        are skipped and the current epoch's trained batches are skipped by
        index.  Ends with the core in eval mode."""
        cfg = self.cfg
        state = self.init_state()
        rng = np.random.default_rng(cfg.seed)
        start_epoch, skip_steps = 1, 0
        if resume:
            meta = self._load_step_meta()
            if meta is not None:
                state = self.restore("step", state)
                start_epoch, skip_steps = meta["epoch"], meta["step_in_epoch"]
                rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, meta["global_step"]]))
                logger.info("resuming at epoch %d step %d (global %d)",
                            start_epoch, skip_steps, meta["global_step"])

        best_val = float("inf")
        global_step = state.step
        last_save_t = time.time()
        # torch's schedulers apply their `_initial_step` at construction, so
        # epoch 1 runs at scale(0): not 1 only for a milestone-0 stair
        init_scale = self.scheduler.scale(start_epoch - 1)
        if init_scale != 1.0:
            state.optimizer.set_learning_rate(cfg.lr * init_scale)
        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.time()
            losses = []
            prof = cfg.profile_steps
            profiler = None
            for i, batch in enumerate(train_loader):
                if num_steps_cap and i >= num_steps_cap:
                    break
                if epoch == start_epoch and i < skip_steps:
                    continue  # trained before the resume point
                if prof and epoch == 1 and i == prof[0] and self.is_main:
                    profiler = self._start_profile()
                with tracing.span("train.step"):
                    inputs, targets = self.gen.preprocess(batch, rng)
                    metrics = self.train_step(state, inputs, targets)
                losses.append(metrics["loss"])
                global_step += 1
                if profiler is not None and i == prof[1]:
                    self._stop_profile(profiler)
                    profiler = None
                if cfg.log_every_steps and i % cfg.log_every_steps == 0:
                    logger.info("epoch %d step %d loss %.4f", epoch, i, float(metrics["loss"]))
                due_steps = cfg.save_every_steps and global_step % cfg.save_every_steps == 0
                due_secs = cfg.save_every_secs and time.time() - last_save_t >= cfg.save_every_secs
                if due_steps or due_secs:
                    self._save_step_ckpt(state, epoch, i + 1, global_step)
                    last_save_t = time.time()
            if profiler is not None:  # the epoch ended inside the window
                self._stop_profile(profiler)
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

            val_loss = None
            if val_loader is not None:
                vl = []
                for i, batch in enumerate(val_loader):
                    if num_steps_cap and i >= num_steps_cap:
                        break
                    inputs, targets = self.gen.preprocess(batch, rng)
                    vl.append(self.eval_step(state, inputs, targets)["loss"])
                val_loss = float(torch.stack(vl).mean()) if vl else None

            # the epoch's LR scale (plateau reads the val loss)
            scale = self.scheduler.scale(epoch, val_loss)
            state.optimizer.set_learning_rate(cfg.lr * scale)

            rec = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                   "lr_scale": scale, "sec": round(time.time() - t0, 2)}
            if self.is_main:
                with open(self._metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            logger.info("epoch %d done: %s", epoch, rec)
            if self._tb is not None:
                self._tb.add_scalar("train/loss", train_loss, epoch)
                if val_loss is not None:
                    self._tb.add_scalar("val/loss", val_loss, epoch)
                self._tb.add_scalar("train/lr_scale", scale, epoch)

            if (cfg.render_every_epochs and epoch % cfg.render_every_epochs == 0
                    and val_loader is not None and self.is_main):
                self._render_samples(val_loader, epoch)

            if val_loss is not None and val_loss < best_val:
                best_val = val_loss
                self.save(state, tag="best")
            if cfg.save_every_epochs and epoch % cfg.save_every_epochs == 0:
                self.save(state, tag=f"epoch{epoch}")

        state.module.eval()
        self.save(state, tag="final")
        return state

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.gen.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        if self.gen.device.type == "cuda":
            torch.cuda.synchronize(self.gen.device)
        profiler.stop()
        out = os.path.join(self.cfg.job_dir, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        logger.info("wrote %s", os.path.join(out, "trace.json"))

    def _render_samples(self, val_loader, epoch: int) -> None:
        """A montage of generated layouts on the first val canvases, as
        `samples_epoch{N}.png` (needs PIL); a failure is logged and
        training goes on, as in JAX."""
        try:
            from PIL import Image

            from ralf_tpu_torch.core.sampling import SamplingConfig
            from ralf_tpu_torch.eval.visualizer import montage, render_layout

            self.gen.core.eval()
            batch = next(iter(val_loader))
            n = min(8, np.asarray(batch["image"]).shape[0])
            batch = _head(batch, n)
            cond, _ = self.gen.build_condition(batch, np.random.default_rng(epoch))
            layout = self.gen.sample(cond, SamplingConfig(name="random"),
                                     torch.Generator(device=self.gen.device).manual_seed(epoch))
            grid = montage(render_layout(layout, np.asarray(batch["image"])))
            path = os.path.join(self.cfg.job_dir, f"samples_epoch{epoch}.png")
            Image.fromarray((grid * 255).astype(np.uint8)).save(path)
            if self._tb is not None:
                self._tb.add_image("samples", grid.transpose(2, 0, 1), epoch)
            logger.info("rendered %s", path)
        except Exception:  # a boundary: rendering is optional, training goes on
            logger.warning("sample rendering failed", exc_info=True)

    # ---- checkpoints -----------------------------------------------------------

    def _paths(self, tag: str) -> tuple[str, str]:
        base = os.path.join(self.cfg.job_dir, f"ckpt_{tag}")
        return base + ".npz", base + "_opt.pt"

    def _save_step_ckpt(self, state: TrainState, epoch: int, step_in_epoch: int,
                        global_step: int) -> None:
        """The rolling mid-epoch checkpoint and its meta, written after it,
        so that a crash between the two leaves the previous consistent pair."""
        self.save(state, tag="step")
        if self.is_main:
            meta = {"epoch": epoch, "step_in_epoch": step_in_epoch, "global_step": global_step}
            path = os.path.join(self.cfg.job_dir, "ckpt_step_meta.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, path)
        self._barrier()

    def _load_step_meta(self) -> Optional[dict]:
        path = os.path.join(self.cfg.job_dir, "ckpt_step_meta.json")
        if not (os.path.exists(path) and all(map(os.path.exists, self._paths("step")))):
            return None
        with open(path) as f:
            return json.load(f)

    def _barrier(self) -> None:
        if self.mesh is not None:
            pmesh.barrier()

    def save(self, state: TrainState, tag: str = "final") -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.is_main:
            npz, opt = self._paths(tag)
            tmp_npz, tmp_opt = npz[: -len(".npz")] + ".tmp.npz", opt + ".tmp"
            save_params_npz(tmp_npz, *export_params(state.module))
            torch.save({"optimizer": state.optimizer.state_dict(), "step": state.step}, tmp_opt)
            os.replace(tmp_npz, npz)
            os.replace(tmp_opt, opt)
            logger.info("saved checkpoint %s", npz)
        self._barrier()

    def restore(self, tag: str = "final", state: Optional[TrainState] = None) -> TrainState:
        if state is None:
            state = self.init_state()
        npz, opt = self._paths(tag)
        load_jax_params(state.module, *load_params_npz(npz))
        saved = torch.load(opt, map_location="cpu", weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return state


def _head(batch: dict, n: int) -> dict:
    """The first n canvases of a batch (nested dicts and Layouts included)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = _head(v, n)
        elif isinstance(v, Layout):
            out[k] = Layout(**{f: getattr(v, f)[:n] for f in FIELDS})
        elif hasattr(v, "__getitem__") and not isinstance(v, (str, bytes)):
            out[k] = v[:n]
        else:
            out[k] = v
    return out
