"""Training entry point, the counterpart of `ralf_tpu/cli/train.py` for every
preset that JAX trains:

    python -m ralf_tpu_torch.cli.train --experiment ralf --dataset pku10 \\
        --job-dir tmp/jobs/ralf_pku --epochs 2 --synthetic \\
        train.lr=1e-4 generator_kwargs.top_k=16

Dotted key=value overrides as in JAX.  It writes the job dir's
`config.json` (JAX's format), trains with `train.trainer.Trainer` and writes
`metrics.jsonl` and the checkpoints `ckpt_<tag>.npz` (the flat flax tree,
which `cli.inference` reads) beside `ckpt_<tag>_opt.pt`.  The GAN presets
(`cglgan`, `cglgan_ra`, `dsgan`, `dsgan_ra`) train with
`train.gan_trainer.GANTrainer.fit_gan` on the train split alone, as in
JAX: no validation, no `best` or step checkpoints, no `--resume`; they
write `ckpt_final` (the generator) and `ckpt_final_dis` (the
discriminator).  `ralf` and
`layoutdm_ra` retrieve for every canvas of the train split from the others
(`is_train_split`), through the cached top-k tables where the cache dir
holds them; FIDNet runs on the B*K retrieved layouts in each step, as in
JAX.  The kmeans vocabulary of `layoutdm` and `layoutdm_ra` comes from the
cache dir, as in serving.

`retriever` has nothing to train: as in JAX, the job dir's `config.json`
is the whole job (`cli.inference` builds the gallery from the train split).

With `model.dtype=bfloat16` every preset trains in bf16 with fp32
parameters, as JAX's does: the trainer keeps the core fp32 and the steps
run under autocast (`train.trainer`), and the checkpoints hold fp32, which
both packages' `cli.inference` serve in either dtype.

It runs on the card (`--device cuda`, the default, which raises without
CUDA) or on the CPU with `--device cpu`.  Under torchrun, or with
`train.gallery_shards > 1`, it trains data-parallel (`parallel.mesh`):

    torchrun --nproc_per_node=N -m ralf_tpu_torch.cli.train --experiment ralf ... \
        train.gallery_shards=2

The default group comes from torchrun's environment (a world of one without
it; NCCL on the card, gloo with `--device cpu`).  With retrieval and
`gallery_shards` gs > 1 the mesh is (data W / gs, gallery gs) and the
gallery's rows are split over the gallery axis (`Retriever.shard_gallery`),
as JAX's cli.train does; a gs that does not divide the world size W is
refused.  Otherwise every rank is on the data axis.  Rank 0 writes the
job dir's files and the gallery cache first, then the other ranks read them.

`--trace` turns the port's spans and counters on for the run
(`utils.tracing`; each step of `Trainer.fit` is the root span `train.step`)
and writes their summary to `trace_summary.json` in the job dir.  A
`train.profile_steps=` chrome trace carries the same spans whether or not
`--trace` is given.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch.distributed as dist

from ralf_tpu_torch.utils import tracing


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--experiment", default="ralf")
    p.add_argument("--dataset", default="pku10")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--job-dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--task", default="uncond", help="auxiliary task")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="hermetic synthetic dataset (no parquet dumps needed)")
    p.add_argument("--cache-dir", default="cache",
                   help="offline-artifact dir (retrieval tables, gallery features)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the rolling mid-epoch 'step' checkpoint in job-dir")
    p.add_argument("--save-every-steps", type=int, default=0,
                   help="rolling mid-epoch checkpoint cadence (train steps)")
    p.add_argument("--save-every-secs", type=float, default=0.0,
                   help="rolling mid-epoch checkpoint cadence (wall seconds)")
    p.add_argument("--uint8-images", action="store_true",
                   help="canvases travel to the device as uint8 and are normalized there")
    p.add_argument("--allow-linear-fallback", action="store_true",
                   help="permit kmeans-preset tokenizers to downgrade to the linear vocabulary")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--trace", action="store_true",
                   help=f"record the port's spans and counters; their summary goes to "
                        f"{tracing.SUMMARY_FILE} in the job dir")
    p.add_argument("overrides", nargs="*")
    return p


def main(argv=None) -> str:
    """Train; returns the job dir."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from ralf_tpu_torch.config import build_config
    from ralf_tpu_torch.parallel import mesh as pmesh
    from ralf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = build_config(args.experiment, args.overrides)
    distributed = "WORLD_SIZE" in os.environ or cfg.train.gallery_shards > 1
    made_group = False
    if distributed:
        dev, made_group = pmesh.init_distributed(dev)
    try:
        with tracing.traced(args.trace):
            job_dir = _train(args, cfg, dev, distributed)
            if args.trace:
                tracing.write_summary(job_dir)
        return job_dir
    finally:
        if made_group:
            dist.destroy_process_group()


def _train(args, cfg, dev, distributed: bool) -> str:
    from ralf_tpu_torch import cache as cache_mod
    from ralf_tpu_torch.config import EXPERIMENTS, build_datasets, build_generator, build_tokenizer
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig
    from ralf_tpu_torch.parallel import mesh as pmesh
    from ralf_tpu_torch.train.trainer import Trainer

    generator = EXPERIMENTS[cfg.experiment]["generator"]
    cfg.dataset = DatasetConfig(name=args.dataset, data_dir=args.data_dir)
    cfg.auxiliary_task = args.task
    cfg.debug = args.debug
    cfg.synthetic_data = args.synthetic
    cfg.cache_dir = args.cache_dir
    if args.allow_linear_fallback:  # don't clobber a dotted override
        cfg.allow_linear_fallback = True
    if args.epochs:
        cfg.train.epochs = args.epochs
    if args.batch_size:
        cfg.train.batch_size = args.batch_size
    if args.save_every_steps:
        cfg.train.save_every_steps = args.save_every_steps
    if args.save_every_secs:
        cfg.train.save_every_secs = args.save_every_secs
    cfg.train.job_dir = args.job_dir or f"tmp/jobs/{args.experiment}_{args.dataset}_{args.task}"
    if args.debug:
        cfg.train.epochs = 1
    with pmesh.rank0_first():
        if not distributed or dist.get_rank() == 0:
            cfg.save(cfg.train.job_dir)
    if generator == "retriever":  # non-learnable: the saved config is the whole job
        print(f"done: {cfg.train.job_dir} (retriever is non-learnable; config saved, no "
              "checkpoint needed)")
        return cfg.train.job_dir

    train_ds, val_ds, _ = build_datasets(cfg)
    tokenizer = build_tokenizer(cfg)
    gen = build_generator(cfg, tokenizer, device=dev)

    # relation task: the precomputed clause table indexes elements in the
    # canonical sorted order, so it applies to deterministic-order pipelines
    deterministic_order = set(cfg.transforms) <= {"image", "sort_label", "sort_lexicographic"}
    if (args.task in ("relation", "multitask") and deterministic_order
            and hasattr(gen, "relationships_table")):  # the AR family's, as in JAX
        gen.relationships_table = cache_mod.load_relationships(cfg.cache_dir, cfg.dataset.name)

    image_dtype = np.uint8 if args.uint8_images else np.float32
    train_loader = BatchLoader(train_ds, cfg.train.batch_size, transforms=cfg.transforms,
                               seed=cfg.train.seed, image_dtype=image_dtype)
    val_loader = BatchLoader(val_ds, cfg.train.batch_size, shuffle=False,
                             transforms=cfg.transforms, seed=cfg.train.seed,
                             image_dtype=image_dtype)

    mesh = pmesh.make_mesh() if distributed else None
    if cfg.experiment == "ralf" or cfg.generator_kwargs.get("with_retrieval"):
        from ralf_tpu_torch.retrieval.retriever import Retriever
        from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

        with pmesh.rank0_first():  # rank 0 writes the gallery's cache, the others read it
            retriever = Retriever.build(train_ds, cache_dir=cfg.cache_dir,
                                        dataset_name=cfg.dataset.name, device=dev)
        gs = cfg.train.gallery_shards
        if gs > 1:  # the gallery's rows over gs ranks; the rest of the world is the data axis
            n = dist.get_world_size()
            if n % gs:
                raise SystemExit(f"train.gallery_shards={gs} must divide the world size {n}")
            mesh = pmesh.make_mesh((n // gs, gs))
            retriever.shard_gallery(mesh, pmesh.GALLERY_AXIS)
        top_k = cfg.generator_kwargs.get("top_k", 16)
        tables = {  # a cache hit skips the per-run gallery scoring pass
            split: cache_mod.load_retrieval_table(
                cfg.cache_dir, cfg.dataset.name, split, retriever.backbone_name, top_k,
                expect_rows=len(ds))
            for split, ds in (("train", train_ds), ("val", val_ds))
        }
        train_loader = RetrievalAugmentedLoader(train_loader, retriever, top_k,
                                                is_train_split=True, table=tables["train"])
        val_loader = RetrievalAugmentedLoader(val_loader, retriever, top_k, table=tables["val"])

    cap = 2 if cfg.debug else None
    if generator in ("cglgan", "dsgan"):
        from ralf_tpu_torch.train.gan_trainer import GANTrainer

        GANTrainer(gen, cfg.train, mesh).fit_gan(train_loader, num_steps_cap=cap)
    else:
        Trainer(gen, cfg.train, mesh).fit(train_loader, val_loader, num_steps_cap=cap,
                                          resume=args.resume)
    print(f"done: {cfg.train.job_dir}")
    return cfg.train.job_dir


if __name__ == "__main__":
    main()
