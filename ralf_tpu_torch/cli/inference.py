"""Batch inference entry point, the counterpart of `ralf_tpu/cli/inference.py`
for every preset:

    python -m ralf_tpu_torch.cli.inference --job-dir tmp/jobs/ralf_pku \\
        --cond uncond --split test --num-seeds 3
    python -m ralf_tpu_torch.cli.inference --job-dir ... --single-image img.png
    python -m ralf_tpu_torch.cli.inference --job-dir ... --unannotated

It reads the job dir's `config.json`, loads the weights from a flat `.npz`
of the flax tree (`--params`, default `<job_dir>/ckpt_<tag>.npz`; the JAX
package's orbax directory `ckpt_<tag>/` is not read: README.md shows how a
JAX run writes the `.npz`), builds the split and the retrieval (the
relation table, the cached retrieval table with the dynamic top-k rule,
the frozen-FIDNet gallery table), decodes every canvas for each seed and
writes, per (split, seed), the same files as JAX: `{split}_{seed}.pkl`
(the per-sample layout records), `{split}_{seed}_violation.csv`, and the
"ms per sample" line.  An existing pickle is skipped.  The generators with
no tokenizer (`cglgan`, `cglgan_ra`, `dsgan`, `dsgan_ra`, `icvt`,
`retriever`) take the batch and the seed's numpy rng, `gen.sample(batch,
rng)`, and count no violations, as in JAX; the GANs' task is the job's
`auxiliary_task` (`--cond` names the output directory), and the retriever
has no checkpoint.

It runs on the card (`--device cuda`, the default, which raises without
CUDA) or on the CPU with `--device cpu`.  Per seed the numpy rng of the
conditions is seeded by the seed, as in JAX; the decode's draws come from
a `torch.Generator` on the device seeded from (seed, layouts so far),
where JAX folds the same count into its key (`jax.random.fold_in`): torch
cannot reproduce `jax.random`'s numbers, so only `sampling.name=
deterministic` decodes equal JAX's (MaskGIT's re-masking noise also needs
`sampling.temperature=0`).  `--kv-quant` and `--self-quant` exist for the
AR decodes only and raise for the other presets, as JAX's do; `--no-backtrack`
and `--max-retries` concern the AR relation decode and are ignored by the
others.

`--mesh on` samples through the family's batch-sharded sampler
(`parallel.zoo.build_mesh_sampler`): each rank samples its rows of every
batch and one all-gather returns the tokens, which equal the single-card
path's at the same (padded) batch.  Under torchrun

    torchrun --nproc_per_node=N -m ralf_tpu_torch.cli.inference --job-dir ... --mesh on

the default group comes from torchrun's environment (NCCL on the card, gloo
with `--device cpu`); started plainly, `--mesh on` runs a world of one.
`--mesh auto` (the default) takes the mesh path under torchrun (WORLD_SIZE
set) and the single-card path otherwise; `--mesh off` the single-card path.
Rank 0 writes the gallery cache first and alone writes the pickles, the
violation csvs and the ms-per-sample lines.

`--trace` turns the port's spans and counters on for the run
(`utils.tracing`; each batch is the root span `infer.batch`) and writes
their summary to `trace_summary.json` in the output directory.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from ralf_tpu_torch.core.layout import GEO_KEYS, Layout
from ralf_tpu_torch.models.autoreg import AutoregGenerator
from ralf_tpu_torch.parallel import mesh as pmesh
from ralf_tpu_torch.utils import tracing

COND_CHOICES = ["uncond", "c", "cwh", "partial", "refinement", "relation", "gt"]


def layout_to_records(layout: Layout, ids) -> list[dict]:
    """Layout [B, S] -> per-sample {'id', 'label', 'center_x', ...} lists of
    the valid elements (the pickles' schema)."""
    arrays = layout.numpy()
    out = []
    for b in range(arrays["label"].shape[0]):
        m = arrays["mask"][b]
        rec = {"id": ids[b] if ids is not None else b, "label": arrays["label"][b][m].tolist()}
        for k in GEO_KEYS:
            rec[k] = arrays[k][b][m].tolist()
        out.append(rec)
    return out


def single_image_batch(img: np.ndarray, cfg, retriever=None, top_k: int = 16,
                       feats_table=None) -> dict:
    """The B=1 batch of one canvas [1, H, W, 4]: a placeholder layout with no
    element (a bare canvas has no GT, so conditional tasks see no constrained
    element) and, with a retriever, the neighbours of THIS canvas."""
    S = cfg.dataset.max_seq_length
    zeros = np.zeros((1, S), np.float32)
    batch = {
        "layout": Layout.fromdict({"label": np.zeros((1, S), np.int64), "center_x": zeros,
                                   "center_y": zeros, "width": zeros, "height": zeros,
                                   "mask": np.zeros((1, S), bool)}),
        "image": img,
        "id": np.asarray([0]),
        "indices": np.asarray([0]),
    }
    if retriever is not None:
        nbrs = np.asarray(retriever.topk(retriever.embed(img), top_k))
        batch["retrieved"] = retriever.gather_neighbors(nbrs)
        if feats_table is not None:
            batch["retrieved"]["feats"] = feats_table[nbrs]
        batch["retrieved_indices"] = nbrs
    return batch


def _load_single_image(path: str, cfg) -> np.ndarray:
    """One canvas from an image file, resized, with a centre-prior saliency
    channel (no saliency model runs here); needs PIL."""
    from PIL import Image

    H, W = cfg.dataset.image_h, cfg.dataset.image_w
    img = np.asarray(Image.open(path).convert("RGB").resize((W, H)), np.float32) / 255.0
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    sal = np.exp(-(xx**2 + yy**2) / 0.5).astype(np.float32)
    return np.concatenate([img, sal[..., None]], -1)[None]


def load_generator_params(gen, job_dir: str, tag: str, params_path=None) -> str:
    """Fill the generator's core from `params_path` (default
    `<job_dir>/ckpt_<tag>.npz`); returns the path read."""
    from ralf_tpu_torch.utils.weights import load_jax_params, load_params_npz

    path = params_path or os.path.join(job_dir, f"ckpt_{tag}.npz")
    if not os.path.exists(path):
        orbax_dir = os.path.join(job_dir, f"ckpt_{tag}")
        if params_path is None and os.path.isdir(orbax_dir):
            raise FileNotFoundError(
                f"{orbax_dir} is an orbax checkpoint, which the port does not read: it reads "
                f"a flat .npz of the flax tree ({path}); write it where JAX and orbax are "
                "installed (README.md, 'The port's CLIs')")
        raise FileNotFoundError(f"no parameters at {path}")
    params, batch_stats = load_params_npz(path)
    load_jax_params(gen.core, params, batch_stats)
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--job-dir", required=True)
    p.add_argument("--ckpt", default="final", help="checkpoint tag: <job_dir>/ckpt_<tag>.npz")
    p.add_argument("--params", default=None, help="the .npz of the flax tree (default "
                   "<job_dir>/ckpt_<ckpt>.npz)")
    p.add_argument("--cond", default="uncond", choices=COND_CHOICES)
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--num-seeds", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--single-image", default=None, help="run on one canvas from an image file")
    p.add_argument("--unannotated", action="store_true",
                   help="the no-GT split (with_no_annotation) of the parquet dump")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--topk", type=int, default=None,
                   help="inference-time retrieval k (the dynamic top-k sweep)")
    p.add_argument("--no-backtrack", action="store_true",
                   help="relation task: one decode, no retries")
    p.add_argument("--max-retries", type=int, default=8,
                   help="relation task: candidate elements sampled per position from the same "
                        "KV snapshot, keeping the fewest-violations one")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 shared memory in the decode (K3)")
    p.add_argument("--self-quant", action="store_true",
                   help="int8 per-token self-attention caches in the decode")
    p.add_argument("--mesh", default="auto", choices=["auto", "on", "off"],
                   help="on: the batch-sharded sampler over every rank (a world of one when "
                        "not under torchrun); auto: on under torchrun, else off; off: the "
                        "single-card sample path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--trace", action="store_true",
                   help=f"record the port's spans and counters; their summary goes to "
                        f"{tracing.SUMMARY_FILE} in the output directory")
    return p


def main(argv=None) -> dict:
    """Run inference; returns {'out_dir', 'ms_per_sample': {seed: ms},
    'layouts_per_s': {seed: rate}} for the seeds it ran."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    from ralf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    use_mesh = args.mesh == "on" or (args.mesh == "auto" and "WORLD_SIZE" in os.environ)
    made_group = False
    if use_mesh:
        dev, made_group = pmesh.init_distributed(dev)
    try:
        with tracing.traced(args.trace):
            summary = _infer(args, dev, use_mesh)
            if args.trace:
                tracing.write_summary(summary["out_dir"])
        return summary
    finally:
        if made_group:
            dist.destroy_process_group()


def _infer(args, dev: torch.device, use_mesh: bool) -> dict:
    from ralf_tpu_torch import cache as cache_mod
    from ralf_tpu_torch.config import (
        FrameworkConfig,
        build_datasets,
        build_generator,
        build_tokenizer,
    )
    from ralf_tpu_torch.data.dataset import BatchLoader, unannotated_dataset
    from ralf_tpu_torch.eval.violations import calculate_violation

    cfg = FrameworkConfig.load(args.job_dir)
    num_seeds = args.num_seeds or cfg.num_seeds
    suffix = ""
    if args.topk is not None:
        suffix += f"_dynamictopk_{args.topk}"
    if args.no_backtrack:
        suffix += "_nobacktrack"
    out_dir = args.out_dir or os.path.join(args.job_dir, f"generated_samples_{args.cond}{suffix}")
    os.makedirs(out_dir, exist_ok=True)

    train_ds, val_ds, test_ds = build_datasets(cfg)
    ds = {"val": val_ds, "test": test_ds}[args.split]
    if args.unannotated:
        ds = unannotated_dataset(cfg.dataset, ds, args.split)
    tokenizer = build_tokenizer(cfg)
    gen = build_generator(cfg, tokenizer, device=dev)
    is_ar = isinstance(gen, AutoregGenerator)
    if (args.kv_quant or args.self_quant) and not is_ar:
        raise ValueError(f"--kv-quant/--self-quant require an AR-family generator with int8 "
                         f"cache support; {type(gen).__name__} has none")

    # the precomputed relation clauses index the elements in sorted order:
    # valid only under deterministic element order
    # (the AR family's table, as in JAX: the zoo describes the batch's own layouts)
    if (args.cond == "relation" and hasattr(gen, "relationships_table")
            and set(cfg.transforms) <= {"image", "sort_label", "sort_lexicographic"}):
        gen.relationships_table = cache_mod.load_relationships(cfg.cache_dir, cfg.dataset.name)

    if cfg.experiment != "retriever":  # the retriever has no parameters and no checkpoint
        load_generator_params(gen, args.job_dir, args.ckpt, args.params)

    needs_retrieval = cfg.experiment == "ralf" or cfg.generator_kwargs.get("with_retrieval")
    retriever = feats_table = None
    top_k = args.topk or cfg.generator_kwargs.get("top_k", 16)
    if needs_retrieval:
        from ralf_tpu_torch.retrieval.retriever import Retriever

        with pmesh.rank0_first():  # rank 0 writes the gallery's cache, the others read it
            retriever = Retriever.build(train_ds, cache_dir=cfg.cache_dir,
                                        dataset_name=cfg.dataset.name, device=dev)
        if hasattr(gen, "precompute_retrieved_feats"):  # RALF's frozen tower, once a run
            feats_table = gen.precompute_retrieved_feats(retriever.layouts)

    if args.single_image:
        img = _load_single_image(args.single_image, cfg)
        batches = [single_image_batch(img, cfg, retriever, top_k, feats_table)]
    else:
        loader = BatchLoader(ds, args.batch_size, shuffle=False, transforms=cfg.transforms,
                             drop_last=False, seed=0)
        if needs_retrieval:
            from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

            table = None
            if not args.unannotated:  # cached tables are keyed by the GT split
                # they hold the train config's k columns: a dynamic top-k
                # within that width slices, a wider one re-queries
                table = cache_mod.load_retrieval_table(
                    cfg.cache_dir, cfg.dataset.name, args.split, retriever.backbone_name,
                    cfg.generator_kwargs.get("top_k", 16), expect_rows=len(ds))
                if table is not None and table.shape[1] < top_k:
                    table = None
            loader = RetrievalAugmentedLoader(loader, retriever, top_k, table=table,
                                              feats_table=feats_table)
        batches = list(loader)

    extra = {}
    if is_ar:
        extra = {"kv_quant": args.kv_quant, "self_quant": args.self_quant,
                 "use_backtrack": not args.no_backtrack, "max_retries": args.max_retries}
    sampler, is_main = None, True
    if use_mesh:
        from ralf_tpu_torch.parallel.zoo import build_mesh_sampler, make_decode_mesh

        sampler = build_mesh_sampler(gen, make_decode_mesh(), cfg.sampling, task=args.cond,
                                     kv_quant=args.kv_quant, self_quant=args.self_quant,
                                     use_backtrack=not args.no_backtrack,
                                     max_retries=args.max_retries)
        is_main = dist.get_rank() == 0
        logging.info("mesh inference (%s) over %d rank(s), %d batch shard(s)",
                     type(sampler).__name__, dist.get_world_size(), sampler.num_shards)
    summary = {"out_dir": out_dir, "ms_per_sample": {}, "layouts_per_s": {}}
    # decided before rank 0 writes any: every rank runs the same seeds
    seeds = [s for s in range(num_seeds)
             if not os.path.exists(os.path.join(out_dir, f"{args.split}_{s}.pkl"))]
    for seed in range(num_seeds):
        pkl_path = os.path.join(out_dir, f"{args.split}_{seed}.pkl")
        if seed not in seeds:
            logging.info("skip existing %s", pkl_path)
            continue
        rng = np.random.default_rng(seed)
        results, violations = [], {"total": 0, "viorated": 0}
        t_total, n_total = 0.0, 0
        for batch in batches:
            t0 = time.perf_counter()
            with tracing.span("infer.batch"):
                if tokenizer is None:  # GANs, ICVT, the retriever: one call on the batch
                    layout = (sampler or gen).sample(batch, rng)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                else:
                    cond, _ = gen.build_condition(batch, rng, task=args.cond)
                    generator = torch.Generator(device=dev).manual_seed(
                        seed * 2**32 + len(results))
                    with torch.inference_mode():
                        if sampler is not None:
                            layout, seq = sampler.sample(cond, generator, return_tokens=True)
                        else:
                            layout, seq = gen.sample(cond, cfg.sampling, generator,
                                                     return_tokens=True, **extra)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    v = calculate_violation(cond, seq, layout, tokenizer)
                    violations["total"] += v["total"]
                    violations["viorated"] += v["viorated"]
            t_total += time.perf_counter() - t0
            n_total += layout.label.shape[0]
            results.extend(layout_to_records(layout, batch.get("id")))

        ms = 1000.0 * t_total / max(n_total, 1)
        per_s = n_total / max(t_total, 1e-9)
        summary["ms_per_sample"][seed] = ms
        summary["layouts_per_s"][seed] = per_s
        if not is_main:
            continue
        with open(pkl_path, "wb") as f:
            pickle.dump({"results": results, "cond": args.cond, "split": args.split,
                         "seed": seed}, f)
        with open(os.path.join(out_dir, f"{args.split}_{seed}_violation.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["total", "viorated", "rate"])
            rate = violations["viorated"] / max(violations["total"], 1)
            w.writerow([violations["total"], violations["viorated"], rate])
        print(f"seed {seed}: {ms:.3f} ms per sample ({per_s:.1f} layouts/sec)")
    if is_main:
        print(f"wrote {out_dir}")
    return summary


if __name__ == "__main__":
    main()
