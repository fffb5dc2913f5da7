"""The offline cache builders, the counterpart of `ralf_tpu/cli/build_caches.py`:
retrieval tables, the kmeans token vocabularies and the relationship tables.

    python -m ralf_tpu_torch.cli.build_caches --what retrieval|clusters|relationships \\
        --dataset pku10 [--data-dir ...] [--synthetic [--debug]] --cache-dir cache/ \\
        [--device cuda]

  * `--what retrieval`: the gallery (the train split, or with
    `--cross-dataset-dir` another dataset's) embedded by `--backbone`
    (saliency, dreamsim, clip, vgg; its features cached as
    `{ds}_{backbone}_gallery_features.npz`), then each split's top-k table,
    `--rerank mmr` to top_k / 2 by maximal marginal relevance, `--rerank
    lpips` (AlexNet or VGG, `--lpips-net`, at `--lpips-size`) reordered and
    saved under the backbone key `lpips`.  `--rerank random` is accepted and
    changes nothing, as in JAX (ROADMAP.md Queue C 74).
  * `--what clusters`: `fit_kmeans_1d` of every geometry key of the train
    split at n = 2, 4, ..., 256 -> `{ds}_kmeans_train_clusters.pkl`.
  * `--what relationships`: every sample's relation clauses over the three
    splits, under the AR pipeline's sorts -> `{ds}_relationships_dic.pkl`.

The file names are JAX's (`cache.py`), so either package's CLIs read what
the other wrote.  The towers and LPIPS run on `--device` (the card by
default; it raises without CUDA).  `--debug` takes the synthetic splits of
64/16/16 canvases (else 512/64/64), as `cli.train --debug` does.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np


def build_relationships_table(datasets) -> dict:
    """{str(sample id): clause list} over the given splits, each layout first
    sorted by label, then lexicographically (the order the AR pipeline's
    consumers see: clause letters index into it)."""
    from ralf_tpu_torch.core.layout import Layout
    from ralf_tpu_torch.core.relationships import describe_relationships
    from ralf_tpu_torch.data.transforms import compose

    sort = compose(["sort_label", "sort_lexicographic"])
    rng = np.random.default_rng(0)  # the sorts draw nothing
    table: dict = {}
    for ds in datasets:
        idx = np.arange(len(ds))
        lay = ds.get_layouts(idx)
        out = {k: v.copy() for k, v in lay.items()}
        for b in range(idx.shape[0]):
            n = int(lay["mask"][b].sum())
            if n <= 1:
                continue
            sample = sort({k: lay[k][b, :n] for k in
                           ("label", "center_x", "center_y", "width", "height")}, rng)
            for k, v in sample.items():
                out[k][b, :n] = v
        for i, r in zip(ds.get_ids(idx), describe_relationships(Layout.fromdict(out))):
            table[str(i)] = r
    return table


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--what", choices=["retrieval", "clusters", "relationships"], required=True)
    p.add_argument("--dataset", default="pku10")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="the synthetic splits of 64/16/16 canvases")
    p.add_argument("--cache-dir", default="cache")
    p.add_argument("--top-k", type=int, default=32)
    p.add_argument("--backbone", default="saliency",
                   help="saliency, dreamsim, clip or vgg")
    p.add_argument("--rerank", choices=["none", "mmr", "random", "lpips"], default="none")
    p.add_argument("--lpips-size", type=int, default=224, help="LPIPS input resolution")
    p.add_argument("--lpips-net", choices=["alex", "vgg"], default="alex",
                   help="alex: AlexNet with the learned lins (cache/lpips_alex.pth); vgg: "
                        "VGG16's taps on the R_shm checkpoint")
    p.add_argument("--cross-dataset-dir", default=None,
                   help="the gallery from another dataset (cross-dataset study)")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without CUDA) or cpu")
    return p


def build_retrieval(args, train_ds, val_ds, test_ds, dev) -> None:
    from ralf_tpu_torch import cache as cache_mod
    from ralf_tpu_torch.config import FrameworkConfig, build_datasets
    from ralf_tpu_torch.data.dataset import DatasetConfig
    from ralf_tpu_torch.retrieval.retriever import Retriever, mmr_rerank

    gallery_ds, gallery_name, table_key = train_ds, args.dataset, args.dataset
    if args.cross_dataset_dir:
        other = FrameworkConfig(dataset=DatasetConfig(
            name="cgl" if "pku" in args.dataset else "pku10", data_dir=args.cross_dataset_dir))
        gallery_ds = build_datasets(other)[0]
        gallery_name = other.dataset.name
        # never the same key as a same-dataset table: a normal run would load foreign neighbours
        table_key = f"{args.dataset}_gallery_{gallery_name}"
    retriever = Retriever.build(gallery_ds, args.backbone, cache_dir=args.cache_dir,
                                dataset_name=gallery_name, device=dev)
    for split, ds in (("train", train_ds), ("val", val_ds), ("test", test_ds)):
        table = retriever.precompute_table(
            ds, args.top_k, is_train_split=split == "train" and not args.cross_dataset_dir)
        backbone_key = args.backbone
        if args.rerank == "mmr":
            feats = retriever.features.cpu().numpy()
            out = np.zeros_like(table[:, : args.top_k // 2])
            for s in range(0, len(ds), 256):
                idx = np.arange(s, min(s + 256, len(ds)))
                qf = retriever.embed(ds.get_images(idx)).float().cpu().numpy()
                out[idx] = mmr_rerank(feats, table[idx], qf, args.top_k // 2)
            table = out
        elif args.rerank == "lpips":
            from ralf_tpu_torch.retrieval.lpips import lpips_rerank

            table = lpips_rerank(ds.get_images, table, gallery_ds.get_images,
                                 cache_dir=args.cache_dir, size=args.lpips_size,
                                 net=args.lpips_net, device=dev)
            backbone_key = "lpips"
        path = cache_mod.save_retrieval_table(args.cache_dir, table_key, split, backbone_key,
                                              table)
        logging.info("%s: table %s -> %s", split, table.shape, path)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    from ralf_tpu_torch import cache as cache_mod
    from ralf_tpu_torch.config import FrameworkConfig, build_datasets
    from ralf_tpu_torch.data.dataset import DatasetConfig
    from ralf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = FrameworkConfig(dataset=DatasetConfig(name=args.dataset, data_dir=args.data_dir),
                          synthetic_data=args.synthetic, debug=args.debug)
    train_ds, val_ds, test_ds = build_datasets(cfg)
    os.makedirs(args.cache_dir, exist_ok=True)

    if args.what == "retrieval":
        build_retrieval(args, train_ds, val_ds, test_ds, dev)
    elif args.what == "clusters":
        from ralf_tpu_torch.core.bucketizer import fit_kmeans_1d
        from ralf_tpu_torch.core.layout import GEO_KEYS

        lay = train_ds.get_layouts(np.arange(len(train_ds)))
        weights = {f"{key}-{n}": fit_kmeans_1d(lay[key][lay["mask"]], n)
                   for key in GEO_KEYS for n in [2**i for i in range(1, 9)]}
        path = cache_mod.kmeans_clusters_path(args.cache_dir, args.dataset)
        with open(path, "wb") as f:
            pickle.dump(weights, f)
        logging.info("wrote %s (%d entries)", path, len(weights))
    else:
        table = build_relationships_table([train_ds, val_ds, test_ds])
        path = cache_mod.save_relationships(args.cache_dir, args.dataset, table)
        logging.info("wrote %s (%d samples)", path, len(table))


if __name__ == "__main__":
    main()
