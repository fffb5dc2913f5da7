"""Evaluation entry point, the counterpart of `ralf_tpu/cli/evaluate.py`:
it reads the inference pickles of a `generated_samples_*` directory and
writes `scores_all.json` and `scores_all.txt` (per split with `--split
both`) with the JAX package's keys and format: validity, alignment,
overlap, overlay, underlay effectiveness, the saliency-aware metrics, and
FID with precision/recall/density/coverage over FIDNet features against
the GT split, each as the mean and std over the seeds.

    python -m ralf_tpu_torch.cli.evaluate --input-dir tmp/jobs/x/generated_samples_uncond \\
        --job-dir tmp/jobs/x [--fidnet-dir tmp/fidnet] [--device cpu]

The metrics run in torch on `--device` (the card by default, which raises
without CUDA); FIDNet's encoder runs K1 with its key mask there.  Trained
FIDNet parameters come from `<fidnet-dir>/fidnet_ckpt.npz` (the flax tree
as a flat `.npz`; the orbax directory `fidnet_ckpt/` alone is not read).
Without `--fidnet-dir` the extractor is a seeded torch init, which cannot
equal JAX's `jax.random` init: its GT features are cached under the tag
`untrained_torch`, never JAX's `untrained`, so a JAX-written cache is never
compared with features of another network.  Canvases stream
`--eval-batch-size` at a time.  `--image-metrics` needs the InceptionV3 and
VGG16 towers, not ported yet.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import pickle

import numpy as np
import torch

from ralf_tpu_torch.core.layout import GEO_KEYS, Layout

UNTRAINED_TAG = "untrained_torch"


def records_to_layout(records: list[dict], S: int, device="cpu") -> Layout:
    B = len(records)
    arrs = {k: np.zeros((B, S), np.float32) for k in GEO_KEYS}
    label = np.zeros((B, S), np.int64)
    mask = np.zeros((B, S), bool)
    for i, r in enumerate(records):
        n = min(len(r["label"]), S)
        label[i, :n] = r["label"][:n]
        mask[i, :n] = True
        for k in arrs:
            arrs[k][i, :n] = r[k][:n]
    return Layout.fromdict({"label": label, "mask": mask, **arrs}, device=device)


def _gt_records(ds, idx) -> list[dict]:
    lay = ds.get_layouts(idx)
    out = []
    for i in range(len(idx)):
        m = lay["mask"][i]
        out.append({"label": lay["label"][i][m].tolist(),
                    **{k: lay[k][i][m].tolist() for k in GEO_KEYS}})
    return out


def _take(layout: Layout, idx: np.ndarray) -> Layout:
    i = torch.as_tensor(idx, device=layout.label.device)
    return Layout(**{k: getattr(layout, k)[i] for k in ("label", *GEO_KEYS, "mask")})


def build_fidnet(num_labels: int, S: int, fidnet_dir, device):
    """(FIDNetV3 on `device` in eval mode, the GT-feature cache tag): the
    trained one through `FIDNetTrainer.load`, as JAX's CLI loads it, else a
    seeded one without its auxiliary heads."""
    if fidnet_dir:
        from ralf_tpu_torch.train.fid_trainer import FIDNetTrainer

        trainer = FIDNetTrainer(num_labels, S, job_dir=fidnet_dir, device=device)
        return trainer.load(), "trained"
    from ralf_tpu_torch.models.fidnet import FIDNetV3

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fidnet = FIDNetV3(num_labels, max_bbox=S, aux_heads=False)
    logging.warning("no --fidnet-dir: FID uses an UNTRAINED extractor (seeded torch init)")
    return fidnet.to(device).eval(), UNTRAINED_TAG


@torch.inference_mode()
def fidnet_features(fidnet, layout: Layout, chunk: int = 4096) -> np.ndarray:
    B = layout.label.shape[0]
    out = [fidnet.extract_features(_take(layout, np.arange(s, min(s + chunk, B))))
           .float().cpu().numpy() for s in range(0, B, chunk)]
    return np.concatenate(out, 0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-dir", required=True)
    p.add_argument("--job-dir", default=None)
    p.add_argument("--split", default="test", choices=["val", "test", "both"],
                   help="'both' evaluates the val and the test pickles in one run")
    p.add_argument("--fidnet-dir", default=None,
                   help="directory of a trained FIDNet's fidnet_ckpt.npz")
    p.add_argument("--cache-dir", default="cache", help="the GT-feature cache")
    p.add_argument("--image-metrics", action="store_true",
                   help="image-FID and R_shm: need towers not ported yet")
    p.add_argument("--unannotated", action="store_true",
                   help="no-GT split: heuristic metrics only, no FID/prdc")
    p.add_argument("--eval-batch-size", type=int, default=512,
                   help="canvases fetched and scored this many at a time")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def main(argv=None) -> dict:
    """Evaluate; returns the scores written (per split with --split both)."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    from ralf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.image_metrics:
        raise NotImplementedError("--image-metrics needs the InceptionV3 and VGG16 towers, "
                                  "not ported yet (ROADMAP.md Queue A item 9)")

    from ralf_tpu_torch import cache as cache_mod
    from ralf_tpu_torch.config import FrameworkConfig, build_datasets
    from ralf_tpu_torch.data.dataset import unannotated_dataset
    from ralf_tpu_torch.eval.metrics import (
        compute_alignment,
        compute_generative_model_scores,
        compute_overlap,
        compute_overlay,
        compute_saliency_aware_metrics,
        compute_underlay_effectiveness,
        compute_validity,
        nanmean,
    )

    job_dir = args.job_dir or os.path.dirname(args.input_dir.rstrip("/"))
    cfg = FrameworkConfig.load(job_dir)
    S = cfg.dataset.max_seq_length
    names = list(cfg.dataset.label_names)
    text_id = names.index("text") if "text" in names else 0
    underlay_id = names.index("underlay") if "underlay" in names else len(names) - 1

    _, val_ds, test_ds = build_datasets(cfg)
    fidnet, feat_tag = build_fidnet(len(names), S, args.fidnet_dir, dev)

    splits = ["val", "test"] if args.split == "both" else [args.split]
    combined: dict[str, dict] = {}
    for split in splits:
        ds = {"val": val_ds, "test": test_ds}[split]
        if args.unannotated:
            ds = unannotated_dataset(cfg.dataset, ds, split)
        gt_layout = records_to_layout(_gt_records(ds, np.arange(len(ds))), S, dev)
        EB = max(1, args.eval_batch_size)

        gt_feats = None
        if not args.unannotated:
            gt_feats = cache_mod.load_gt_features(args.cache_dir, cfg.dataset.name, split,
                                                  feat_tag, expect_rows=len(ds))
            if gt_feats is None:
                gt_feats = fidnet_features(fidnet, gt_layout)
                cache_mod.save_gt_features(args.cache_dir, cfg.dataset.name, split, feat_tag,
                                           gt_feats)

        all_scores = []
        for pkl_path in sorted(glob.glob(os.path.join(args.input_dir, f"{split}_*.pkl"))):
            if pkl_path.endswith("_violation.pkl"):
                continue
            with open(pkl_path, "rb") as f:
                data = pickle.load(f)
            layout = records_to_layout(data["results"], S, dev)
            layout, validity = compute_validity(layout)
            B = layout.label.shape[0]

            scores = {"validity": float(validity)}
            scores["alignment-LayoutGAN++"] = nanmean(compute_alignment(layout))
            scores["overlap-LayoutGAN++"] = nanmean(compute_overlap(layout))
            scores["overlay"] = nanmean(compute_overlay(layout, underlay_id))
            ue = compute_underlay_effectiveness(layout, underlay_id)
            scores["underlay_effectiveness_loose"] = nanmean(ue["underlay_effectiveness_loose"])
            scores["underlay_effectiveness_strict"] = nanmean(ue["underlay_effectiveness_strict"])

            # the saliency-aware metrics per chunk of canvases: per-sample
            # values concatenate exactly
            sal_parts: dict[str, list] = {}
            for s in range(0, B, EB):
                ci = np.arange(s, min(s + EB, B))
                img = torch.from_numpy(np.asarray(ds.get_images(ci), np.float32)).to(dev)
                sal = compute_saliency_aware_metrics(_take(layout, ci), img, text_id, underlay_id)
                for k, v in sal.items():
                    sal_parts.setdefault(k, []).append(v.cpu().numpy())
            for k in sorted(sal_parts):  # JAX's jitted dict comes back in key order
                scores[k] = nanmean(np.concatenate(sal_parts[k]))

            if gt_feats is not None:
                scores.update(compute_generative_model_scores(gt_feats,
                                                              fidnet_features(fidnet, layout)))
            all_scores.append(scores)
            logging.info("%s: %s", os.path.basename(pkl_path),
                         {k: round(v, 4) for k, v in scores.items()})

        if not all_scores:
            logging.warning("no %s pickles under %s", split, args.input_dir)
            continue
        keys = all_scores[0].keys()
        agg = {k: {"mean": float(np.mean([s[k] for s in all_scores])),
                   "std": float(np.std([s[k] for s in all_scores]))} for k in keys}
        combined[split] = agg
        suffix = "" if args.split != "both" else f"_{split}"
        with open(os.path.join(args.input_dir, f"scores_all{suffix}.json"), "w") as f:
            json.dump(agg, f, indent=2)
        with open(os.path.join(args.input_dir, f"scores_all{suffix}.txt"), "w") as f:
            f.write("\t".join(keys) + "\n")
            f.write("\t".join(f"{agg[k]['mean']:.4f}±{agg[k]['std']:.4f}" for k in keys) + "\n")
    result = combined if args.split == "both" else combined.get(splits[0], {})
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
