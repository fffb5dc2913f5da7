"""The offline dataset build: raw annotations and images -> parquet shards,
the counterpart of `ralf_tpu/cli/build_dataset.py`.

    python -m ralf_tpu_torch.cli.build_dataset --dataset-type pku \\
        --dataset-root /datasets/PosterLayout/raw \\
        --splits-dir /path/to/data_splits/splits/pku \\
        --output-dir /datasets/PosterLayout/pku10

`--dataset-root` holds `annotation/` (PKU: `train_csv_9973.csv`,
`test_csv_905.csv`; CGL: `layout_train_6w_fixed_v2.json`,
`layout_test_6w_fixed_v2.json`, `yinhe.json`) and `image/{split}/input/*.png`,
`image/{split}/saliency/*.png` and, where it exists,
`image/{split}/saliency_sub/*.png` (the two maps are combined by pixel max).
The saliency maps come from `cli.saliency` (ISNet into `saliency/`, BASNet
into `saliency_sub/`), the inpainted train canvases from
`preprocess/inpainting.py`.  `--splits-dir` holds the data_splits txt files
(`train.txt`, `val.txt`, `test.txt`, `with_no_annotation.txt`).  Images
resize to 240x350 (W x H).  The output is `vocabulary.json` (label counts;
ids are the sorted names) and `{split}/{split}-{i:05d}-of-{n:05d}.parquet`,
written through HF `datasets`, which `data/dataset.py::HFParquetDataset`
reads.  The build does no tensor work: it takes no --device.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from collections import defaultdict


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-type", choices=["pku", "cgl"], required=True)
    p.add_argument("--dataset-root", required=True)
    p.add_argument("--splits-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--max-seq-length", type=int, default=10)
    p.add_argument("--num-shards", type=int, default=8)
    args = p.parse_args(argv)

    import datasets as hfds
    import numpy as np
    from PIL import Image

    from ralf_tpu_torch.data.dataset import IMAGE_H, IMAGE_W
    from ralf_tpu_torch.preprocess.readers import load_split_mapping, read_cgl, read_pku

    reader = read_pku if args.dataset_type == "pku" else read_cgl
    samples = reader(args.dataset_root, args.max_seq_length)
    mapping = load_split_mapping(args.splits_dir)

    per_split = defaultdict(list)
    vocab: dict[str, int] = defaultdict(int)
    for s in samples:
        ident = s["identifier"]
        if ident not in mapping and ident.endswith(".jpg"):
            ident = ident.replace(".jpg", ".png")
        if ident not in mapping:
            continue
        split = mapping[ident]
        base = os.path.join(args.dataset_root, "image", s["split"])
        img = Image.open(os.path.join(base, "input", f"{s['id']}.png")).convert("RGB")
        sal = np.asarray(Image.open(os.path.join(base, "saliency", f"{s['id']}.png")).convert("L"))
        sal_sub_path = os.path.join(base, "saliency_sub", f"{s['id']}.png")
        if os.path.exists(sal_sub_path):
            sal = np.maximum(sal, np.asarray(Image.open(sal_sub_path).convert("L")))
        record = {
            "id": s["id"],
            "image_width": s["image_width"],
            "image_height": s["image_height"],
            "image": img.resize((IMAGE_W, IMAGE_H)),
            "saliency": Image.fromarray(sal).resize((IMAGE_W, IMAGE_H)),
            **{k: [e[k] for e in s["elements"]]
               for k in ("label", "center_x", "center_y", "width", "height")},
        }
        for lab in record["label"]:
            vocab[lab] += 1
        per_split[split].append(record)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "vocabulary.json"), "w") as f:
        json.dump({"label": dict(vocab)}, f)

    names = sorted(vocab)
    for split, records in per_split.items():
        for r in records:
            r["label"] = [names.index(x) for x in r["label"]]
        ds = hfds.Dataset.from_list(records)
        out = os.path.join(args.output_dir, split)
        os.makedirs(out, exist_ok=True)
        shards = args.num_shards if split == "train" else 1
        for i in range(shards):
            shard = ds if shards == 1 else ds.shard(shards, i)
            shard.to_parquet(os.path.join(out, f"{split}-{i:05d}-of-{shards:05d}.parquet"))
        logging.info("%s: %d records", split, len(records))


if __name__ == "__main__":
    main()
