"""The raw-annotation readers of the offline dataset build, the port's own
copy of `ralf_tpu/preprocess/readers.py` (plain Python; pandas for PKU's
csv files, imported when they are read).

  * `read_pku`: PKU's csv annotations (labels 1-indexed: text, logo,
    underlay), the corrupt posters of the NG list dropped, and samples with
    no element or more than `max_seq_length` dropped.
  * `read_cgl`: CGL's COCO-style json (4 classes used; `yinhe.json` is the
    unannotated test split).
  * `load_split_mapping`: the data_splits txt files -> {identifier: split}.

A sample is a dict with normalized cxcywh elements.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

PKU_CANVAS_W, PKU_CANVAS_H = 513, 750  # original canvas size
PKU_LABELS = {1: "text", 2: "logo", 3: "underlay"}  # csv is 1-indexed
PKU_CSV_FILES = {"train": "train_csv_9973.csv", "test": "test_csv_905.csv"}
# corrupt posters excluded by the reference (`helpers/pku.py:14-26`)
PKU_NG_KEYS = {
    "train/183.png", "train/208.png", "train/827.png", "train/1478.png",
    "train/1739.png", "train/4038.png", "train/5821.png", "train/8145.png",
    "train/8433.png",
}

CGL_LABELS = {1: "logo", 2: "text", 3: "underlay", 4: "embellishment"}
CGL_JSON_FILES = {
    "train": "layout_train_6w_fixed_v2.json",
    "validation": "layout_test_6w_fixed_v2.json",
    "test": "yinhe.json",  # unannotated
}


def _valid_area(cx, cy, w, h) -> bool:
    return w > 0 and h > 0


def read_pku(dataset_root: str, max_seq_length: int = 10) -> list[dict]:
    import pandas as pd

    samples = []
    for split, csv_name in PKU_CSV_FILES.items():
        df = pd.read_csv(os.path.join(dataset_root, "annotation", csv_name))
        is_test = len(df.columns) == 1
        for key, sub in df.groupby(by="poster_path"):
            if key in PKU_NG_KEYS:
                continue
            name = key.split("/")[-1]
            id_ = name.split(".")[0]
            identifier = f"test/{key}" if split == "test" else key
            elements = []
            if not is_test:
                for _, row in sub.iterrows():
                    lab = PKU_LABELS.get(int(row.cls_elem))
                    if lab is None:
                        continue
                    l, t, r, b = json.loads(str(row.box_elem))
                    cx = (l + r) / 2.0 / PKU_CANVAS_W
                    cy = (t + b) / 2.0 / PKU_CANVAS_H
                    w = (r - l) / PKU_CANVAS_W
                    h = (b - t) / PKU_CANVAS_H
                    if _valid_area(cx, cy, w, h):
                        elements.append(
                            {"label": lab, "center_x": cx, "center_y": cy,
                             "width": w, "height": h}
                        )
                n = len(elements)
                if n == 0 or n > max_seq_length:
                    continue
            samples.append({"id": str(id_), "identifier": identifier,
                            "split": split, "elements": elements,
                            "image_width": PKU_CANVAS_W,
                            "image_height": PKU_CANVAS_H})
    return samples


def read_cgl(dataset_root: str, max_seq_length: int = 10) -> list[dict]:
    samples = []
    for split, json_name in CGL_JSON_FILES.items():
        with open(os.path.join(dataset_root, "annotation", json_name)) as f:
            data = json.load(f)
        prefix = "test" if split == "test" else "train"
        info = {
            a["id"]: {"id": str(a["file_name"].split(".")[0]),
                      "image_width": a["width"], "image_height": a["height"],
                      "identifier": f"{prefix}/{a['file_name']}",
                      "split": split}
            for a in data["images"]
        }
        objs = defaultdict(list)
        for anns in data.get("annotations", []):
            for ann in anns:
                lab = CGL_LABELS.get(ann["category_id"])
                if lab is None:
                    continue
                meta = info[ann["image_id"]]
                l, t, w, h = ann["bbox"]
                gw, gh = meta["image_width"], meta["image_height"]
                el = {"label": lab,
                      "center_x": (l + w / 2) / gw,
                      "center_y": (t + h / 2) / gh,
                      "width": w / gw, "height": h / gh}
                if _valid_area(el["center_x"], el["center_y"],
                               el["width"], el["height"]):
                    objs[ann["image_id"]].append(el)
        for id_, meta in info.items():
            elements = [] if split == "test" else objs[id_]
            if split != "test":
                n = len(elements)
                if n == 0 or n > max_seq_length:
                    continue
            samples.append({**meta, "elements": elements})
    return samples


def load_split_mapping(splits_dir: str) -> dict[str, str]:
    """data_splits txt files -> {identifier: split_name}
    (`dump_dataset.py:74-92`)."""
    mapping = {}
    for name in os.listdir(splits_dir):
        if not name.endswith(".txt"):
            continue
        split = name[:-4]
        prefix = "test" if split == "with_no_annotation" else "train"
        with open(os.path.join(splits_dir, name)) as f:
            for line in f:
                line = line.strip()
                if line:
                    mapping[f"{prefix}/{line}.png"] = split
    return mapping
