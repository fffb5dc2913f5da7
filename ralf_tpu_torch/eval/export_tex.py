"""Aggregate eval scores into LaTeX table rows, the counterpart of
`ralf_tpu/eval/export_tex.py`: walks the job dirs under a root, reads each
`generated_samples_*/scores_all.json`, and emits one row per job and task
in the paper's column order.

    python -m ralf_tpu_torch.eval.export_tex --jobs-root tmp/jobs [--out table.tex]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

# the paper's column order
METRIC_COLUMNS = [
    "fid",
    "alignment-LayoutGAN++",
    "overlay",
    "underlay_effectiveness_loose",
    "underlay_effectiveness_strict",
    "utilization",
    "occlusion",
    "unreadability",
    "validity",
]


def row_for(scores: dict, name: str) -> str:
    cells = []
    for m in METRIC_COLUMNS:
        if m in scores:
            v = scores[m]
            mean = v["mean"] if isinstance(v, dict) else v
            cells.append(f"{mean:.4f}")
        else:
            cells.append("--")
    return name + " & " + " & ".join(cells) + r" \\"


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--jobs-root", required=True,
                   help="directory containing job dirs with generated_samples_*")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    lines = ["% " + " & ".join(["method/task"] + METRIC_COLUMNS)]
    for path in sorted(
        glob.glob(os.path.join(args.jobs_root, "*", "generated_samples_*",
                               "scores_all.json"))
    ):
        with open(path) as f:
            scores = json.load(f)
        job = os.path.basename(os.path.dirname(os.path.dirname(path)))
        task = os.path.basename(os.path.dirname(path)).replace(
            "generated_samples_", ""
        )
        lines.append(row_for(scores, f"{job}/{task}"))

    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
