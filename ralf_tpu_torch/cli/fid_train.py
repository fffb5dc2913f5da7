"""Train the per-dataset FIDNetV3 feature extractor, the counterpart of
`ralf_tpu/cli/fid_train.py`:

    python -m ralf_tpu_torch.cli.fid_train --dataset pku10 --job-dir tmp/fidnet/pku10 \\
        --epochs 10 --synthetic

It writes `<job-dir>/fidnet_ckpt.npz` (`train.fid_trainer`), which
`cli.evaluate --fidnet-dir <job-dir>` reads.  `--debug` caps each epoch at
2 steps.  It runs on the card (`--device cuda`, the default, which raises
without CUDA) or on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="pku10")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--job-dir", default=None)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def main(argv=None) -> str:
    """Train; returns the job dir."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from ralf_tpu_torch.config import FrameworkConfig, build_datasets
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig
    from ralf_tpu_torch.train.fid_trainer import FIDNetTrainer
    from ralf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = FrameworkConfig(dataset=DatasetConfig(name=args.dataset, data_dir=args.data_dir),
                          synthetic_data=args.synthetic, debug=args.debug)
    train_ds, _, _ = build_datasets(cfg)
    trainer = FIDNetTrainer(cfg.dataset.num_labels, cfg.dataset.max_seq_length, lr=args.lr,
                            job_dir=args.job_dir or f"tmp/fidnet/{args.dataset}", device=dev)
    loader = BatchLoader(train_ds, args.batch_size, with_images=False)
    trainer.fit(loader, epochs=args.epochs, num_steps_cap=2 if args.debug else None)
    print(f"saved FIDNet to {trainer.job_dir}")
    return trainer.job_dir


if __name__ == "__main__":
    main()
