"""Training configuration, the counterpart of `ralf_tpu/train/trainer.py`'s
`TrainConfig`.

Only the dataclass is here: a job dir's `config.json` holds it, and the
inference and evaluation entry points read that file.  The trainer itself
comes with the port's training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
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
    save_every_steps: int = 0
    save_every_secs: float = 0.0
    log_every_steps: int = 50
    profile_steps: Optional[tuple] = None
    tensorboard: bool = False
    render_every_epochs: int = 0
    gallery_shards: int = 1
