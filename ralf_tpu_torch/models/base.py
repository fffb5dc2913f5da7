"""Generator configuration, the counterpart of `ralf_tpu/models/base.py`,
and what every generator of the port does alike: building its core from
a seed on its device (`build_core`), bringing a condition's canvases
there (`device_image`), and the zoo's FFN width (`zoo_feedforward`).

The config's dtype is the compute dtype, and `build_core` casts the core
to it whole, which is how a core serves.  A core that trains keeps fp32
parameters and BatchNorm statistics, as flax keeps `param_dtype` float32:
the trainer casts it back to fp32 (`train.trainer.Trainer`) and its steps
compute in the config's dtype under `torch.autocast` (`autocast`);
`compute_dtype` gives the modules that dtype.  The kernels' wrappers run
with autocast off (`ops._build.RecomputedBackward`).

It holds every field of JAX's `GeneratorConfig`, with the same defaults, so
that a job dir's `config.json` written by either package loads in the
other.  `dropout` and `label_smoothing` are training fields; the sample
paths read neither.  `dtype` takes a torch dtype, None (float32), or the
text JAX's `json.dump(..., default=str)` writes for one ("bfloat16",
"<class 'jax.numpy.bfloat16'>", "float32", ...).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.utils import tracing

_DTYPE_NAMES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}


def parse_dtype(value: Any) -> Optional[torch.dtype]:
    """None, a torch dtype, or a dtype's text -> a torch dtype (None stays None)."""
    if value is None or isinstance(value, torch.dtype):
        return value
    text = str(value)
    # "<class 'jax.numpy.bfloat16'>", "torch.bfloat16", "dtype('float32')", "bfloat16"
    found = [d for name, d in _DTYPE_NAMES.items() if re.search(rf"\b{name}\b", text)]
    if len(found) != 1:
        raise ValueError(f"model.dtype {value!r}: expected one of {sorted(_DTYPE_NAMES)} or None")
    return found[0]


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    d_model: int = 256
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 1024
    dropout: float = 0.1
    backbone: str = "resnet50"
    label_smoothing: float = 0.1
    dtype: Optional[torch.dtype] = None  # compute and parameter dtype; None -> float32

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", parse_dtype(self.dtype))


def zoo_feedforward(cfg: GeneratorConfig) -> int:
    """The FFN width of MaskGIT's and the diffusion models' encoders and
    decoders: 2048 at d_model 256, else 4 d_model (not `dim_feedforward`)."""
    return 2048 if cfg.d_model == 256 else 4 * cfg.d_model


def build_core(make: Callable[[], nn.Module], cfg: GeneratorConfig, device: torch.device,
               seed: int) -> nn.Module:
    """`make()` with torch's global generator seeded by `seed` (and left as it
    was), on `device` in the config's dtype, in eval mode, needing no grad."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        core = make()
    core = core.to(device=device, dtype=cfg.dtype or torch.float32).eval()
    core.requires_grad_(False)
    return core


def autocast(cfg: GeneratorConfig, device: torch.device):
    """The context a train or eval step of an fp32 core runs in: autocast to
    the config's dtype, or nothing for fp32."""
    if cfg.dtype in (None, torch.float32):
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=cfg.dtype)


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a module computes in on `t`'s device: autocast's inside a
    bf16 train step, else `t`'s own (a parameter's, where the core was
    cast whole)."""
    dev = t.device.type
    if dev in ("cpu", "cuda") and torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return t.dtype


def device_image(image: Any, device: torch.device) -> torch.Tensor:
    """A condition's canvases [B, H, W, 4] (numpy or tensor) on `device`
    (traced: their host bytes counted, `utils.tracing.count_h2d`)."""
    tracing.count_h2d(image)
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.asarray(image))
    return image.to(device)
