"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and an error, never a quiet CPU run, when there is no card."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev
