"""Weights made from the run's seed on the card, in the type they are served
in, in one draw: every floating tensor of a module's state dict (parameters
and BatchNorm statistics) is a slice of one standard-normal tensor, scaled
by a law that depends on the tensor's name and shape alone:

  conv kernels (4-d)           N(0, 2 / fan_in)   He: ReLU follows them
  other matrices (2-d and up)  N(0, 1 / fan_in)   fan_in = prod(shape[1:])
  `bn3.weight` (a bottleneck's last BatchNorm)   0.25 (1 + 0.05 n)
  other 1-d `weight`s (LayerNorm, BatchNorm)      1 + 0.05 n
  `running_mean`               0.05 n
  `running_var`                1 + 0.1 |n|
  other 1-d tensors (biases)   0.02 n

The small last BatchNorm of each bottleneck keeps the residual stream of a
ResNet in eval mode (running statistics, no batch normalisation) near unit
scale over 16 blocks, as trained networks are.  The program's own
initialisation is overwritten; the plain references read these same
tensors (`seeded_weights` returns them), never the program's."""

from __future__ import annotations

import math

import numpy as np


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    words = np.random.SeedSequence([seed % 2**64, *tag.encode()]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def _law(name: str, x):
    leaf = name.rsplit(".", 1)[-1]
    if x.dim() >= 2:
        fan_in = math.prod(x.shape[1:])
        return x * math.sqrt((2.0 if x.dim() == 4 else 1.0) / fan_in)
    if leaf == "running_mean":
        return 0.05 * x
    if leaf == "running_var":
        return 1.0 + 0.1 * x.abs()
    if leaf == "weight":
        return (0.25 if name.endswith("bn3.weight") else 1.0) * (1.0 + 0.05 * x)
    return 0.02 * x


def seeded_weights(torch, module, seed: int, device) -> dict:
    """{name: tensor} for every floating tensor of `module.state_dict()`, on
    `device` in that tensor's dtype, drawn from `seed` in one call."""
    state = {n: t for n, t in module.state_dict().items() if t.is_floating_point()}
    total = sum(t.numel() for t in state.values())
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, t in state.items():
        x = flat[off : off + t.numel()].view(t.shape)
        off += t.numel()
        out[name] = _law(name, x).to(t.dtype)
    return out


def load(torch, module, weights: dict) -> None:
    """Copy the weights into the module's own tensors."""
    with torch.no_grad():
        state = module.state_dict()
        for name, w in weights.items():
            state[name].copy_(w)
