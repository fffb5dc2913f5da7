"""Load the JAX package's variables into the port's modules.

`load_jax_params(module, params, batch_stats=None)` takes the flax variable
tree as nested dicts of numpy arrays (`variables["params"]`,
`variables["batch_stats"]`) and walks it: the port names its submodules
after the flax tree, so the leaf at `a/b/c/kernel` lands in submodule
`a.b.c`.  Conversions by the submodule's type:

  * nn.Linear:    kernel [in, out] -> weight [out, in]; bias -> bias
  * nn.Conv2d:    kernel HWIO -> weight OIHW; bias -> bias
  * nn.LayerNorm: scale -> weight; bias -> bias
  * nn.Embedding: embedding -> weight
  * BatchNorm:    scale -> weight; bias -> bias; batch_stats mean/var ->
                  running_mean/running_var
  * anything else: a leaf named like one of the module's own parameters
    (flag_emb, cls_token, ...) is copied as it is.

It raises if a leaf has no home in the port, if a shape disagrees, or if a
parameter or BatchNorm statistic of the port was left unfilled.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.models.resnet import BatchNorm

_RENAMES = {
    nn.Linear: {"kernel": "weight", "bias": "bias"},
    nn.Conv2d: {"kernel": "weight", "bias": "bias"},
    nn.LayerNorm: {"scale": "weight", "bias": "bias"},
    nn.Embedding: {"embedding": "weight"},
    BatchNorm: {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"},
}


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(mod: nn.Module, leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    for cls, names in _RENAMES.items():
        if isinstance(mod, cls):
            if leaf not in names:
                break
            if leaf == "kernel" and isinstance(mod, nn.Linear):
                value = value.T
            elif leaf == "kernel" and isinstance(mod, nn.Conv2d):
                value = value.transpose(3, 2, 0, 1)
            return names[leaf], value
    return leaf, value


def load_jax_params(module: nn.Module, params: dict, batch_stats: dict | None = None) -> None:
    """Copy a flax variable tree into `module` in place (see the module docstring)."""
    targets = dict(module.named_parameters())
    targets.update((n, b) for n, b in module.named_buffers()
                   if n.endswith(("running_mean", "running_var")))
    filled = set()
    trees = [params] + ([batch_stats] if batch_stats else [])
    for tree in trees:
        for path, value in _leaves(tree):
            *mod_path, leaf = path
            try:
                mod = module.get_submodule(".".join(mod_path))
            except AttributeError as e:
                raise KeyError(f"no port module for JAX leaf {'/'.join(path)}") from e
            name, value = _convert(mod, leaf, value)
            full = ".".join(mod_path + [name])
            if full not in targets:
                raise KeyError(f"no port tensor for JAX leaf {'/'.join(path)} (tried {full})")
            dst = targets[full]
            if tuple(dst.shape) != value.shape:
                raise ValueError(f"{full}: port shape {tuple(dst.shape)} != JAX {value.shape}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(value)))
            filled.add(full)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port tensors not filled from the JAX tree: {missing}")
