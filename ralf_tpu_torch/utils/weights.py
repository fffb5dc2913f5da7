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

`export_params(module)` is its inverse: the port's tensors as the flax
tree (float32 numpy copies).  A checkpoint travels between the packages as a flat
`.npz` whose keys are `params/<flax path>` and `batch_stats/<flax path>`
(`save_params_npz`, `load_params_npz`); a JAX job writes one from its
restored TrainState with numpy alone (README.md, "The port's CLIs").
"""

from __future__ import annotations

import os

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


_INVERSE = {cls: {v: k for k, v in names.items()} for cls, names in _RENAMES.items()}


def flax_names(module: nn.Module) -> dict[str, tuple[str, ...]]:
    """The flax path of each parameter and BatchNorm statistic of `module`,
    by its torch name (`encoder.trunk.conv1.weight` -> `('encoder', 'trunk',
    'conv1', 'kernel')`): the map that `load_jax_params` and `export_params`
    go by, and the one the optimizer's decay mask and groups are read from
    (`train.optim`), so that both packages partition the same leaves."""
    tensors = [n for n, _ in module.named_parameters()]
    tensors += [n for n, _ in module.named_buffers() if n.endswith(("running_mean", "running_var"))]
    out = {}
    for full in tensors:
        *mod_path, name = full.split(".")
        mod = module.get_submodule(".".join(mod_path))
        leaf = next((names[name] for cls, names in _INVERSE.items()
                     if isinstance(mod, cls) and name in names), name)
        out[full] = (*mod_path, leaf)
    return out


def export_params(module: nn.Module) -> tuple[dict, dict]:
    """The inverse of `load_jax_params`: (params, batch_stats) as nested
    dicts of float32 numpy arrays in the flax layout."""
    params: dict = {}
    batch_stats: dict = {}
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    for full, (*mod_path, leaf) in flax_names(module).items():
        mod = module.get_submodule(".".join(mod_path))
        # a copy: on the CPU .numpy() shares the module's storage, which
        # training then changes in place
        value = tensors[full].detach().float().cpu().numpy().copy()
        if leaf == "kernel" and isinstance(mod, nn.Linear):
            value = value.T
        elif leaf == "kernel" and isinstance(mod, nn.Conv2d):
            value = value.transpose(2, 3, 1, 0)
        tree = batch_stats if leaf in ("mean", "var") and isinstance(mod, BatchNorm) else params
        for p in mod_path:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.ascontiguousarray(value)
    return params, batch_stats


def save_params_npz(path: str, params: dict, batch_stats: dict | None = None) -> None:
    """Write the flax tree as a flat `.npz`: keys `params/<path>`, `batch_stats/<path>`."""
    flat = {f"params/{'/'.join(k)}": v for k, v in _leaves(params)}
    flat.update((f"batch_stats/{'/'.join(k)}", v) for k, v in _leaves(batch_stats or {}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str) -> tuple[dict, dict]:
    """A flat `.npz` of the flax tree -> (params, batch_stats) nested dicts,
    what `load_jax_params` takes.  A key outside the two collections raises."""
    trees: dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            collection, _, rest = key.partition("/")
            if collection not in trees or not rest:
                raise KeyError(f"{path}: key {key!r} is not params/<path> or batch_stats/<path>")
            *mods, leaf = rest.split("/")
            tree = trees[collection]
            for m in mods:
                tree = tree.setdefault(m, {})
            tree[leaf] = z[key]
    return trees["params"], trees["batch_stats"]
