"""Load the JAX package's variables into the port's modules.

`load_jax_params(module, params, batch_stats=None)` takes the flax variable
tree as nested dicts of numpy arrays (`variables["params"]`,
`variables["batch_stats"]`) and walks it: the port names its submodules
after the flax tree, so the leaf at `a/b/c/kernel` lands in submodule
`a.b.c`.  Conversions by the submodule's type:

  * nn.Linear:    kernel [in, out] -> weight [out, in]; bias -> bias
  * nn.Conv2d:    kernel HWIO -> weight OIHW; bias -> bias
  * nn.Conv1d:    kernel [k, in, out] -> weight [out, in, k]; bias -> bias
  * nn.LSTM:      the flax cells `l{layer}_d{d}` (d 1: the reverse direction,
                  torch's `_reverse`) of `OptimizedLSTMCell`s, one Dense per
                  gate: `i{g}/kernel` (no bias) -> rows g of
                  weight_ih_l{layer}, `h{g}/kernel`, `h{g}/bias` -> rows g of
                  weight_hh_l{layer}, bias_hh_l{layer}, for the gates g in
                  torch's packed order i, f, g, o; bias_ih_l{layer} takes
                  zeros (export adds it into the h biases: the two sum)
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
import re
from collections import Counter

import numpy as np
import torch
from torch import nn

from ralf_tpu_torch.models.resnet import BatchNorm

_RENAMES = {
    nn.Linear: {"kernel": "weight", "bias": "bias"},
    nn.Conv2d: {"kernel": "weight", "bias": "bias"},
    nn.Conv1d: {"kernel": "weight", "bias": "bias"},
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
            elif leaf == "kernel" and isinstance(mod, nn.Conv1d):
                value = value.transpose(2, 1, 0)
            return names[leaf], value
    return leaf, value


LSTM_GATES = "ifgo"  # torch's packing order of an LSTM's gates along the rows


def _lstm_cell(cell: str) -> tuple[int, str]:
    """`l{layer}_d{d}` -> (layer, torch's direction suffix)."""
    m = re.fullmatch(r"l(\d+)_d([01])", cell)
    if m is None:
        raise KeyError(f"{cell!r} is not an LSTM cell l<layer>_d<0|1>")
    return int(m.group(1)), ("", "_reverse")[int(m.group(2))]


def _lstm_writes(name: str, lstm: nn.LSTM, cell: str, gate: str, leaf: str, value: np.ndarray):
    """The (torch name, rows, value) writes of one flax LSTM leaf."""
    layer, sfx = _lstm_cell(cell)
    kind, g = gate[:1], gate[1:]
    if kind not in ("i", "h") or g not in tuple(LSTM_GATES) or (kind, leaf) not in (
            ("i", "kernel"), ("h", "kernel"), ("h", "bias")):
        raise KeyError(f"no port tensor for JAX LSTM leaf {cell}/{gate}/{leaf}")
    H = lstm.hidden_size
    rows = slice(LSTM_GATES.index(g) * H, (LSTM_GATES.index(g) + 1) * H)
    tensor = f"{name}.{'weight' if leaf == 'kernel' else 'bias'}_{kind}h_l{layer}{sfx}"
    writes = [(tensor, rows, value.T if leaf == "kernel" else value)]
    if kind == "i":  # flax's input Dense has no bias
        writes.append((f"{name}.bias_ih_l{layer}{sfx}", rows, np.zeros(H, np.float32)))
    return writes


def load_jax_params(module: nn.Module, params: dict, batch_stats: dict | None = None) -> None:
    """Copy a flax variable tree into `module` in place (see the module docstring)."""
    targets = dict(module.named_parameters())
    targets.update((n, b) for n, b in module.named_buffers()
                   if n.endswith(("running_mean", "running_var")))
    lstms = {n: m for n, m in module.named_modules() if isinstance(m, nn.LSTM)}
    filled = set()
    gates = Counter()  # an LSTM tensor is filled when its 4 gates are
    trees = [params] + ([batch_stats] if batch_stats else [])
    for tree in trees:
        for path, value in _leaves(tree):
            *mod_path, leaf = path
            lstm = ".".join(mod_path[:-2])
            if len(mod_path) >= 2 and lstm in lstms:
                for full, rows, v in _lstm_writes(lstm, lstms[lstm], *mod_path[-2:], leaf, value):
                    with torch.no_grad():
                        dst = targets[full][rows]
                        if tuple(dst.shape) != v.shape:
                            raise ValueError(
                                f"{full}: port shape {tuple(dst.shape)} != JAX {v.shape}")
                        dst.copy_(torch.from_numpy(np.array(v)))
                    gates[full] += 1
                    if gates[full] == len(LSTM_GATES):
                        filled.add(full)
                continue
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
        if isinstance(mod, nn.LSTM):  # weight_ih_l0 -> (..., 'l0_d0', 'i', 'kernel'): 4 gates
            m = re.fullmatch(r"(weight|bias)_(i|h)h_l(\d+)(_reverse)?", name)
            cell = f"l{m.group(3)}_d{int(m.group(4) is not None)}"
            leaf = "kernel" if m.group(1) == "weight" else "bias"
            out[full] = (*mod_path, cell, m.group(2), leaf)
            continue
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
    lstms = {n: m for n, m in module.named_modules() if isinstance(m, nn.LSTM)}
    for full, (*mod_path, leaf) in flax_names(module).items():
        mod = module.get_submodule(full.rpartition(".")[0])
        if isinstance(mod, nn.LSTM):
            continue  # below, a cell at a time
        # a copy: on the CPU .numpy() shares the module's storage, which
        # training then changes in place
        value = tensors[full].detach().float().cpu().numpy().copy()
        if leaf == "kernel" and isinstance(mod, nn.Linear):
            value = value.T
        elif leaf == "kernel" and isinstance(mod, nn.Conv2d):
            value = value.transpose(2, 3, 1, 0)
        elif leaf == "kernel" and isinstance(mod, nn.Conv1d):
            value = value.transpose(2, 1, 0)
        tree = batch_stats if leaf in ("mean", "var") and isinstance(mod, BatchNorm) else params
        for p in mod_path:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.ascontiguousarray(value)
    for name, lstm in lstms.items():
        tree = params
        for p in name.split("."):
            tree = tree.setdefault(p, {})
        _export_lstm(lstm, tree)
    return params, batch_stats


def _export_lstm(lstm: nn.LSTM, tree: dict) -> None:
    """The flax cells of `lstm` into `tree`: per gate g, `i{g}/kernel` and
    `h{g}/{kernel,bias}`, the two torch biases summed into the h bias."""
    H = lstm.hidden_size

    def arr(t):
        return t.detach().float().cpu().numpy()

    for layer in range(lstm.num_layers):
        for d, sfx in enumerate(("", "_reverse")[: 1 + int(lstm.bidirectional)]):
            w_ih, w_hh = (arr(getattr(lstm, f"weight_{k}_l{layer}{sfx}")) for k in ("ih", "hh"))
            b = sum(arr(getattr(lstm, f"bias_{k}_l{layer}{sfx}")) for k in ("ih", "hh"))
            cell = tree.setdefault(f"l{layer}_d{d}", {})
            for gi, g in enumerate(LSTM_GATES):
                rows = slice(gi * H, (gi + 1) * H)
                cell[f"i{g}"] = {"kernel": np.ascontiguousarray(w_ih[rows].T)}
                cell[f"h{g}"] = {"kernel": np.ascontiguousarray(w_hh[rows].T),
                                 "bias": np.ascontiguousarray(b[rows])}


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
