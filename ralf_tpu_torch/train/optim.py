"""AdamW with the JAX package's parameter groups, the counterpart of
`ralf_tpu/train/optim.py`:

  * weight decay only on the leaves whose flax path ends in `kernel`
    (matmul and conv weights), never on biases, norm scales, embeddings or
    learned tokens; torch calls a LayerNorm's scale and an Embedding's table
    `weight` too, so the mask is read from the flax path of each parameter
    (`utils.weights.flax_names`), the map the weights bridge goes by;
  * the image backbone's trunk (`/trunk/` in the path) at 0.1x the base LR;
  * every leaf whose path holds `/layout_encoder/` outside the optimizer:
    no update and no decay, as optax's `set_to_zero` gives it.  The rule was
    meant for the FIDNet tower of RALF and RA-LayoutDM, but it reads the name
    alone, so ICVT's GT-layout embedding (also `layout_encoder`) stays frozen
    too, as in JAX;
  * an LSTM's input bias (`bias_ih_l*`) outside the optimizer and outside
    the clip's norm: flax's cells have one bias a gate, which the weights
    bridge writes into the hidden bias (`bias_hh_l*`) and holds the input
    bias at zero; both get the same gradient, so training both would step
    the sum twice and count its gradient twice in the norm;
  * optax's `clip_by_global_norm` before the groups, over every gradient,
    the frozen leaves' included: g * max_norm / ||g|| when ||g|| > max_norm
    (torch's clip_grad_norm_ divides by ||g|| + 1e-6 instead).  A frozen
    leaf keeps requires_grad, so that a gradient JAX computes for it (ICVT's
    `layout_encoder` feeds the posterior and the shifted target) counts in
    the norm; one that runs under no_grad (the FIDNet towers, JAX's
    stop_gradient) gets none and counts as zero;
  * `set_learning_rate` rewrites the groups' LRs between epochs, the role
    of optax's inject_hyperparams.

AdamW is torch's, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8
outside the square root): the same update as optax's adamw, p - lr (m^ /
(sqrt(v^) + eps) + wd p), with its roundings in another order.  A trainable
parameter that got no gradient steps with a zero one, as optax's would.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ralf_tpu_torch.utils import tracing
from ralf_tpu_torch.utils.weights import flax_names

TRUNK_KEY = "trunk"  # a segment of the image backbone's param path
FROZEN_KEY = "layout_encoder"  # frozen by name: the FIDNet towers, ICVT's embedding
TRUNK_LR_SCALE = 0.1  # the trunk's LR against the base LR
BETAS = (0.9, 0.999)  # optax's adamw defaults


def _param_paths(module: nn.Module) -> dict[str, tuple[str, ...]]:
    names = flax_names(module)
    return {name: names[name] for name, _ in module.named_parameters()}


def decay_mask(module: nn.Module) -> dict[str, bool]:
    """True where weight decay applies (flax `kernel` leaves), by torch name."""
    return {name: path[-1] == "kernel" for name, path in _param_paths(module).items()}


def lr_group_labels(module: nn.Module) -> dict[str, str]:
    """'frozen' for any `/layout_encoder/` path, 'tied' for an LSTM's input
    bias (no flax leaf), 'trunk' for the image backbone body (0.1x LR),
    'rest' elsewhere, by torch name."""
    labels = {}
    for name, path in _param_paths(module).items():
        s = "/" + "/".join(path) + "/"
        tied = re.fullmatch(r"bias_ih_l\d+(_reverse)?", name.rsplit(".", 1)[-1])
        labels[name] = ("frozen" if f"/{FROZEN_KEY}/" in s else "tied" if tied
                        else "trunk" if f"/{TRUNK_KEY}/" in s else "rest")
    return labels


def global_norm(tensors: list) -> torch.Tensor:
    """sqrt(sum of every element's square) as an fp32 0-dim tensor, summed in
    fp64: torch's fp32 norm of a large CPU tensor drifts by up to 1e-5 from
    optax's `global_norm` (measured on ICVT's gradients), which moves every
    clipped gradient by as much."""
    norms = torch._foreach_norm(tensors, 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


class Optimizer:
    """Clip over every gradient, then AdamW over the trainable groups of
    `module` (see the module docstring)."""

    def __init__(self, module: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.01,
                 clip_max_norm: float = 1.0) -> None:
        self.clip_max_norm = clip_max_norm
        labels, decay = lr_group_labels(module), decay_mask(module)
        groups: dict[tuple[str, bool], list] = {}
        self.frozen, self.tied = [], []
        for name, p in module.named_parameters():
            if labels[name] == "frozen":
                self.frozen.append(p)
            elif labels[name] == "tied":
                self.tied.append(p)
            else:
                groups.setdefault((labels[name], decay[name]), []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.opt = torch.optim.AdamW(
            [{"params": ps, "label": label, "weight_decay": weight_decay if d else 0.0}
             for (label, d), ps in sorted(groups.items())],
            lr=base_lr, betas=BETAS, eps=1e-8)
        self.set_learning_rate(base_lr)

    def set_learning_rate(self, base_lr: float) -> None:
        for g in self.opt.param_groups:
            g["lr"] = base_lr * (TRUNK_LR_SCALE if g["label"] == "trunk" else 1.0)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
        for p in self.frozen + self.tied:
            p.grad = None

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_max_norm and self.clip_max_norm > 0:
            with tracing.span("train.clip"):
                grads = [p.grad for p in self.params]
                frozen = [p.grad for p in self.frozen if p.grad is not None]
                norm = global_norm(grads + frozen)
                # stays on the device: no read-back in the step
                torch._foreach_mul_(grads, torch.clamp(
                    norm.new_tensor(self.clip_max_norm) / norm, max=1.0))
        self.opt.step()

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)
