"""Plain RALF training steps in float32: what a step of the `ralf` preset
computes, worked out again from the benchmark's own inputs.

For each step, from the rows of the split that the step trained on:

    layouts   each row's elements sorted as the AR presets sort them: by
              label (stable), then in raster order, top edge then left edge
    tokens    BOS, per element [label, width, height, center_x, center_y]
              bins (linear: bin i holds (i/n, (i+1)/n], 0 holds 0), EOS in
              the first free slot, pad after
    memory    `references/ralf.py::memory` over the canvases, the rows'
              neighbours in the split and the task's constraint, with
              dropout and BatchNorm as in training
    loss      label-smoothed cross entropy of the decoder fed tokens[:-1]
              against tokens[1:], the mean over non-pad targets:
              -(1 - s) log p_target - (s / V) sum_v log p_v
    update    every gradient clipped together to a global norm of at most
              `clip` (the frozen FIDNet tower has none), then AdamW:
              p <- p (1 - lr wd) - lr m^ / (sqrt(v^) + eps), b1 0.9,
              b2 0.999, eps 1e-8; decay on the matrices and kernels of
              linear and convolution layers only (not on embeddings,
              norms, biases or learned tokens); the image trunk at a tenth
              of the learning rate; the FIDNet tower not updated

The dropout masks are the program's draws (a random stream the reference
cannot reproduce): the step is followed from the masks that the program's
dropout modules applied, given by module path.  Nothing here imports the
program."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.references import ralf as ref
from benchmark.references.blocks import Weights

BETAS = (0.9, 0.999)
EPS = 1e-8
TRUNK = "encoder.extractor.trunk."
FROZEN = "layout_encoder."
STATS = ("running_mean", "running_var")
EMBEDDINGS = ("emb", "Embed_0", "emb_label")  # tables of an embedding, never decayed


def sort_elements(lay: dict) -> dict:
    """Each row's valid elements (the first ones) sorted by label (stable),
    then by top edge and left edge."""
    out = {k: np.array(v, copy=True) for k, v in lay.items()}
    keys = ("label", *ref.GEO_KEYS)
    for b in range(lay["label"].shape[0]):
        n = int(lay["mask"][b].sum())
        if n <= 1:
            continue
        row = {k: out[k][b, :n][np.argsort(out["label"][b, :n], kind="stable")] for k in keys}
        top = row["center_y"] - row["height"] / 2
        left = row["center_x"] - row["width"] / 2
        order = np.lexsort((left, top))
        for k in keys:
            out[k][b, :n] = row[k][order]
    return out


def tokens(lay: dict, vocab: ref.Vocab) -> np.ndarray:
    """[B, 5S + 1]: BOS, the elements' tokens, EOS in the first free slot
    (none when the layout is full), pad."""
    B, S = lay["label"].shape
    edges = (np.arange(1, vocab.nb + 1, dtype=np.float64) / vocab.nb).astype(np.float32)
    cols = {"label": lay["label"].astype(np.int64)}
    for k in ref.GEO_KEYS:
        x = np.clip(lay[k].astype(np.float32), 0.0, 1.0)
        cols[k] = np.searchsorted(edges, x, side="left") + vocab.geo_offset(k)
    seq = np.stack([cols[k] for k in ref.VAR_ORDER], -1)  # [B, S, 5]
    seq = np.where(lay["mask"][..., None], seq, vocab.pad).reshape(B, 5 * S)
    n = lay["mask"].sum(1) * 5
    pos = np.arange(5 * S)[None, :]
    seq = np.where(pos == n[:, None], vocab.eos, seq)
    return np.concatenate([np.full((B, 1), vocab.bos), seq], 1)


def step_inputs(cfg: dict, split: dict, canvases: np.ndarray, table: np.ndarray,
                rows: np.ndarray, vocab: ref.Vocab) -> dict:
    """What a step over `rows` of the split takes: canvases, the rows'
    neighbours' layouts (as the split holds them) and the sorted rows'
    tokens."""
    K = cfg["retrieval"]["top_k"]
    nbrs = table[rows][:, :K]
    return {"image": canvases[rows % len(canvases)],
            "retrieved": {k: v[nbrs] for k, v in split.items()},
            "tokens": tokens(sort_elements({k: v[rows] for k, v in split.items()}), vocab)}


def loss(w: Weights, cfg: dict, inputs: dict, vocab: ref.Vocab, device) -> torch.Tensor:
    seq = torch.as_tensor(inputs["tokens"], device=device)
    mem = ref.memory(w, cfg, inputs["image"], inputs["retrieved"], vocab.uncond_constraint(),
                     device)
    logits = ref.decoder_forward(w, cfg, mem, seq[:, :-1], vocab)
    logp = torch.log_softmax(logits, -1)
    tgt = seq[:, 1:]
    s = cfg["model"]["label_smoothing"]
    per = -((1.0 - s) * logp.gather(-1, tgt[..., None])[..., 0] + s / vocab.V * logp.sum(-1))
    keep = (tgt != vocab.pad).float()
    return (per * keep).sum() / keep.sum()


def trainable(weights: dict) -> list[str]:
    return [n for n in weights if not n.startswith(FROZEN) and n.rsplit(".", 1)[-1] not in STATS]


def decayed(name: str, x: torch.Tensor) -> bool:
    """A linear or convolution layer's matrix or kernel."""
    parts = name.rsplit(".", 2)
    return parts[-1] == "weight" and x.dim() >= 2 and parts[-2] not in EMBEDDINGS


class AdamW:
    """The clip over every gradient, then AdamW (see the module docstring)."""

    def __init__(self, params: dict, names: list, train_cfg: dict) -> None:
        self.params, self.names, self.t = params, names, 0
        lr, wd = train_cfg["lr"], train_cfg["weight_decay"]
        self.clip = train_cfg["clip_max_norm"]
        self.lr = {n: lr * (0.1 if n.startswith(TRUNK) else 1.0) for n in names}
        self.wd = {n: wd if decayed(n, params[n]) else 0.0 for n in names}
        self.m = {n: torch.zeros_like(params[n]) for n in names}
        self.v = {n: torch.zeros_like(params[n]) for n in names}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Update in place; returns the clipped gradients."""
        g = {n: torch.zeros_like(self.params[n]) if grads[n] is None else grads[n]
             for n in self.names}
        norm = math.sqrt(sum(float(x.double().square().sum()) for x in g.values()))
        scale = min(1.0, self.clip / norm) if self.clip and norm > 0 else 1.0
        self.t += 1
        b1, b2 = BETAS
        for n in self.names:
            p, gn = self.params[n], g[n] * scale
            g[n] = gn
            p.mul_(1.0 - self.lr[n] * self.wd[n])
            self.m[n] = b1 * self.m[n] + (1.0 - b1) * gn
            self.v[n] = b2 * self.v[n] + (1.0 - b2) * gn.square()
            mhat = self.m[n] / (1.0 - b1**self.t)
            vhat = self.v[n] / (1.0 - b2**self.t)
            p.sub_(self.lr[n] * mhat / (vhat.sqrt() + EPS))
        return g


def follow(cfg: dict, weights: dict, steps: list, masks: list, device,
           low: str | None = None) -> dict:
    """Follow the steps from the initial `weights` ({name: tensor}, the
    benchmark's): {'loss': [float], 'grad': {leaf: norm of the first step's
    clipped gradient}, 'change': {leaf: norm of the change after the
    steps}} of the trainable leaves.  With `low`, every matrix product and
    convolution takes operands rounded to that type."""
    tc, v = cfg["train"], ref.Vocab(cfg["dataset"]["num_labels"], cfg["tokenizer"]["num_bin"],
                                    cfg["dataset"]["max_seq_length"])
    params = {n: t.detach().float().clone() for n, t in weights.items()}
    names = trainable(params)
    for n in names:
        params[n].requires_grad_(True)
    opt = AdamW(params, names, tc)
    out = {"loss": []}
    for k, (inputs, m) in enumerate(zip(steps, masks)):
        w = Weights(params, low=low, masks=m, rate=cfg["model"]["dropout"])
        value = loss(w, cfg, inputs, v, device)
        grads = torch.autograd.grad(value, [params[n] for n in names], allow_unused=True)
        out["loss"].append(float(value.detach()))
        clipped = opt.step(dict(zip(names, grads)))
        if k == 0:
            out["grad"] = {n: float(clipped[n].norm()) for n in names}
        del value, grads, clipped
    out["change"] = {n: float((params[n].detach() - weights[n].float()).norm()) for n in names}
    return out
