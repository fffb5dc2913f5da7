"""Plain building blocks shared by the references, written from the models'
equations (the layer names are the flax tree's, which the program's
modules keep):

- LayerNorm at eps 1e-6 (flax's); attention masks as additive -1e9;
- multi-head attention q, k, v, out projections with biases, scores scaled
  by Dh^-1/2, softmax over keys;
- pre-LN encoder layers (x + SA(LN1 x); x + FFN(LN2 x), FFN = Dense_1
  relu Dense_0) and FIDNet's post-LN ones (LN1(x + SA x); LN2(x + FFN x));
- the bottleneck ResNet with BatchNorm from running statistics, or in
  training from the batch's (biased) statistics;
- the interleaved 1-d sine table and the normalised 2-d sine table (DETR);
- in training, dropout where the program's modules put it (attention
  probabilities, each residual branch, the FFN's hidden layer, the 1-d
  positional encodings), applying the keep masks that the program drew,
  given by module path: x / (1 - rate) where kept, else 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
BN_EPS = 1e-5
NEG = -1e9


class Weights:
    """A {name: tensor} dict read in float32 under a prefix.  With `low`
    ('int8', 'fp8' or 'tf32') every matrix product and convolution takes
    operands rounded to that type (`fake_low`): the lower-precision controls.
    With `masks` ({module path: bool keep mask}, dropout at `rate`) the
    modules run as in training: dropout applies those masks and BatchNorm
    takes the batch's statistics."""

    def __init__(self, tensors: dict, prefix: str = "", low: str | None = None,
                 masks: dict | None = None, rate: float = 0.0) -> None:
        self.tensors, self.prefix, self.low = tensors, prefix, low
        self.masks, self.rate = masks, rate

    @property
    def training(self) -> bool:
        return self.masks is not None

    def __call__(self, name: str) -> torch.Tensor:
        return self.tensors[self.prefix + name].float()

    def has(self, name: str) -> bool:
        return self.prefix + name in self.tensors

    def sub(self, name: str) -> "Weights":
        return Weights(self.tensors, self.prefix + name + ".", self.low, self.masks, self.rate)

    def frozen(self) -> "Weights":
        """The same weights as in inference: no dropout, running statistics."""
        return Weights(self.tensors, self.prefix, self.low)

    def drop(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Dropout `name` (a module path under the prefix) in training."""
        if self.masks is None:
            return x
        keep = self.masks[self.prefix + name].to(x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), device=x.device))


def fake_low(x: torch.Tensor, dim: int, low: str) -> torch.Tensor:
    """x rounded to int8 (absmax to 127) or to fp8 e4m3 (absmax to 448) with
    one scale along `dim` (a row of a weight matrix or kernel, a token's or a
    pixel's channels), or to TF32 (10 mantissa bits, to nearest), back in
    float32."""
    if low == "tf32":
        bits = x.detach().float().contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x + (rounded - x).detach()  # the gradient passes as through float32
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    if low == "int8":
        s = amax / 127.0
        return torch.round(x / s).clamp(-127, 127) * s
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def linear(w: Weights, x: torch.Tensor, name: str) -> torch.Tensor:
    b = w(name + ".bias") if w.has(name + ".bias") else None
    k = w(name + ".weight")
    if w.low:
        x, k = fake_low(x, -1, w.low), fake_low(k, -1, w.low)
    return F.linear(x, k, b)


def layer_norm(w: Weights, x: torch.Tensor, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w(name + ".weight"), w(name + ".bias"), LN_EPS)


def attention(w: Weights, q_in: torch.Tensor, kv_in: torch.Tensor, nhead: int,
              bias=None) -> torch.Tensor:
    """Multi-head attention of module `w` (q_proj, k_proj, v_proj,
    out_proj); bias broadcasts to [B, H, S, M]."""
    B, S, D = q_in.shape
    M, Dh = kv_in.shape[1], D // nhead
    q = linear(w, q_in, "q_proj").view(B, S, nhead, Dh) * Dh**-0.5
    k = linear(w, kv_in, "k_proj").view(B, M, nhead, Dh)
    v = linear(w, kv_in, "v_proj").view(B, M, nhead, Dh)
    logits = torch.einsum("bshd,bmhd->bhsm", q, k)
    if bias is not None:
        logits = logits + bias
    out = torch.einsum("bhsm,bmhd->bshd", w.drop("attn_drop", torch.softmax(logits, -1)), v)
    return linear(w, out.reshape(B, S, D), "out_proj")


def ffn(w: Weights, x: torch.Tensor) -> torch.Tensor:
    return linear(w, w.drop("drop", F.relu(linear(w, x, "Dense_0"))), "Dense_1")


def keep_bias(keep: torch.Tensor) -> torch.Tensor:
    """bool keep [B, M] -> additive key bias [B, 1, 1, M]."""
    return torch.where(keep, 0.0, NEG)[:, None, None, :].float()


def encoder(w: Weights, x: torch.Tensor, layers: int, nhead: int, keep=None,
            norm_first: bool = True) -> torch.Tensor:
    """The stack `layer_0 ..` of a TransformerEncoder."""
    bias = None if keep is None else keep_bias(keep)
    for i in range(layers):
        lw = w.sub(f"layer_{i}")
        if norm_first:
            h = layer_norm(lw, x, "norm1")
            x = x + lw.drop("drop1", attention(lw.sub("self_attn"), h, h, nhead, bias))
            x = x + lw.drop("drop2", ffn(lw.sub("ffn"), layer_norm(lw, x, "norm2")))
        else:
            a = lw.drop("drop1", attention(lw.sub("self_attn"), x, x, nhead, bias))
            x = layer_norm(lw, x + a, "norm1")
            x = layer_norm(lw, x + lw.drop("drop2", ffn(lw.sub("ffn"), x)), "norm2")
    return x


def sincos_1d(n: int, d: int) -> torch.Tensor:
    """pe[p, 2i] = sin(p / 10000^(2i/d)), pe[p, 2i+1] = cos(...)."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-math.log(10000.0) / d))
    pe = np.zeros((n, d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe).float()


def sine_2d(h: int, w: int, d: int) -> torch.Tensor:
    """[h*w, d]: the y half then the x half, positions scaled to [0, 2 pi],
    frequencies 10000^(2 floor(i/2) / (d/2)), sin on even and cos on odd
    channels."""
    half = d // 2
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dim_t = 10000.0 ** (2 * (np.arange(half) // 2) / half)
    parts = []
    for grid, n in ((ys, h), (xs, w)):
        p = (grid / max(n - 1, 1) * 2 * np.pi).reshape(-1)[:, None] / dim_t
        p[:, 0::2], p[:, 1::2] = np.sin(p[:, 0::2]), np.cos(p[:, 1::2])
        parts.append(p)
    return torch.from_numpy(np.concatenate(parts, 1)).float()


def batch_norm(w: Weights, x: torch.Tensor, name: str) -> torch.Tensor:
    if w.training:  # the batch's mean and biased variance
        return F.batch_norm(x, None, None, w(name + ".weight"), w(name + ".bias"), True, 0.0,
                            BN_EPS)
    return F.batch_norm(x, w(name + ".running_mean"), w(name + ".running_var"),
                        w(name + ".weight"), w(name + ".bias"), False, 0.0, BN_EPS)


def conv(w: Weights, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
    k = w(name + ".weight")
    b = w(name + ".bias") if w.has(name + ".bias") else None
    if w.low:
        x, k = fake_low(x, 1, w.low), fake_low(k.flatten(1), 1, w.low).view_as(k)
    return F.conv2d(x, k, b, stride=stride, padding=k.shape[-1] // 2)


def resnet(w: Weights, x: torch.Tensor, depths=(3, 4, 6, 3)) -> tuple[torch.Tensor, torch.Tensor]:
    """Bottleneck ResNet (stride on the 3x3) over NCHW -> (layer3, layer4)."""
    y = F.relu(batch_norm(w, conv(w, x, "conv1", 2), "bn1"))
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    taps = []
    for stage, n in enumerate(depths):
        for b in range(n):
            bw = w.sub(f"layer{stage + 1}_{b}")
            stride = 2 if (b == 0 and stage > 0) else 1
            z = F.relu(batch_norm(bw, conv(bw, y, "conv1"), "bn1"))
            z = F.relu(batch_norm(bw, conv(bw, z, "conv2", stride), "bn2"))
            z = batch_norm(bw, conv(bw, z, "conv3"), "bn3")
            res = batch_norm(bw, conv(bw, y, "down_conv", stride), "down_bn") \
                if bw.has("down_conv.weight") else y
            y = F.relu(z + res)
        if stage >= 2:
            taps.append(y)
    return taps[0], taps[1]
