"""Plain LayoutDM (arXiv:2303.08137, as RALF's repository re-implements it:
the `layoutdm` preset) in float32: the image memory, the timestep-
conditioned decoder's logits, and one reverse step of the constrained
mask-and-replace discrete diffusion, all in log space over [B, L, V]:

    memory    = Transformer(ResNet50-FPN_cgl(ImageNet-normalised canvas) + sine2d)
    logits    = Decoder(x_t, t | memory)                             [B, L, V]
    log p(x0) = log_softmax(logits without MASK) + each position's sub-vocabulary
    log p(x_{t-1} | x_t) = q_posterior(log p(x0), x_t, t)

The transition tables (a per-attribute schedule: each position replaces
only within its attribute's tokens and PAD) are worked out here from the
schedule's end points, as the program works out its own.  Weight names are
the program's module paths."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.references.blocks import (
    LN_EPS,
    Weights,
    attention,
    conv,
    encoder,
    ffn,
    layer_norm,
    linear,
    resnet,
    sine_2d,
)

LOG_EPS = math.log(1e-30)
ATT_1, ATT_T, CTT_1, CTT_T = 0.999, 0.0001, 0.0001, 0.9
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GEO_KEYS = ("center_x", "center_y", "width", "height")
VAR_ORDER = ("label", "width", "height", "center_x", "center_y")


class Vocab:
    """The diffusion tokenizer's arithmetic: labels, 4 x num_bin k-means bins
    (one range per attribute, in GEO_KEYS order), then pad and mask."""

    def __init__(self, num_labels: int, num_bin: int, S: int) -> None:
        self.L, self.nb, self.S = num_labels, num_bin, S
        self.pad = num_labels + 4 * num_bin
        self.mask = self.pad + 1
        self.V = self.pad + 2

    def decode(self, tokens: np.ndarray, centers: dict) -> dict:
        """tokens [B, 5S] -> layout arrays [B, S]: an element is valid when its
        label and bins are in range; geometry is its bin's k-means centre."""
        B = tokens.shape[0]
        t = tokens.reshape(B, self.S, 5).astype(np.int64)
        vals = {var: t[..., i] - (0 if var == "label" else self.attribute_tokens(var)[0])
                for i, var in enumerate(VAR_ORDER)}
        valid = (vals["label"] >= 0) & (vals["label"] < self.L)
        for k in GEO_KEYS:
            valid &= (vals[k] >= 0) & (vals[k] < self.nb)
        out = {"label": np.where(valid, vals["label"], 0), "mask": valid}
        for k in GEO_KEYS:
            c = np.sort(np.asarray(centers[k], np.float64)).astype(np.float32)
            out[k] = np.where(valid, c[np.clip(vals[k], 0, self.nb - 1)], 0.0).astype(np.float32)
        return out

    def attribute_tokens(self, var: str) -> np.ndarray:
        if var == "label":
            return np.arange(self.L)
        off = self.L + GEO_KEYS.index(var) * self.nb
        return np.arange(off, off + self.nb)


def schedule(T: int, N: int) -> tuple:
    """(at, bt, ct) [T] and the cumulative (att, btt, ctt) [T + 1], row T the
    identity: alpha falls and the mask share rises linearly between the
    end points; N is the number of tokens a step can replace with."""
    att = np.concatenate([[1.0], np.linspace(ATT_1, ATT_T, T)])
    ctt = np.concatenate([[0.0], np.linspace(CTT_1, CTT_T, T)])
    at = att[1:] / att[:-1]
    ct = 1 - (1 - ctt[1:]) / (1 - ctt[:-1])
    bt = (1 - at - ct) / N
    att, ctt = np.append(att[1:], 1.0), np.append(ctt[1:], 0.0)
    return at, bt, ct, att, (1 - att - ctt) / N, ctt


class Tables:
    """Log tables [T(+1), L] per position and the sub-vocabulary `ind` [L, V]."""

    def __init__(self, vocab: Vocab, T: int, device) -> None:
        L = 5 * vocab.S
        per_var, ind = [], np.full((5, vocab.V), LOG_EPS)
        for g, var in enumerate(VAR_ORDER):
            toks = vocab.attribute_tokens(var)
            ind[g, toks] = ind[g, vocab.pad] = 0.0
            per_var.append(schedule(T, len(toks) + 1))
        group = np.arange(L) % 5

        def log(i):
            x = np.stack([p[i] for p in per_var], 1)[:, group]
            return x

        at, bt, ct, att, btt, ctt = (log(i) for i in range(6))

        def t(x):
            return torch.as_tensor(np.log(np.clip(x, 1e-30, None)), dtype=torch.float32,
                                   device=device)

        self.at, self.bt, self.ct, self.one_ct = t(at), t(bt), t(ct), t(1 - ct)
        self.att, self.btt, self.ctt, self.one_ctt = t(att), t(btt), t(ctt), t(1 - ctt)
        self.ind = torch.as_tensor(ind[group], dtype=torch.float32, device=device)
        self.T = T


def lae(a, b):
    return torch.logaddexp(a, b)


def q_pred_one(tb: Tables, log_x: torch.Tensor, t: int) -> torch.Tensor:
    """log q(x_t | x_{t-1})."""
    g = lambda x: x[t][None, :, None]  # noqa: E731
    keep = lae(log_x[..., :-1] + g(tb.at), g(tb.bt) + tb.ind[None, :, :-1])
    return torch.cat([keep, lae(log_x[..., -1:] + g(tb.one_ct), g(tb.ct))], -1)


def q_pred(tb: Tables, log_x0: torch.Tensor, t: int) -> torch.Tensor:
    """log q(x_t | x_0); t = -1 is row T, the identity."""
    t = t % (tb.T + 1)
    g = lambda x: x[t][None, :, None]  # noqa: E731
    keep = lae(log_x0[..., :-1] + g(tb.att), g(tb.btt) + tb.ind[None, :, :-1])
    return torch.cat([keep, lae(log_x0[..., -1:] + g(tb.one_ctt), g(tb.ctt))], -1)


def onehot(x: torch.Tensor, V: int) -> torch.Tensor:
    return torch.where(F.one_hot(x.long(), V).bool(), 0.0, LOG_EPS)


def posterior(tb: Tables, log_x0: torch.Tensor, x_t: torch.Tensor, t: int, V: int):
    """log p(x_{t-1} | x_t) = log sum_x0 q(x_{t-1} | x_t, x0) p(x0), clamped
    to [-70, 0]; columns outside a position's sub-vocabulary carry LOG_EPS."""
    log_xt = onehot(x_t, V)
    is_mask = (x_t == V - 1)[..., None]
    g = lambda x: x[t][None, :, None]  # noqa: E731
    log_qt = torch.where(is_mask, g(tb.ctt), q_pred(tb, log_xt, t)[..., :-1])
    log_qt1 = q_pred_one(tb, log_xt, t)
    eps = torch.full_like(log_qt1[..., -1:], LOG_EPS)
    log_qt1 = torch.cat([log_qt1[..., :-1], eps], -1)
    ct_row = torch.cat([g(tb.ct).expand_as(log_qt1[..., :-1]), torch.zeros_like(eps)], -1)
    log_qt1 = torch.where(is_mask, ct_row, log_qt1)
    inside = tb.ind[None, :, :-1] > 0.5 * LOG_EPS
    q = torch.where(inside, log_x0[..., :-1] - log_qt, LOG_EPS)
    q = torch.cat([q, torch.full_like(q[..., :1], LOG_EPS)], -1)
    norm = torch.logsumexp(q, -1, keepdim=True)
    return torch.clamp(q_pred(tb, q - norm, t - 1) + log_qt1 + norm, -70.0, 0.0)


def predict_start(tb: Tables, logits: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits[..., :-1], -1) + tb.ind[None, :, :-1]
    return torch.clamp(torch.cat([lp, torch.full_like(lp[..., :1], -70.0)], -1), -70.0, 0.0)


def memory(w: Weights, cfg: dict, image: np.ndarray, device) -> torch.Tensor:
    """[B, M, D] for canvases [B, H, W, 4] uint8."""
    m = cfg["model"]
    d = m["d_model"]
    ext = w.sub("encoder.extractor")
    x = torch.as_tensor(image, device=device).float().div(255.0)
    mean = torch.tensor(IMAGENET_MEAN + (0.0,), device=device)
    std = torch.tensor(IMAGENET_STD + (1.0,), device=device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    f3, f4 = resnet(ext.sub("trunk"), x)
    up = F.interpolate(conv(ext, f4, "conv11"), size=f3.shape[-2:], mode="bilinear",
                       align_corners=False)
    feat = torch.cat([up, conv(ext, up + conv(ext, f3, "conv22"), "conv33")], 1)
    B, _, h, wd = feat.shape
    seq = feat.permute(0, 2, 3, 1).reshape(B, h * wd, d) + sine_2d(h, wd, d).to(device)
    return encoder(w.sub("encoder.transformer"), seq, m["num_encoder_layers"], m["nhead"])


def timestep_embedding(d: int, T: int, t: torch.Tensor) -> torch.Tensor:
    """[sin, cos] of t / T * 4000 at the frequencies exp(-i log(10000) / (d/2 - 1))."""
    half = d // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float64) * (-math.log(10000.0) / (half - 1)))
    arg = (t.double() / T * 4000.0)[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], -1).float()


def ada_norm(w: Weights, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    scale, shift = linear(w, F.silu(emb), "Dense_0")[:, None, :].chunk(2, -1)
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS) * (1 + scale) + shift


def decoder_logits(w: Weights, cfg: dict, mem: torch.Tensor, x_t: torch.Tensor,
                   t: int) -> torch.Tensor:
    """Logits [B, L, V] of the decoder at tokens x_t [B, L] and timestep t."""
    m = cfg["model"]
    d, nhead = m["d_model"], m["nhead"]
    B, L = x_t.shape
    dw = w.sub("decoder")
    idx = torch.arange(L, device=x_t.device)
    pe = torch.cat([dw("ElemAttrPositionalEncoding1D_0.Embed_0.weight")[idx % 5],
                    dw("ElemAttrPositionalEncoding1D_0.Embed_1.weight")[idx // 5]], -1)
    x = dw("Embed_0.weight")[x_t] * math.sqrt(d) + pe
    emb = timestep_embedding(d, cfg["num_timesteps"], torch.full((B,), t, device=x_t.device))
    for i in range(m["num_decoder_layers"]):
        lw = dw.sub(f"layer_{i}")
        h = ada_norm(lw.sub("AdaLayerNorm_0"), x, emb)
        x = x + attention(lw.sub("MultiHeadAttention_0"), h, h, nhead)
        h = ada_norm(lw.sub("AdaLayerNorm_1"), x, emb)
        x = x + attention(lw.sub("MultiHeadAttention_1"), h, mem, nhead)
        x = x + ffn(lw.sub("FeedForward_0"), layer_norm(lw, x, "LayerNorm_0"))
    return linear(dw, layer_norm(dw, x, "LayerNorm_0"), "Dense_0")


def step_log_prob(w: Weights, cfg: dict, tb: Tables, mem: torch.Tensor, x_t: torch.Tensor,
                  t: int, V: int) -> torch.Tensor:
    """log p(x_{t-1} | x_t) [B, L, V] of the unconditional reverse step."""
    return posterior(tb, predict_start(tb, decoder_logits(w, cfg, mem, x_t, t)), x_t, t, V)


def fit_kmeans_1d(values: np.ndarray, k: int, iters: int = 50) -> np.ndarray:
    """Sorted 1-d k-means centres (Lloyd's; a value goes to the centre whose
    midpoints with its neighbours enclose it), started at spread quantiles;
    an empty cluster keeps its centre."""
    v = np.sort(np.asarray(values, np.float64).reshape(-1))
    c = np.quantile(v, np.linspace(0.0, 1.0, k + 2)[1:-1])
    cs = np.concatenate([[0.0], np.cumsum(v)])
    for _ in range(iters):
        c = np.sort(c)
        edges = np.concatenate([[0], np.searchsorted(v, (c[:-1] + c[1:]) / 2), [v.size]])
        counts = np.diff(edges)
        sums = cs[edges[1:]] - cs[edges[:-1]]
        c = np.where(counts > 0, sums / np.maximum(counts, 1), c)
    return np.sort(c)
