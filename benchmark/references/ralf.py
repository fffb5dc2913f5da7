"""Plain RALF (arXiv:2311.13602, the final `concat_crossattn` architecture)
in float32, teacher-forced over served tokens:

    memory  = Transformer(ResNet50-FPN(canvas) + sine2d)            [B, M, D]
    ref     = adapter(FIDNet(retrieved layouts)) * sqrt(D) + sine1d [B, K, D]
    fused   = ViTFFN(concat[memory, CrossAttn(memory, ref), ref])   [B, 2M+K, D]
    memory' = concat[fused + flag_0, ConstEnc(constraint) + flag_1]
    logits  = Decoder(BOS, tokens[:-1] | memory', causal)           [B, L, V]

It works out for itself what the program derives: the retrieved layouts'
FIDNet features (the program's set-up table), the constraint sequence of
the task, the per-position token mask, and the layout that tokens decode
to.  Weight names are the program's module paths (the flax tree's).  With
training weights (`Weights` with dropout masks) the same equations run as
a train step runs them: dropout after each 1-d positional encoding and in
every transformer layer, BatchNorm on the batch's statistics, and the
frozen FIDNet tower as in inference, outside the gradient."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.references.blocks import (
    NEG,
    Weights,
    attention,
    conv,
    encoder,
    ffn,
    layer_norm,
    linear,
    resnet,
    sincos_1d,
    sine_2d,
)

GEO_KEYS = ("center_x", "center_y", "width", "height")
VAR_ORDER = ("label", "width", "height", "center_x", "center_y")
TASK_TOKENS = ("end_of_task", "label", "label_size", "relationship", "refinement",
               "completion", "uncondition")


class Vocab:
    """The AR tokenizer's arithmetic: labels, 4 x num_bin geometry bins (one
    range per attribute, in GEO_KEYS order), then pad, bos, eos."""

    def __init__(self, num_labels: int, num_bin: int, S: int) -> None:
        self.L, self.nb, self.S = num_labels, num_bin, S
        self.pad = num_labels + 4 * num_bin
        self.bos, self.eos = self.pad + 1, self.pad + 2
        self.V = self.pad + 3

    def geo_offset(self, key: str) -> int:
        return self.L + GEO_KEYS.index(key) * self.nb

    def token_mask(self) -> torch.Tensor:
        """bool [5S, V]: labels (or pad, eos) at label slots, the attribute's
        own bins (or pad, eos) at geometry slots."""
        rows = []
        for var in VAR_ORDER:
            r = torch.zeros(self.V, dtype=torch.bool)
            if var == "label":
                r[: self.L] = True
            else:
                r[self.geo_offset(var) : self.geo_offset(var) + self.nb] = True
            r[self.pad] = r[self.eos] = True
            rows.append(r)
        return torch.stack(rows).repeat(self.S, 1)

    def uncond_constraint(self) -> list[int]:
        """[bos, uncondition, end_of_task, eos] in the constraint vocabulary
        (the layout vocabulary, then the task tokens)."""
        return [self.bos, self.V + TASK_TOKENS.index("uncondition"),
                self.V + TASK_TOKENS.index("end_of_task"), self.eos]

    def decode(self, tokens: np.ndarray) -> dict:
        """tokens [B, 5S] -> layout arrays [B, S]: an element is valid when its
        label and bins are in range and no EOS came at or before its label
        slot; geometry is the bin centre (i + 0.5) / num_bin."""
        B = tokens.shape[0]
        t = tokens.reshape(B, self.S, 5).astype(np.int64)
        vals = {var: t[..., i] - (0 if var == "label" else self.geo_offset(var))
                for i, var in enumerate(VAR_ORDER)}
        valid = (vals["label"] >= 0) & (vals["label"] < self.L)
        for k in GEO_KEYS:
            valid &= (vals[k] >= 0) & (vals[k] < self.nb)
        valid &= ~(np.cumsum(t[..., 0] == self.eos, axis=1) > 0)
        out = {"label": np.where(valid, vals["label"], 0), "mask": valid}
        for k in GEO_KEYS:
            out[k] = np.where(valid, (np.clip(vals[k], 0, self.nb - 1) + 0.5) / self.nb,
                              0.0).astype(np.float32)
        return out


def vit_ffn(w: Weights, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm -> Dense -> GELU (tanh) -> Dense."""
    h = linear(w, layer_norm(w, x, "LayerNorm_0"), "Dense_0")
    return linear(w, F.gelu(h, approximate="tanh"), "Dense_1")


def cross_attention(w: Weights, x: torch.Tensor, ctx: torch.Tensor, heads: int = 8,
                    dim_head: int = 64) -> torch.Tensor:
    """Pre-LN on the queries, bias-free to_q and to_kv, to_out with bias."""
    B, N, _ = x.shape
    M = ctx.shape[1]
    q = linear(w, layer_norm(w, x, "LayerNorm_0"), "to_q").view(B, N, heads, dim_head)
    k, v = linear(w, ctx, "to_kv").chunk(2, dim=-1)
    k, v = k.reshape(B, M, heads, dim_head), v.reshape(B, M, heads, dim_head)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * dim_head**-0.5, -1)
    return linear(w, torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(B, N, -1), "to_out")


def fidnet_features(w: Weights, lay: dict, device) -> torch.Tensor:
    """FIDNetV3's CLS feature of each layout [N, S] -> [N, 256]: post-LN
    encoder (4 layers, 4 heads, FFN 128) over [CLS, relu(fc_in(fc_bbox(box),
    emb(label)))] with the padded elements masked."""
    box = torch.stack([torch.as_tensor(lay[k], device=device).float() for k in GEO_KEYS], -1)
    label = torch.as_tensor(lay["label"], device=device).long()
    mask = torch.as_tensor(lay["mask"], device=device).bool()
    h = torch.cat([linear(w, box, "fc_bbox"), w("emb_label.weight")[label]], -1)
    h = F.relu(linear(w, h, "enc_fc_in"))
    N = h.shape[0]
    x = torch.cat([w("cls_token").expand(N, 1, -1), h], 1)
    keep = torch.cat([torch.ones_like(mask[:, :1]), mask], 1)
    return encoder(w.sub("enc_transformer"), x, 4, 4, keep, norm_first=False)[:, 0]


def memory(w: Weights, cfg: dict, image: np.ndarray, retrieved: dict, constraint: list,
           device) -> torch.Tensor:
    """The decoder's memory [B, 2M + K + Lc, D] for canvases [B, H, W, 4]
    uint8 and their neighbours' layouts {key: [B, K, S]}."""
    m = cfg["model"]
    d, nhead, nl = m["d_model"], m["nhead"], m["num_encoder_layers"]
    ext = w.sub("encoder.extractor")
    x = torch.as_tensor(image, device=device).float().div(255.0).permute(0, 3, 1, 2)
    f3, f4 = resnet(ext.sub("trunk"), x)
    f4p, f5p = conv(ext, f3, "fpn_conv11_4"), conv(ext, f4, "fpn_conv11_5")
    f5up = F.interpolate(f5p, size=f4p.shape[-2:], mode="nearest-exact")
    feat = conv(ext, torch.cat([f5up, conv(ext, f5up + f4p, "fpn_conv33")], 1), "proj")
    B, _, h, wd = feat.shape
    seq = feat.permute(0, 2, 3, 1).reshape(B, h * wd, d) + sine_2d(h, wd, d).to(device)
    img = encoder(w.sub("encoder.transformer"), seq, nl, nhead)

    K, S = retrieved["label"].shape[1:]
    flat = {k: np.asarray(v).reshape(B * K, S) for k, v in retrieved.items()}
    with torch.no_grad():  # the frozen tower
        feats = fidnet_features(w.sub("layout_encoder").frozen(), flat, device).view(B, K, -1)
    ref = vit_ffn(w.sub("layout_adapter"), feats) * math.sqrt(d) + sincos_1d(K, d).to(device)
    ref = w.drop("pos_emb_1d.drop", ref)
    ca = cross_attention(w.sub("attn"), img, ref)
    fused = vit_ffn(w.sub("fusion_head"), torch.cat([img, ca, ref], 1))

    cseq = torch.as_tensor(constraint, device=device).long().expand(B, -1)
    ce = w("const_encoder.Embed_0.weight")[cseq] * math.sqrt(d)
    ce = w.drop("const_encoder.pos_emb.drop", ce + sincos_1d(cseq.shape[1], d).to(device))
    const = encoder(w.sub("const_encoder.TransformerEncoder_0"), ce, nl, nhead,
                    keep=torch.ones_like(cseq, dtype=torch.bool))
    flag = w("flag_emb")
    return torch.cat([fused + flag[0], const + flag[1]], 1)


def decoder_logits(w: Weights, cfg: dict, mem: torch.Tensor, tokens: torch.Tensor,
                   vocab: Vocab) -> torch.Tensor:
    """Logits [B, L, V] at every position of served tokens [B, L] (no BOS):
    position t sees BOS and tokens[:t]; a fed pad token is not attended."""
    inp = torch.cat([torch.full_like(tokens[:, :1], vocab.bos), tokens[:, :-1]], 1)
    return decoder_forward(w, cfg, mem, inp, vocab)


def decoder_forward(w: Weights, cfg: dict, mem: torch.Tensor, inp: torch.Tensor,
                    vocab: Vocab) -> torch.Tensor:
    """Logits [B, L, V] of the causal decoder fed `inp` [B, L] (BOS first);
    a fed pad token is not attended."""
    m = cfg["model"]
    d, nhead = m["d_model"], m["nhead"]
    L = inp.shape[1]
    x = w("decoder.emb.weight")[inp] * math.sqrt(d) + sincos_1d(L, d).to(mem.device)
    x = w.drop("decoder.pos_emb.drop", x)
    causal = torch.ones(L, L, dtype=torch.bool, device=mem.device).tril()
    bias = torch.where(causal[None] & (inp != vocab.pad)[:, None, :], 0.0, NEG)[:, None]
    for i in range(m["num_decoder_layers"]):
        lw = w.sub(f"decoder.stack.layer_{i}")
        h = layer_norm(lw, x, "norm1")
        x = x + lw.drop("drop1", attention(lw.sub("self_attn"), h, h, nhead, bias))
        a = attention(lw.sub("cross_attn"), layer_norm(lw, x, "norm2"), mem, nhead)
        x = x + lw.drop("drop2", a)
        x = x + lw.drop("drop3", ffn(lw.sub("ffn"), layer_norm(lw, x, "norm3")))
    return linear(w, layer_norm(w, x, "decoder.head_norm"), "decoder.head_out")


def masked(logits: torch.Tensor, vocab: Vocab) -> torch.Tensor:
    return torch.where(vocab.token_mask().to(logits.device)[None], logits, -math.inf)


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor, vocab: Vocab) -> torch.Tensor:
    """[B, L]: how far each token's logit lies below the best legal logit at
    its position (inf for an illegal token)."""
    lg = masked(logits, vocab)
    return lg.amax(-1) - lg.gather(-1, tokens[..., None].long())[..., 0]
