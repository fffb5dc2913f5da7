"""Model FLOPs of a layout, from a configuration's shapes: the benchmark's
own count, frozen.  A multiply-add is 2 FLOPs; convolutions and matrix
products are counted, normalisations, activations and softmaxes are not.
Work that a layer needs once per sequence (the cross-attention's K and V
of the memory) is counted once, however often an implementation repeats it.
"""

from __future__ import annotations

_BOTTLENECK_DEPTHS = {"resnet50": (3, 4, 6, 3)}
_WIDTHS = (64, 128, 256, 512)


def _out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    """A k x k convolution producing an h x w map."""
    return 2.0 * cin * cout * k * k * h * w


def resnet_taps(backbone: str, H: int, W: int) -> tuple[float, tuple, tuple]:
    """(FLOPs of the 4-channel bottleneck ResNet trunk over an H x W canvas,
    (C, h, w) of layer3, (C, h, w) of layer4)."""
    depths = _BOTTLENECK_DEPTHS[backbone]
    h, w = _out(H, 7, 2), _out(W, 7, 2)
    total = conv(4, 64, 7, h, w)
    h, w = _out(h, 3, 2), _out(w, 3, 2)  # max pool
    cin, taps = 64, []
    for stage, (n, width) in enumerate(zip(depths, _WIDTHS)):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            ho, wo = _out(h, 3, stride), _out(w, 3, stride)
            total += conv(cin, width, 1, h, w) + conv(width, width, 3, ho, wo)
            total += conv(width, 4 * width, 1, ho, wo)
            if cin != 4 * width or stride != 1:
                total += conv(cin, 4 * width, 1, ho, wo)
            cin, h, w = 4 * width, ho, wo
        if stage >= 2:
            taps.append((cin, h, w))
    return total, taps[0], taps[1]


def image_features(backbone: str, H: int, W: int, d: int, fpn_style: str) -> tuple[float, int]:
    """(FLOPs of trunk and FPN head, tokens of the feature map)."""
    total, (c3, h3, w3), (c4, h4, w4) = resnet_taps(backbone, H, W)
    if fpn_style == "ralf":
        total += conv(c3, 256, 1, h3, w3) + conv(c4, 256, 1, h4, w4)
        total += conv(256, 256, 3, h3, w3) + conv(512, d, 1, h3, w3)
    else:  # "cgl"
        half = d // 2
        total += conv(c4, half, 1, h4, w4) + conv(c3, half, 1, h3, w3)
        total += conv(half, half, 1, h3, w3)
    return total, h3 * w3


def attention(S: int, M: int, d: int, inner: int) -> float:
    """Scores and values of S queries over M keys, `inner` wide."""
    return 2.0 * 2 * S * M * inner


def encoder_layer(S: int, d: int, ff: int) -> float:
    """Pre- or post-LN self-attention layer over S tokens."""
    return 2.0 * 4 * S * d * d + attention(S, S, d, d) + 2.0 * 2 * S * d * ff


def vit_ffn(S: int, d_in: int, hidden: int, d_out: int) -> float:
    return 2.0 * S * (d_in * hidden + hidden * d_out)


def ralf_layout(cfg: dict) -> dict[str, float]:
    """FLOPs of one RALF layout served: {'encode', 'decode'}.  The gallery's
    FIDNet features are a set-up table, not work of a request."""
    m, data = cfg["model"], cfg["dataset"]
    d, ff, K = m["d_model"], m["dim_feedforward"], cfg["retrieval"]["top_k"]
    feat, M = image_features(m["backbone"], data["image_h"], data["image_w"], d, "ralf")
    enc = feat + m["num_encoder_layers"] * encoder_layer(M, d, ff)
    enc += vit_ffn(K, 256, 4 * d, d)  # layout adapter
    inner = 8 * 64  # ViTCrossAttention: 8 heads of 64
    enc += 2.0 * M * d * inner + 2.0 * K * d * 2 * inner + attention(M, K, d, inner)
    enc += 2.0 * M * inner * d
    enc += vit_ffn(2 * M + K, d, 4 * d, d)  # fusion head
    Lc = cfg["const_len"]
    enc += m["num_encoder_layers"] * encoder_layer(Lc, d, ff)
    mem = 2 * M + K + Lc
    L = 5 * data["max_seq_length"]
    V = cfg["vocab_size"]
    dec = m["num_decoder_layers"] * 2.0 * 2 * mem * d * d  # cross K, V once
    for t in range(L):
        per = 2.0 * 4 * d * d + attention(1, t + 1, d, d)  # self-attention, cached
        per += 2.0 * 2 * d * d + attention(1, mem, d, d)  # cross-attention
        per += 2.0 * 2 * d * ff
        dec += m["num_decoder_layers"] * per + 2.0 * d * V
    return {"encode": enc, "decode": dec}


def layoutdm_layout(cfg: dict) -> dict[str, float]:
    """FLOPs of one LayoutDM layout served: {'encode', 'decode'}; the
    decoder runs over all L tokens at each of the T steps."""
    m, data = cfg["model"], cfg["dataset"]
    d, ff = m["d_model"], cfg["ffn_dim"]
    feat, M = image_features(m["backbone"], data["image_h"], data["image_w"], d, "cgl")
    enc = feat + m["num_encoder_layers"] * encoder_layer(M, d, ff)
    L, V, T = 5 * data["max_seq_length"], cfg["vocab_size"], cfg["num_timesteps"]
    nl = m["num_decoder_layers"]
    dec = nl * 2.0 * 2 * M * d * d  # cross K, V of the memory once
    per_step = 2.0 * 2 * 2 * d * d * nl  # two AdaLayerNorms' Dense a layer (one timestep row)
    per_step += nl * (encoder_layer(L, d, ff) + 2.0 * 2 * L * d * d + attention(L, M, d, d))
    per_step += 2.0 * L * d * V
    return {"encode": enc, "decode": dec + T * per_step}


def fidnet_layout(S: int) -> float:
    """FIDNetV3's features of one layout: the box embedding (4 to 256), the
    input layer (512 to 256) and 4 post-LN layers (width 256, FFN 128) over
    [CLS, S elements]."""
    return 2.0 * S * (4 * 256 + 512 * 256) + 4 * encoder_layer(S + 1, 256, 128)


def ralf_train_sample(cfg: dict) -> float:
    """FLOPs of one RALF sample in a train step: the forward of the trained
    model (encoder, adapter, fusion, constraint encoder, the decoder
    teacher-forced over every position) three times, for the forward and a
    backward of twice its work, plus the frozen FIDNet tower's forward over
    the sample's neighbours, which takes no gradient."""
    m, data = cfg["model"], cfg["dataset"]
    d, ff, K = m["d_model"], m["dim_feedforward"], cfg["retrieval"]["top_k"]
    feat, M = image_features(m["backbone"], data["image_h"], data["image_w"], d, "ralf")
    fwd = feat + m["num_encoder_layers"] * encoder_layer(M, d, ff)
    fwd += vit_ffn(K, 256, 4 * d, d)  # layout adapter
    inner = 8 * 64  # ViTCrossAttention: 8 heads of 64
    fwd += 2.0 * M * d * inner + 2.0 * K * d * 2 * inner + attention(M, K, d, inner)
    fwd += 2.0 * M * inner * d
    fwd += vit_ffn(2 * M + K, d, 4 * d, d)  # fusion head
    Lc = cfg["const_len"]
    fwd += m["num_encoder_layers"] * encoder_layer(Lc, d, ff)
    mem = 2 * M + K + Lc
    L = 5 * data["max_seq_length"]
    per = 2.0 * 4 * L * d * d + attention(L, L, d, d)  # self-attention
    per += 2.0 * 2 * L * d * d + 2.0 * 2 * mem * d * d + attention(L, mem, d, d)  # cross
    per += 2.0 * 2 * L * d * ff
    fwd += m["num_decoder_layers"] * per + 2.0 * L * d * cfg["vocab_size"]
    return 3.0 * fwd + K * fidnet_layout(data["max_seq_length"])
