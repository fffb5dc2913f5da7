"""KV-cached, batched, constrained autoregressive decode, the counterpart of
`ralf_tpu/ops/decode_loop.py` (`ar_decode`).

A Python loop over `max_len` single-token steps with static shapes; per
step: embed -> N cached decoder layers (the cross-attention operand is
prepared once before the loop) -> logit head -> static per-position
`token_mask` -> per-sample `forced` tokens -> sampling.  Nothing inside the
loop reads a value back to the host, so the steps queue on the device
without waiting.  Traced (`utils.tracing`), the decode is the span
`ar.decode` and each step two: `ar.decode.layers` (the embedding and the
layer stack) and `ar.decode.sample` (the head through the token's write).
"""

from __future__ import annotations

from typing import Optional

import torch

from ralf_tpu_torch.core.sampling import NEG_INF, SamplingConfig, sample
from ralf_tpu_torch.models.nn import TokenDecoder
from ralf_tpu_torch.utils import tracing


def ar_decode(
    decoder: TokenDecoder,
    memory: torch.Tensor,  # [B, M, D]
    mem_keep: Optional[torch.Tensor],  # [B, M] or None
    token_mask: torch.Tensor,  # [L, V] bool
    forced: torch.Tensor,  # [B, L] int, -1 free, else the token the step must emit
    max_len: int,
    bos_id: int,
    pad_id: int,
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    kv_quant: bool = False,  # one int8 copy of the shared memory (K3 instead of K2)
    self_quant: bool = False,  # int8 per-token self-attention caches
    q8_mxu: bool = False,  # with kv_quant: int8 contractions (K4 instead of K3)
) -> torch.Tensor:
    """Sampled token sequences [B, L] (int64, BOS stripped).  q8_mxu has no
    effect without kv_quant."""
    with tracing.span("ar.decode"):
        B, dev = memory.shape[0], memory.device
        dtype = decoder.emb.weight.dtype
        V = token_mask.shape[1]
        cache = decoder.stack.init_cache(B, max_len, self_quant, dtype=dtype, device=dev)
        cross = decoder.stack.cross_kv(memory, kv_quant, dtype=dtype)
        prev = torch.full((B,), bos_id, dtype=torch.long, device=dev)
        keep = torch.zeros((B, max_len), dtype=torch.bool, device=dev)
        positions = torch.arange(max_len, device=dev)
        vocab_iota = torch.arange(V, device=dev)
        forced = forced.to(device=dev, dtype=torch.long)
        token_mask = token_mask.to(dev)
        toks = torch.empty((B, max_len), dtype=torch.long, device=dev)
        for t in range(max_len):
            with tracing.span("ar.decode.layers"):
                keep[:, t] = prev != pad_id  # a fed pad token is not attended
                self_keep = keep & (positions <= t)[None, :]
                x = decoder.embed_step(prev, t)
                x = decoder.stack.step(x, t, cache, cross, self_keep, mem_keep, q8_mxu)
            with tracing.span("ar.decode.sample"):
                logits = decoder.head(x)[:, 0].float()  # [B, V]
                logits = torch.where(token_mask[t][None, :], logits, NEG_INF)
                f = forced[:, t]
                forced_logits = torch.where(vocab_iota[None, :] == f[:, None], 0.0, NEG_INF)
                logits = torch.where((f >= 0)[:, None], forced_logits, logits)
                prev = sample(logits, sampling, generator)
                toks[:, t] = prev
        return toks
