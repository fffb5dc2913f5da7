"""RALF served through the port's `RALFGenerator` (models/ralf.py), as
`cli/inference.py` serves it: retrieval from a precomputed top-k table with
the frozen FIDNet's gallery feature table gathered per batch.

Set-up, all from the run's seed: the generator in the configuration's
dtype with the seeded weights (`lib/weights.py`), the gallery's layouts
and the program's FIDNet table over them (`precompute_retrieved_feats`,
the program's own set-up), the pool's canvases, their own layouts and their
neighbours, cut into the traffic's batches.

`correct`: after the window, with the program freed, the plain reference
(`references/ralf.py`, float32, TF32 off) reads a sample of the rows that
greedy requests served, drawn from the seed with the longest among them:
over each canvas, its neighbours and its served tokens it gives the logits
at every position, and a served token's gap is how far its logit lies below
the best legal logit there.  The figure compared is `row_gap`, the mean
over the sampled rows of each row's widest gap (`lib/serve.py`); the
widest gap and the mean gap are printed beside it (PERF.md gives why).  Besides, every
served layout of the sample must equal the reference's decoding of its
tokens (`layout_mismatch`), and every token of every request of the window
must be legal at its position (`illegal_tokens`)."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from benchmark.costs import flops
from benchmark.lib import data, launches, serve
from benchmark.lib import weights as wmod
from benchmark.lib.weights import subseed
from benchmark.references import ralf as ref
from benchmark.references.blocks import Weights

CHECK_BLOCK = 16  # reference rows a pass


@dataclasses.dataclass
class Program:
    config: dict
    traffic: dict
    device: object
    gen: object
    tok: object
    task: str
    sampling: object
    greedy: object
    sample_kwargs: dict
    batches: list
    weights: dict
    gallery: dict
    nbrs: np.ndarray
    images: np.ndarray

    def capture(self, greedy: bool):
        """What a request keeps beside its tokens: nothing (the served tokens
        are the decode's whole state)."""
        return contextlib.nullcontext(None)


def vocab(config: dict) -> ref.Vocab:
    d = config["dataset"]
    return ref.Vocab(d["num_labels"], config["tokenizer"]["num_bin"], d["max_seq_length"])


def build(torch, config: dict, traffic: dict, seed: int, device) -> Program:
    from ralf_tpu_torch.core.layout import Layout
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator

    d, K = config["dataset"], config["retrieval"]["top_k"]
    tok = serve.tokenizer(config)
    gcfg = GeneratorConfig(**config["model"], dtype=config["dtype"])
    with torch.device(device):  # the program's own initialisation, overwritten below, on the card
        gen = RALFGenerator(tok, gcfg, traffic["task"], (d["image_h"], d["image_w"]), top_k=K,
                            device=device)
    weights = wmod.seeded_weights(torch, gen.core, seed, device)
    wmod.load(torch, gen.core, weights)

    rng = np.random.default_rng(subseed(seed, "data"))
    S, G, n = d["max_seq_length"], d["gallery_size"], traffic["pool"]
    gallery = data.layouts(G, S, d["num_labels"], rng)
    feats = gen.precompute_retrieved_feats(gallery)
    own = data.layouts(n, S, d["num_labels"], rng)
    nbrs = data.neighbours(n, G, K, rng)
    images = data.canvases(torch, n, d["image_h"], d["image_w"], seed, device)
    B = traffic["batch"]
    batches = []
    for s in range(0, n - B + 1, B):
        idx = np.arange(s, s + B)
        retrieved = data.take(gallery, nbrs[idx])
        retrieved["feats"] = feats[nbrs[idx]]
        batches.append({"layout": Layout.fromdict(data.take(own, idx)), "image": images[s : s + B],
                        "id": idx, "indices": idx, "retrieved": retrieved})
    return Program(config, traffic, device, gen, tok, traffic["task"],
                   SamplingConfig(**config["sampling"]), SamplingConfig(name="deterministic"), {},
                   batches, weights, gallery, nbrs, images)


def timed_methods(prog: Program) -> list:
    return [(prog.gen, "encode_memory", "encode"), (prog.gen, "decode", "decode")]


def recorded_launches(prog: Program):
    return launches.recorded(("K1", "K2"))


def flops_per_layout(config: dict) -> dict:
    v = vocab(config)
    return flops.ralf_layout({**config, "const_len": len(v.uncond_constraint()),
                              "vocab_size": v.V})


def reference_logits(torch, config: dict, prog: Program, chosen: list, low: str | None = None):
    """Per chosen row: (reference logits [L, V] in float32, served tokens [L]);
    with `low` the reference's matrix products take operands of that type."""
    v, W = vocab(config), Weights(prog.weights, low=low)
    B = prog.traffic["batch"]
    out = []
    for s in range(0, len(chosen), CHECK_BLOCK):
        block = chosen[s : s + CHECK_BLOCK]
        idx = np.array([r.batch * B + i for r, i in block])
        retrieved = data.take(prog.gallery, prog.nbrs[idx])
        tokens = torch.as_tensor(np.stack([r.tokens[i] for r, i in block]), device=prog.device)
        with torch.no_grad():
            mem = ref.memory(W, config, prog.images[idx], retrieved, v.uncond_constraint(),
                             prog.device)
            logits = ref.decoder_logits(W, config, mem, tokens, v)
        out += list(zip(logits.float().cpu(), tokens.cpu()))
    return out


def check(torch, prog: Program, records: list, seed: int) -> tuple[dict, dict]:
    """(figures printed beside the comparison, the numbers compared, each
    {'value', 'limit'}: correct when every value is at most its limit)."""
    serve.release(torch, prog)
    config, rows = prog.config, prog.traffic["check_rows"]
    v = vocab(config)
    illegal = serve.illegal_tokens(records, v.token_mask().numpy())
    chosen = serve.sample_rows(records, rows, seed)
    gaps, mismatch = None, 0
    if chosen:
        pairs = reference_logits(torch, config, prog, chosen)
        gaps = torch.stack([ref.token_gaps(lg[None], t[None], v)[0] for lg, t in pairs])
        mismatch = serve.layout_mismatches(chosen, [v.decode(t[None].numpy()) for _, t in pairs])
    return serve.gap_checks(gaps, config["limits"], illegal, mismatch,
                            rows - len(chosen))


def control_check(torch, prog: Program, records: list, seed: int,
                  low: str) -> tuple[dict, dict]:
    """`check` with the reference in `low` precision put in the program's
    place: at each position of the sampled rows (the same prompts and
    served tokens) it serves the legal token that it puts first, and the
    cell's own comparison judges those picks against the float32 reference.
    The control's layouts are the reference's own decoding of its picks, so
    `layout_mismatch` reads 0 by construction; `illegal_tokens` counts its
    picks against the token mask."""
    v, rows = vocab(prog.config), prog.traffic["check_rows"]
    chosen = serve.sample_rows(records, rows, seed)
    exact = reference_logits(torch, prog.config, prog, chosen)
    rounded = reference_logits(torch, prog.config, prog, chosen, low)
    picks = torch.stack([ref.masked(lo[None], v).argmax(-1)[0] for lo, _ in rounded])
    gaps = torch.stack([ref.token_gaps(lg[None], p[None], v)[0]
                        for (lg, _), p in zip(exact, picks)])
    illegal = serve.illegal_in(picks.numpy(), v.token_mask().numpy())
    return serve.gap_checks(gaps, prog.config["limits"], illegal, 0, rows - len(chosen))
