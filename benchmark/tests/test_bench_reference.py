"""The plain RALF reference agrees with the port in float32 at a tiny size,
before it judges the port on the card.  The test imports both; the
reference module imports neither the port nor JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.families import ralf as fam
from benchmark.lib import data, serve, weights
from benchmark.references import blocks, ralf as ref
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def setup():
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator

    torch.manual_seed(0)
    cell = tiny_cell("ralf-cgl", "uncond-b1024")
    cfg = cell.config
    d = cfg["dataset"]
    tok = serve.tokenizer(cfg)
    gen = RALFGenerator(tok, GeneratorConfig(**cfg["model"], dtype="float32"), "uncond",
                        (d["image_h"], d["image_w"]), top_k=cfg["retrieval"]["top_k"],
                        device="cpu")
    w = weights.seeded_weights(torch, gen.core, SEED, "cpu")
    weights.load(torch, gen.core, w)
    rng = np.random.default_rng(0)
    B, K, S = 3, cfg["retrieval"]["top_k"], d["max_seq_length"]
    gallery = data.layouts(d["gallery_size"], S, d["num_labels"], rng)
    retrieved = data.take(gallery, data.neighbours(B, d["gallery_size"], K, rng))
    image = rng.integers(0, 256, (B, d["image_h"], d["image_w"], 4), dtype=np.uint8)
    return cfg, tok, gen, w, image, retrieved


def test_memory_and_teacher_forced_logits_match_the_port(setup):
    from ralf_tpu_torch.models.ralf import retrieved_tensors

    cfg, tok, gen, w, image, retrieved = setup
    v = fam.vocab(cfg)
    const = torch.tensor([v.uncond_constraint()] * image.shape[0])
    with torch.no_grad():
        want_mem = gen.core.encode_memory(torch.from_numpy(image),
                                          retrieved_tensors(retrieved, "cpu"), const,
                                          torch.ones_like(const, dtype=torch.bool))
        got_mem = ref.memory(blocks.Weights(w), cfg, image, retrieved, v.uncond_constraint(),
                             "cpu")
        torch.testing.assert_close(got_mem, want_mem, rtol=1e-4, atol=1e-4)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, v.V, (image.shape[0], 5 * v.S)))
        tokens[0, 7:] = v.pad  # a fed pad is not attended
        inp = torch.cat([torch.full_like(tokens[:, :1], v.bos), tokens[:, :-1]], 1)
        want = gen.core.decoder(inp, want_mem, tgt_keep=inp != v.pad, causal=True)
        got = ref.decoder_logits(blocks.Weights(w), cfg, got_mem, tokens, v)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cached_greedy_decode_is_the_references_argmax(setup):
    """The port's KV-cached decode (fp32) picks the reference's best legal
    token at every position."""
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.ralf import retrieved_tensors

    cfg, tok, gen, w, image, retrieved = setup
    v = fam.vocab(cfg)
    const = torch.tensor([v.uncond_constraint()] * image.shape[0])
    with torch.no_grad():
        mem = gen.core.encode_memory(torch.from_numpy(image), retrieved_tensors(retrieved, "cpu"),
                                     const, torch.ones_like(const, dtype=torch.bool))
        forced = np.full((image.shape[0], 5 * v.S), -1)
        toks = gen.decode(mem, forced, SamplingConfig(name="deterministic"))
        logits = ref.decoder_logits(blocks.Weights(w), cfg, mem, toks, v)
    assert float(ref.token_gaps(logits, toks, v).max()) < 1e-4


def test_vocabulary_arithmetic_matches_the_tokenizer(setup):
    from ralf_tpu_torch.core.conditioning import (
        Condition,
        ConstraintVocabulary,
        build_constraint_sequence,
    )

    cfg, tok, *_ = setup
    v = fam.vocab(cfg)
    assert v.V == tok.N_total and (v.pad, v.bos, v.eos) == (tok.pad_id, tok.bos_id, tok.eos_id)
    assert np.array_equal(v.token_mask().numpy(), tok.token_mask)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, v.V, (64, 5 * v.S))
    tokens[::3] = np.where(tok.token_mask[np.arange(5 * v.S)][None].any(-1), tokens[::3], 0)
    want = tok.decode(torch.from_numpy(tokens)).numpy()
    got = v.decode(tokens)
    for k in ("label", "mask"):
        assert np.array_equal(got[k], want[k])
    for k in ref.GEO_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    cond = Condition(image=np.zeros((2, 1, 1, 4)), task="uncond")
    seq, keep = build_constraint_sequence(cond, ConstraintVocabulary(tok), rng)
    assert seq.tolist() == [v.uncond_constraint()] * 2 and keep.all()


def test_position_tables_match_the_ports():
    from ralf_tpu_torch.models.positional import sincos_1d, sine_2d_table

    np.testing.assert_allclose(blocks.sincos_1d(50, 256).numpy(), sincos_1d(50, 256), atol=1e-6)
    np.testing.assert_allclose(blocks.sine_2d(22, 15, 256).numpy(), sine_2d_table(22, 15, 256),
                               atol=1e-6)


def test_reference_imports_neither_the_port_nor_jax():
    import ast
    from pathlib import Path

    for path in Path(ref.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "ralf_tpu",
                                               "ralf_tpu_torch"), (path.name, n)
