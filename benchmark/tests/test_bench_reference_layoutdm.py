"""The plain LayoutDM reference agrees with the port in float32 at a tiny
size: the image memory, the decoder's logits at a partly masked state, one
reverse step's posterior, the transition tables and the k-means fit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.families import layoutdm as fam
from benchmark.lib import data, serve, weights
from benchmark.references import blocks, layoutdm as ref
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 91


@pytest.fixture(scope="module")
def setup():
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.diffusion import LayoutDMGenerator

    torch.manual_seed(0)
    cfg = tiny_cell("layoutdm-cgl", "uncond-b1024").config
    d = cfg["dataset"]
    rng = np.random.default_rng(0)
    gallery = data.layouts(200, d["max_seq_length"], d["num_labels"], rng)
    centers = {k: ref.fit_kmeans_1d(gallery[k][gallery["mask"]], cfg["tokenizer"]["num_bin"])
               for k in ref.GEO_KEYS}
    tok = serve.tokenizer(cfg, centers)
    gen = LayoutDMGenerator(tok, GeneratorConfig(**cfg["model"], dtype="float32"),
                            num_timesteps=cfg["num_timesteps"], q_type="constrained",
                            pos_emb="elem_attr", image_hw=(d["image_h"], d["image_w"]),
                            device="cpu")
    w = weights.seeded_weights(torch, gen.core, SEED, "cpu")
    weights.load(torch, gen.core, w)
    image = rng.integers(0, 256, (3, d["image_h"], d["image_w"], 4), dtype=np.uint8)
    return cfg, tok, gen, w, image, centers


def test_memory_logits_and_posterior_match_the_port(setup):
    from ralf_tpu_torch.models.diffusion import index_to_log_onehot

    cfg, tok, gen, w, image, _ = setup
    v = fam.vocab(cfg)
    assert v.V == tok.N_total and v.mask == tok.name_to_id("mask") and v.pad == tok.pad_id
    tb = ref.Tables(v, cfg["num_timesteps"], "cpu")
    W = blocks.Weights(w)
    rng = np.random.default_rng(3)
    allowed = tb.ind.numpy() == 0.0
    x = torch.from_numpy(np.stack([[rng.choice(np.nonzero(a)[0]) for a in allowed]
                                   for _ in range(image.shape[0])]))
    x[:, ::3] = v.mask  # a partly masked state
    with torch.no_grad():
        want_mem = gen.core.encode_memory(torch.from_numpy(image))
        got_mem = ref.memory(W, cfg, image, "cpu")
        torch.testing.assert_close(got_mem, want_mem, rtol=1e-4, atol=1e-4)
        for t in (49, 20, 1, 0):
            tt = torch.full((image.shape[0],), t)
            want = gen.core.decoder(x, want_mem, tt)
            got = ref.decoder_logits(W, cfg, got_mem, x, t)
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
            diff = gen.diffusion
            want_lp = diff.q_posterior(diff.predict_start(want), index_to_log_onehot(x, v.V), t)
            got_lp = ref.posterior(tb, ref.predict_start(tb, want), x, t, v.V)
            torch.testing.assert_close(got_lp, want_lp, rtol=1e-5, atol=1e-4)


def test_transition_tables_match_the_ports(setup):
    cfg, tok, gen, *_ = setup
    tb = ref.Tables(fam.vocab(cfg), cfg["num_timesteps"], "cpu")
    theirs = gen.diffusion.tables
    for mine, name in ((tb.at, "log_at"), (tb.bt, "log_bt"), (tb.ct, "log_ct"),
                       (tb.one_ct, "log_1_min_ct"), (tb.att, "log_cum_at"),
                       (tb.btt, "log_cum_bt"), (tb.ctt, "log_cum_ct"),
                       (tb.one_ctt, "log_1_min_cum_ct"), (tb.ind, "log_ind")):
        torch.testing.assert_close(mine, getattr(theirs, name), rtol=1e-6, atol=1e-5)


def test_decode_matches_the_tokenizer(setup):
    cfg, tok, _, _, _, centers = setup
    v = fam.vocab(cfg)
    tokens = np.random.default_rng(4).integers(0, v.V, (32, 5 * v.S))
    want = tok.decode(torch.from_numpy(tokens)).numpy()
    got = v.decode(tokens, centers)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_kmeans_fit_matches_the_ports_lloyd_fit():
    from ralf_tpu_torch.core.bucketizer import fit_kmeans_1d

    values = np.random.default_rng(5).beta(2, 5, 3000)
    np.testing.assert_allclose(ref.fit_kmeans_1d(values, 16), fit_kmeans_1d(values, 16),
                               atol=1e-4)
