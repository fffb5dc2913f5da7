"""The port's RALF sample path as a whole against the JAX package, and the
port's plumbing.

A tiny RALF (d_model 32, 4 heads, 1+1 layers, resnet18, top-4 retrieval)
is initialised in JAX and loaded into the port through the weights bridge.
Both packages then run the same path on the CPU in float32: synthetic
gallery -> saliency retrieval -> frozen-FIDNet gallery table -> loader ->
condition -> encode_memory -> KV-cached greedy decode -> Layout.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.core.sampling import SamplingConfig as JSampling
from ralf_tpu.core.tokenizer import LayoutSequenceTokenizer as JTokenizer
from ralf_tpu.core.tokenizer import TokenizerConfig as JTokCfg
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models.base import GeneratorConfig as JCfg
from ralf_tpu.models.ralf import RALFGenerator as JRALF
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu.retrieval import wrapper as jwrap
from ralf_tpu_torch.core.conditioning import build_forced_tokens
from ralf_tpu_torch.core.sampling import SamplingConfig as TSampling
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer as TTokenizer
from ralf_tpu_torch.core.tokenizer import TokenizerConfig as TTokCfg
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models.base import GeneratorConfig as TCfg
from ralf_tpu_torch.models.ralf import RALFGenerator as TRALF
from ralf_tpu_torch.retrieval import retriever as tret
from ralf_tpu_torch.retrieval import wrapper as twrap
from ralf_tpu_torch.utils.device import resolve_device
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, backbone="resnet18")
TOP_K = 4
MEM_TOL = 1e-3  # encode_memory: resnet18 + 3 transformer stacks in fp32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """(JAX tokenizer, port tokenizer, JAX generator, its variables, port generator)."""
    jt = JTokenizer(JTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    tt = TTokenizer(TTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    jg = JRALF(jt, JCfg(**TINY), "uncond", image_hw=(64, 48), top_k=TOP_K)
    v = jg.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)  # non-trivial BatchNorm statistics
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        _np(v["batch_stats"]))
    v = {"params": v["params"], "batch_stats": jax.tree.map(jnp.asarray, stats)}
    tg = TRALF(tt, TCfg(**TINY), "uncond", image_hw=(64, 48), top_k=TOP_K, device="cpu")
    load_jax_params(tg.core, _np(v["params"]), stats)
    return jt, tt, jg, v, tg


def _pipeline(models, hw, batch, n_query, n_gallery=24):
    """The same retrieval-augmented batches built by both packages, and each
    package's frozen-FIDNet gallery table."""
    jt, tt, jg, v, tg = models
    cfg = dict(name="synthetic")
    out = {}
    for name, data, ret, wrap, feats_of in (
        ("jax", jdata, jret, jwrap, lambda lay: jg.precompute_retrieved_feats(v, lay)),
        ("port", tdata, tret, twrap, tg.precompute_retrieved_feats),
    ):
        gallery = data.SyntheticPosterDataset(data.DatasetConfig(**cfg), n_gallery, 1, hw)
        queries = data.SyntheticPosterDataset(data.DatasetConfig(**cfg), n_query, 2, hw)
        if name == "jax":
            retriever = ret.Retriever.build(gallery)
            loader = data.BatchLoader(queries, batch, shuffle=False, use_native=False, prefetch=0)
        else:
            retriever = ret.Retriever.build(gallery, device="cpu")
            loader = data.BatchLoader(queries, batch, shuffle=False)
        feats = feats_of(retriever.layouts)
        out[name] = (feats, list(wrap.RetrievalAugmentedLoader(loader, retriever, TOP_K,
                                                               feats_table=feats)))
    return out


@pytest.fixture(scope="module")
def small_canvas(models):
    """64x48 canvases: the batch, the conditions and the memories of both packages."""
    jt, tt, jg, v, tg = models
    pipe = _pipeline(models, (64, 48), batch=3, n_query=3)
    jfeats, jbatches = pipe["jax"]
    tfeats, tbatches = pipe["port"]
    jc, _ = jg.build_condition(jbatches[0], np.random.default_rng(0))
    tc, _ = tg.build_condition(tbatches[0], np.random.default_rng(0))
    return dict(jfeats=jfeats, tfeats=tfeats, jcond=jc, tcond=tc,
                jmem=np.asarray(jg.encode_memory(v, jc)), tmem=tg.encode_memory(tc))


def test_gallery_feature_table_matches_jax(small_canvas):
    assert small_canvas["tfeats"].shape == (24, 256)
    np.testing.assert_allclose(small_canvas["tfeats"], small_canvas["jfeats"], atol=1e-4, rtol=1e-4)


def test_encode_memory_matches_jax(models, small_canvas):
    jmem, tmem = small_canvas["jmem"], small_canvas["tmem"]
    assert tmem.shape == jmem.shape == (3, 2 * 12 + TOP_K + 4, 32)  # [memory, CA, ref, const]
    np.testing.assert_allclose(tmem.numpy(), jmem, atol=MEM_TOL, rtol=MEM_TOL)
    # without the gallery table the port runs FIDNet on the K retrieved layouts itself
    tcond = small_canvas["tcond"]
    no_table = {k: a for k, a in tcond.retrieved.items() if k != "feats"}
    tmem2 = models[4].encode_memory(dataclasses.replace(tcond, retrieved=no_table))
    np.testing.assert_allclose(tmem2.numpy(), tmem.numpy(), atol=1e-4, rtol=1e-4)


def _greedy_pair(models, jcond, tcond, jmem, tmem, kv_quant, self_quant):
    jt, tt, jg, v, tg = models
    forced = build_forced_tokens(tcond, tt)
    jtok = np.asarray(jg.decode(v, jnp.asarray(jmem), forced, JSampling(name="deterministic"),
                                jax.random.PRNGKey(0), kv_quant=kv_quant, self_quant=self_quant))
    ttok = tg.decode(tmem, forced, TSampling(name="deterministic"), kv_quant=kv_quant,
                     self_quant=self_quant)
    return jtok, ttok


@pytest.mark.parametrize("kv_quant,self_quant", [(False, False), (True, True)])
def test_greedy_decode_matches_jax(models, small_canvas, kv_quant, self_quant):
    """Each package decodes its own memory: the tokens and the decoded
    layouts must be equal."""
    jt, tt = models[:2]
    s = small_canvas
    jtok, ttok = _greedy_pair(models, s["jcond"], s["tcond"], s["jmem"], s["tmem"],
                              kv_quant, self_quant)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    jl, tl = jt.decode(jnp.asarray(jtok)), tt.decode(ttok)
    for k, a in tl.numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jl, k)), err_msg=k)


def test_full_canvas_350x240_matches_jax(models):
    """One 350x240 canvas: the mini-FPN's 11x8 -> 22x15 nearest upsample
    (not an integer factor in width) and the 330-token image memory."""
    jt, tt, jg, v, tg = models
    pipe = _pipeline(models, (350, 240), batch=1, n_query=1, n_gallery=8)
    jc, _ = jg.build_condition(pipe["jax"][1][0], np.random.default_rng(0))
    tc, _ = tg.build_condition(pipe["port"][1][0], np.random.default_rng(0))
    jmem, tmem = np.asarray(jg.encode_memory(v, jc)), tg.encode_memory(tc)
    assert tmem.shape == (1, 2 * 330 + TOP_K + 4, 32)
    np.testing.assert_allclose(tmem.numpy(), jmem, atol=MEM_TOL, rtol=MEM_TOL)
    for kvq, sq in ((False, False), (True, True)):
        jtok, ttok = _greedy_pair(models, jc, tc, jmem, tmem, kvq, sq)
        np.testing.assert_array_equal(ttok.numpy(), jtok)


def test_sample_gives_legal_reproducible_layouts(models, small_canvas):
    tt, tg = models[1], models[4]
    cfg = TSampling(name="top_p", top_p=0.9)

    def run(seed):
        layout, toks = tg.sample(small_canvas["tcond"], cfg, torch.Generator().manual_seed(seed),
                                 return_tokens=True, kv_quant=True, self_quant=True)
        return layout, toks

    layout, toks = run(0)
    L = tt.max_token_length
    assert toks.shape == (3, L)
    assert bool(tg.token_mask[torch.arange(L)[None, :], toks].all())
    assert layout.label.shape == (3, 10) and bool(torch.isfinite(layout.width).all())
    assert torch.equal(run(0)[1], toks)
    assert not torch.equal(run(1)[1], toks)


# ---- plumbing ---------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ralf_tpu", "native")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "ralf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(REPO / "ralf_tpu_torch")) for f in files[:-1]}
    assert names >= {"config.py", "cache.py", "cli/inference.py", "cli/evaluate.py",
                     "data/native.py", "data/dataset.py", "eval/metrics.py",
                     "eval/visualizer.py", "eval/export_tex.py", "train/trainer.py",
                     "core/mask.py", "core/seq_length.py", "models/maskgit.py",
                     "models/diffusion.py", "models/retrieval_augment.py",
                     "ops/relation_costs.py", "models/towers.py", "retrieval/lpips.py",
                     "eval/image_metrics.py", "cli/build_caches.py", "utils/checkpoints.py",
                     "preprocess/readers.py", "preprocess/saliency_models.py",
                     "preprocess/lama.py", "preprocess/inpainting.py", "cli/saliency.py",
                     "cli/build_dataset.py"}
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    # the native collator is the port's own copy, built into the port's build dir
    from ralf_tpu_torch.data import native

    assert native.SRC.parent == REPO / "ralf_tpu_torch" / "data" / "csrc"
    assert native.BUILD_DIR == REPO / "ralf_tpu_torch" / "_build"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = TTokenizer(TTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        TRALF(tok, TCfg(**TINY), "uncond")
    with pytest.raises(RuntimeError, match="CUDA"):
        tret.Retriever(np.ones((2, 4), np.float32), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    # the offline dataset build: inpainting and the saliency CLI's nets
    from ralf_tpu_torch.cli import saliency
    from ralf_tpu_torch.preprocess.inpainting import inpaint

    with pytest.raises(RuntimeError, match="CUDA"):
        inpaint(np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 8, 8), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        saliency.build_net("basnet")
    with pytest.raises(RuntimeError, match="CUDA"):
        saliency.main(["--model", "basnet", "--input-dir", ".", "--output-dir", "unused"])


def test_weights_bridge_checks_every_leaf(models):
    jt, tt, jg, v, tg = models
    params, stats = _np(v["params"]), _np(v["batch_stats"])
    extra = {**params, "decoder": {**params["decoder"], "surplus": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="surplus"):
        load_jax_params(tg.core, extra, stats)
    missing = {k: p for k, p in params.items() if k != "fusion_head"}
    with pytest.raises(KeyError, match="fusion_head"):
        load_jax_params(tg.core, missing, stats)
    wrong = {**params, "flag_emb": np.zeros((3, 1), np.float32)}
    with pytest.raises(ValueError, match="flag_emb"):
        load_jax_params(tg.core, wrong, stats)
    load_jax_params(tg.core, params, stats)  # the model stays whole for the other tests


def test_chip_smoke_refuses_without_the_card_or_the_package(tmp_path):
    """No result line and a non-zero exit without CUDA, and in a directory
    that holds chip_smoke.py and nothing else of the repository."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_chip_smoke_k1_flip_check_takes_only_a_rounding_near_a_midpoint():
    """chip_smoke.py holds K1 in bf16 to the plain version's tolerance, and
    lets an element outside it pass only as one p rounded the other way
    within p's reorder bound of a bf16 midpoint.  Here, on the CPU, such a
    flip passes; a flip of a p far from a midpoint, or a wrong value, does
    not."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    from ralf_tpu_torch.ops import encoder_attention as ea

    B, S, E, H = 64, 11, 256, 4
    Dh = E // H
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, E, generator=g) for _ in range(3))
    q, k, v = (q * Dh**-0.5).bfloat16(), k.bfloat16(), (v * 32).bfloat16()
    ref = ea.encoder_attention_plain(q, k, v, H)
    explain = cs.k1_one_flip(torch, q, k, v, H, None)
    atol, rtol = cs.TOL["bfloat16"]
    qh, kh, vh = (t.double().reshape(B, S, H, Dh) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bshd,bmhd->bhsm", qh, kh), -1)  # exact p
    pb16 = p.to(torch.bfloat16)
    pb = pb16.double()
    up = (pb16.view(torch.int16) + 1).view(torch.bfloat16).double()
    down = (pb16.view(torch.int16) - 1).view(torch.bfloat16).double()
    other = torch.where(p > pb, up, down)
    dist = (p - (pb + other) / 2).abs() / p  # relative distance to the nearer midpoint
    counts = {}
    for name, pick in (("near", dist.argmin()), ("far", dist.argmax())):
        b, h, s, j = np.unravel_index(int(pick), tuple(p.shape))
        pf = pb[b, h, s].clone()
        pf[j] = other[b, h, s, j]
        fake = ref.clone()
        fake[b, s, h * Dh:(h + 1) * Dh] = (pf @ vh[b, :, h]).to(torch.bfloat16)
        outside = (fake.float() - ref.float()).abs() > atol + rtol * ref.float().abs()
        assert outside.any(), name  # |v| ~ 32 carries one flip past the tolerance
        ok, share = explain(fake, outside)
        counts[name] = (int(outside.sum()), int(ok.sum()), share)
    assert counts["near"][1] == counts["near"][0] and 0 < counts["near"][2] <= 1, counts
    assert counts["far"][1] == 0, counts
    wrong = ref.clone()
    wrong[5, 2, 7] += 0.5
    outside = (wrong.float() - ref.float()).abs() > atol + rtol * ref.float().abs()
    assert not explain(wrong, outside)[0].any()
