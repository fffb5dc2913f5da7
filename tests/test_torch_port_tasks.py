"""Constrained generation in the port against the JAX package: the six
conditional tasks, relations and violations, the sampling filters, the
per-layer cross K/V decode step, the plain autoreg family, RALF under every
task and the relation decode with retries.

Conditions are drawn from numpy generators with the same seed on both sides
and must be identical.  Models are tiny (d_model 32, 4 heads, 1+1 layers,
resnet18, 64x48 canvases), initialised in JAX and loaded into the port
through the weights bridge; both run on the CPU in float32, where the
port's kernel wrappers run their plain versions.  Decodes are compared by
their greedy tokens (jax.random cannot be reproduced in torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.core import conditioning as jcond
from ralf_tpu.core import relationships as jrel
from ralf_tpu.core import sampling as jsamp
from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.core.tokenizer import LayoutSequenceTokenizer as JTokenizer
from ralf_tpu.core.tokenizer import TokenizerConfig as JTokCfg
from ralf_tpu.eval import violations as jviol
from ralf_tpu.models import nn as jnn
from ralf_tpu.models.autoreg import AutoregGenerator as JAutoreg
from ralf_tpu.models.base import GeneratorConfig as JCfg
from ralf_tpu.models.ralf import RALFGenerator as JRALF
from ralf_tpu.ops import relation_decode as jrd
from ralf_tpu_torch.core import conditioning as tcond
from ralf_tpu_torch.core import relationships as trel
from ralf_tpu_torch.core import sampling as tsamp
from ralf_tpu_torch.core.layout import Layout as TLayout
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer as TTokenizer
from ralf_tpu_torch.core.tokenizer import TokenizerConfig as TTokCfg
from ralf_tpu_torch.eval import violations as tviol
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.models.autoreg import AutoregGenerator as TAutoreg
from ralf_tpu_torch.models.base import GeneratorConfig as TCfg
from ralf_tpu_torch.models.ralf import RALFGenerator as TRALF
from ralf_tpu_torch.ops import relation_decode as trd
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
S, HW, B = 10, (64, 48), 3
TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, backbone="resnet18")
TASKS = ("uncond", "c", "cwh", "partial", "refinement", "relation", "gt")
MEM_TOL = 1e-3  # encode_memory: resnet18 + the transformer stacks in fp32
GREEDY = (jsamp.SamplingConfig(name="deterministic"), tsamp.SamplingConfig(name="deterministic"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokenizers():
    return (JTokenizer(JTokCfg(num_labels=3, max_seq_length=S, num_bin=16)),
            TTokenizer(TTokCfg(num_labels=3, max_seq_length=S, num_bin=16)))


def _layout(seed, n_rows=4):
    """Random layouts with 0..S elements (row 0 full, row 1 empty)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, S + 1, size=n_rows)
    n[0], n[1] = S, 0
    mask = np.arange(S)[None, :] < n[:, None]

    def geo(lo, hi):
        return np.where(mask, rng.uniform(lo, hi, (n_rows, S)), 0).astype(np.float32)

    d = {"label": np.where(mask, rng.integers(0, 3, (n_rows, S)), 0), "center_x": geo(0.1, 0.9),
         "center_y": geo(0.1, 0.9), "width": geo(0.05, 0.5), "height": geo(0.05, 0.3), "mask": mask}
    return JLayout.fromdict({k: jnp.asarray(v) for k, v in d.items()}), TLayout.fromdict(d)


def _clauses(rels):
    """Clause lists with each package's relation enum replaced by (kind, value)."""
    return [[(la, ea, type(r).__name__, int(r), lb, eb) for la, ea, r, lb, eb in row]
            for row in rels]


# ---- conditions ---------------------------------------------------------------


@pytest.mark.parametrize("task", jcond.COND_TYPES)
def test_conditions_match_jax(task):
    """get_condition, build_constraint_sequence and build_forced_tokens draw
    from the numpy rng in the same order: identical outputs."""
    jt, tt = _tokenizers()
    jlay, tlay = _layout(1)
    img = np.zeros((4, 8, 8, 4), np.float32)
    jv, tv = jcond.ConstraintVocabulary(jt), tcond.ConstraintVocabulary(tt)
    assert jv.N_total == tv.N_total and jv.const_len(task) == tv.const_len(task)
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    jc, jtarget = jcond.get_condition(jlay, img, task, jt, jr, ids=np.arange(4))
    tc, ttarget = tcond.get_condition(tlay, img, task, tt, tr, ids=np.arange(4))
    js, jm = jcond.build_constraint_sequence(jc, jv, jr)
    ts, tm = tcond.build_constraint_sequence(tc, tv, tr)
    assert tc.task == jc.task
    for name, t, j in (("seq", tc.seq, jc.seq), ("seq_mask", tc.seq_mask, jc.seq_mask),
                       ("const_seq", ts, js), ("const_mask", tm, jm),
                       ("forced", tcond.build_forced_tokens(tc, tt),
                        jcond.build_forced_tokens(jc, jt))):
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_array_equal(t, np.asarray(j), err_msg=name)
    for k, a in ttarget.numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jtarget, k)), err_msg=k)
    if task == "relation":
        for k in ("edge_indexes", "edge_attributes"):
            np.testing.assert_array_equal(tc.edges[k], jc.edges[k])
        assert _clauses(tc.relations) == _clauses(jc.relations)
        assert _clauses(tc.sampled_relations) == _clauses(jc.sampled_relations)
    assert jr.random() == tr.random()  # the same number of draws


def test_unknown_task_raises():
    jt, tt = _tokenizers()
    with pytest.raises(ValueError, match="unknown task"):
        tcond.get_condition(_layout(1)[1], np.zeros((4, 8, 8, 4)), "layout", tt,
                            np.random.default_rng(0))


# ---- relations and violations ------------------------------------------------


def test_relations_and_violations_match_jax():
    jt, tt = _tokenizers()
    jlay, tlay = _layout(2, n_rows=6)
    for ratio in (0.1, 1.0):
        j = jrel.compute_relation(jlay, np.random.default_rng(3), ratio)
        t = trel.compute_relation(tlay, np.random.default_rng(3), ratio)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert _clauses(trel.describe_relationships(tlay)) == \
        _clauses(jrel.describe_relationships(jlay))

    img = np.zeros((6, 8, 8, 4), np.float32)
    jc, _ = jcond.get_condition(jlay, img, "relation", jt, np.random.default_rng(4))
    tc, _ = tcond.get_condition(tlay, img, "relation", tt, np.random.default_rng(4))
    # every clause conditioned on, so that each detector and anchor is exercised
    jc.sampled_relations, tc.sampled_relations = jc.relations, tc.relations
    jten, tten = jrd.build_relation_tensors(jc, S), trd.build_relation_tensors(tc, S)
    for k in jten:
        np.testing.assert_array_equal(tten[k].numpy(), np.asarray(jten[k]), err_msg=k)

    rng = np.random.default_rng(5)
    geo = {k: rng.uniform(0.05, 0.95, (6, S)).astype(np.float32) for k in ("cx", "cy", "w", "h")}
    for e in range(S):
        idx = np.full(6, e)
        j = jrd.count_violations({k: jnp.asarray(v) for k, v in geo.items()}, jnp.asarray(idx), jten)
        t = trd.count_violations({k: torch.from_numpy(v) for k, v in geo.items()},
                                 torch.from_numpy(idx), tten)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    gen = rng.integers(0, jt.N_total, (6, jt.max_token_length))
    jgl, tgl = jt.decode(jnp.asarray(gen)), tt.decode(torch.from_numpy(gen))
    assert tviol.calculate_relation_violation(tc, tgl) == \
        jviol.calculate_relation_violation(jc, jgl)
    for task in TASKS:
        jc, _ = jcond.get_condition(jlay, img, task, jt, np.random.default_rng(6))
        tc, _ = tcond.get_condition(tlay, img, task, tt, np.random.default_rng(6))
        seq = np.where(rng.random(gen.shape) < 0.5, jc.seq[:, 1:], gen) if jc.seq is not None \
            else gen
        assert tviol.calculate_violation(tc, torch.from_numpy(seq), tgl, tt) == \
            jviol.calculate_violation(jc, seq, jgl, jt), task


# ---- sampling ------------------------------------------------------------------


def _logits(seed=8):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(32, 40)).astype(np.float32) * 2
    logits[:4, 3] = logits[:4, 7] = logits[:4].max(axis=1) + 0.5  # tied maxima
    return logits


@pytest.mark.parametrize("k", [1, 3, 7])
def test_top_k_kept_set_matches_jax(k):
    logits = _logits()
    ref = np.asarray(jsamp.top_k_filter(jnp.asarray(logits), k)) > jsamp.NEG_INF
    np.testing.assert_array_equal(
        tsamp.top_k_filter(torch.from_numpy(logits), k).numpy() > tsamp.NEG_INF, ref)


@pytest.mark.parametrize("p", [0.3, 0.6, 0.9])  # at 1.0 the f32 cumsum decides the tail
def test_sort_top_p_kept_set_matches_jax(p):
    logits = _logits()
    ref = np.asarray(jsamp.top_p_filter(jnp.asarray(logits), p)) > jsamp.NEG_INF
    np.testing.assert_array_equal(
        tsamp.top_p_filter(torch.from_numpy(logits), p).numpy() > tsamp.NEG_INF, ref)


def test_prefiltered_gumbel_and_temperature_draws_stay_in_the_jax_support():
    """The prefiltered nucleus draws only from the JAX formulation's kept set
    (the top-k slice's sorted nucleus) and reaches all of it; gumbel and
    top_k never draw a masked logit; a temperature override equals the
    config's temperature under the same generator."""
    logits = torch.from_numpy(_logits())[4:12]  # no ties: top-k orders ties differently
    cfg = tsamp.SamplingConfig(name="top_p", top_p=0.7, top_p_prefilter=6, temperature=0.8)
    vals, idx = jax.lax.top_k(jnp.asarray(logits.numpy()) / 0.8, 6)
    cum = np.cumsum(np.asarray(jax.nn.softmax(vals, axis=-1)), axis=-1)
    keep = (cum <= 0.7) | (np.arange(6) == 0)
    draws = tsamp.sample(logits.repeat(500, 1), cfg, torch.Generator().manual_seed(0))
    draws = draws.reshape(500, 8).numpy()
    for r in range(8):
        assert set(draws[:, r]) == set(np.asarray(idx)[r][keep[r]])
    masked = logits.clone()
    masked[:, ::2] = tsamp.NEG_INF
    for name in ("gumbel", "top_k"):
        d = tsamp.sample(masked.repeat(200, 1), tsamp.SamplingConfig(name=name, top_k=3),
                         torch.Generator().manual_seed(1))
        assert bool((d % 2 == 1).all()), name
    a = tsamp.sample(logits, tsamp.SamplingConfig(name="random"), torch.Generator().manual_seed(2),
                     temperature=1.5)
    b = tsamp.sample(logits, tsamp.SamplingConfig(name="random", temperature=1.5),
                     torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


# ---- the per-layer cross K/V decode step (K7, K8) ----------------------------


@pytest.mark.parametrize("kv_quant", [False, True])
def test_per_layer_step_matches_jax(kv_quant):
    """TokenDecoder steps over cross_kv(shared=False) against JAX; without
    quantisation the per-layer path is the shared path's function too."""
    D, H, V, T, M = 32, 4, 20, 6, 7
    rng = np.random.default_rng(9)
    seq = rng.integers(0, V, (B, T))
    memory = rng.normal(size=(B, M, D)).astype(np.float32)
    jd = jnn.TokenDecoder(V, D, H, 2, 64, dropout=0.0)
    v = jd.init(jax.random.PRNGKey(10), jnp.asarray(seq), jnp.asarray(memory))
    td = tnn.TokenDecoder(V, D, H, 2, 64).eval().requires_grad_(False)
    load_jax_params(td, _np(v["params"]))
    JD = jnn.TokenDecoder
    jcache = jd.apply(v, B, T, method=JD.init_cache)
    jcross = jd.apply(v, jnp.asarray(memory), kv_quant, False, method=JD.cross_kv)
    tcross = td.stack.cross_kv(torch.from_numpy(memory), kv_quant, shared=False)
    assert isinstance(tcross, list) and len(tcross) == 2
    for tl, jl in zip(tcross, jcross):
        assert len(tl) == len(jl) == (4 if kv_quant else 2)
        for ta, ja in zip(tl, jl):  # projections to 1e-5, the quantised caches exactly
            np.testing.assert_allclose(ta.float().numpy(), np.asarray(ja, np.float32),
                                       atol=0 if kv_quant and ta.dtype == torch.int8 else 1e-5,
                                       rtol=1e-5)
    tcache, tshared = td.stack.init_cache(B, T), td.stack.init_cache(B, T)
    with torch.inference_mode():
        for t in range(T):
            keep = np.broadcast_to(np.arange(T) <= t, (B, T))
            jx = jd.apply(v, jnp.asarray(seq[:, t]), jnp.int32(t), method=JD.embed_step)
            jx, jcache = jd.apply(v, jx, jnp.int32(t), jcache, jcross, jnp.asarray(keep), None,
                                  method=JD.step)
            jl = np.asarray(jd.apply(v, jx, method=JD.head))[:, 0]
            tx = td.embed_step(torch.from_numpy(seq[:, t]), t)
            tl = td.head(td.stack.step(tx, t, tcache, tcross, torch.from_numpy(keep), None))[:, 0]
            np.testing.assert_allclose(tl.numpy(), jl, atol=2e-4, rtol=1e-4)
            if not kv_quant:
                sx = td.stack.step(td.embed_step(torch.from_numpy(seq[:, t]), t), t, tshared,
                                   td.stack.cross_kv(torch.from_numpy(memory)),
                                   torch.from_numpy(keep), None)
                np.testing.assert_allclose(td.head(sx)[:, 0].numpy(), tl.numpy(), atol=1e-5)


# ---- the generators ----------------------------------------------------------


def _stats(v, seed=0):
    rng = np.random.default_rng(seed)  # non-trivial BatchNorm statistics
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        _np(v["batch_stats"]))


def _bridge(jgen, tgen):
    v = jgen.init(jax.random.PRNGKey(0))
    stats = _stats(v)
    load_jax_params(tgen.core, _np(v["params"]), stats)
    return {"params": v["params"], "batch_stats": jax.tree.map(jnp.asarray, stats)}


def _batches(seed=11):
    jlay, tlay = _layout(seed, n_rows=B)
    img = np.random.default_rng(seed).random((B, *HW, 4)).astype(np.float32)
    return {"layout": jlay, "image": img}, {"layout": tlay, "image": img}


@pytest.fixture(scope="module")
def autoreg():
    jt, tt = _tokenizers()
    jg = JAutoreg(jt, JCfg(**TINY), "multitask", image_hw=HW)
    tg = TAutoreg(tt, TCfg(**TINY), "multitask", image_hw=HW, device="cpu")
    return jg, _bridge(jg, tg), tg


def test_autoreg_core_matches_jax(autoreg):
    """The plain autoreg family: the multitask draw, the condition,
    encode_memory and the greedy tokens."""
    jg, v, tg = autoreg
    jb, tb = _batches()
    jr, tr = np.random.default_rng(12), np.random.default_rng(12)
    tasks = []
    for _ in range(3):
        jc, _ = jg.build_condition(jb, jr)
        tc, _ = tg.build_condition(tb, tr)
        assert tc.task == jc.task
        np.testing.assert_array_equal(tc.const_seq, jc.const_seq)
        tasks.append(tc.task)
    assert len(set(tasks)) > 1
    jc, _ = jg.build_condition(jb, jr, task="cwh")
    tc, _ = tg.build_condition(tb, tr, task="cwh")
    jmem, tmem = np.asarray(jg.encode_memory(v, jc)), tg.encode_memory(tc)
    assert tmem.shape == jmem.shape == (B, 12 + tg.vocab.const_len("cwh"), 32)
    np.testing.assert_allclose(tmem.numpy(), jmem, atol=MEM_TOL, rtol=MEM_TOL)
    _, jseq = jg.sample(v, jc, GREEDY[0], jax.random.PRNGKey(0), return_tokens=True)
    _, tseq = tg.sample(tc, GREEDY[1], return_tokens=True)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))


@pytest.fixture(scope="module")
def ralf():
    jt, tt = _tokenizers()
    jg = JRALF(jt, JCfg(**TINY), "uncond", image_hw=HW, top_k=4)
    tg = TRALF(tt, TCfg(**TINY), "uncond", image_hw=HW, top_k=4, device="cpu")
    v = _bridge(jg, tg)
    rng = np.random.default_rng(13)
    retrieved = {k: (rng.integers(0, 3, (B, 4, S)) if k == "label" else
                     rng.random((B, 4, S)) > 0.3 if k == "mask" else
                     rng.random((B, 4, S)).astype(np.float32))
                 for k in ("label", "center_x", "center_y", "width", "height", "mask")}
    retrieved["feats"] = rng.normal(size=(B, 4, 256)).astype(np.float32)
    jb, tb = _batches(14)
    jb["retrieved"] = tb["retrieved"] = retrieved
    return jg, v, tg, jb, tb


def _ralf_conditions(ralf, task):
    jg, v, tg, jb, tb = ralf
    jc, _ = jg.build_condition(jb, np.random.default_rng(15), task=task)
    tc, _ = tg.build_condition(tb, np.random.default_rng(15), task=task)
    return jc, tc


@pytest.mark.parametrize("task", TASKS)
def test_ralf_greedy_tokens_match_jax_for_every_task(ralf, task):
    """Every task through the plain decode (the memory length follows the
    task's constraint length): equal greedy tokens, the forced tokens in
    place."""
    jg, v, tg, jb, tb = ralf
    jc, tc = _ralf_conditions(ralf, task)
    _, jseq = jg.sample(v, jc, GREEDY[0], jax.random.PRNGKey(0), return_tokens=True,
                        use_backtrack=False)
    _, tseq = tg.sample(tc, GREEDY[1], return_tokens=True, use_backtrack=False)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    forced = tcond.build_forced_tokens(tc, tg.tokenizer)
    assert (tseq.numpy()[forced >= 0] == forced[forced >= 0]).all()


@pytest.mark.parametrize("max_retries", [0, 2])
def test_relation_decode_matches_jax(ralf, max_retries):
    """relation_aware_decode, which runs every attempt from a copy of the
    element's KV snapshot: equal greedy tokens (all zeros without attempts)."""
    jg, v, tg, jb, tb = ralf
    jc, tc = _ralf_conditions(ralf, "relation")
    _, jseq = jg.sample(v, jc, GREEDY[0], jax.random.PRNGKey(0), return_tokens=True,
                        max_retries=max_retries)
    _, tseq = tg.sample(tc, GREEDY[1], return_tokens=True, max_retries=max_retries)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    assert bool((tseq == 0).all()) == (max_retries == 0)


def test_q8_mxu_decode_agrees_with_kv_quant_decode(ralf):
    """The int8-contraction decode (K4's plain version) has no JAX CPU
    counterpart; it is held to the port's own kv_quant decode: at least 0.9
    of the greedy tokens agree (the JAX package holds its int8 self-cache
    decode to 0.7 in tests/test_nn.py).  q8_mxu alone changes nothing."""
    jg, v, tg, jb, tb = ralf
    _, tc = _ralf_conditions(ralf, "c")
    mem = tg.encode_memory(tc)
    forced = tcond.build_forced_tokens(tc, tg.tokenizer)
    ref = tg.decode(mem, forced, GREEDY[1], kv_quant=True, self_quant=True)
    mxu = tg.decode(mem, forced, GREEDY[1], kv_quant=True, self_quant=True, q8_mxu=True)
    assert float((mxu == ref).float().mean()) >= 0.9
    assert torch.equal(tg.decode(mem, forced, GREEDY[1], q8_mxu=True),
                       tg.decode(mem, forced, GREEDY[1]))
