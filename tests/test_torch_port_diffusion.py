"""LayoutDM, VQDiffusion and RA-LayoutDM in the port against the JAX
package: the schedules and transition tables, the log-space diffusion
math, one reverse step with each of its terms, the relation costs and
their gradient step, the timestep-conditioned decoder (and its
cross-attention K and V projected once a request), the cores with and
without retrieval, deterministic samples under every task, and
`cli.inference` end to end.

Models are tiny (d_model 32, 4 heads, 1+1 layers, resnet18, 64x48
canvases), initialised in JAX and loaded into the port through the
weights bridge; both run on the CPU in float32, where the port's kernel
wrappers (K1 in the image encoder, the decoder's self-attention and
FIDNet) run their plain versions and JAX its einsum paths.  Tables are
exact; logits and log-probabilities agree within 1e-5 absolute + 1e-4
relative; tokens exactly.  Sampling is deterministic (argmax), the only
strategy whose draws both packages share.
"""

import csv
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.core import sampling as jsamp
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import diffusion as jdiff
from ralf_tpu.models import positional as jpos
from ralf_tpu.ops import relation_costs as jrc
from ralf_tpu.parallel.decode import make_decode_mesh
from ralf_tpu.parallel.zoo import DiffusionMeshSampler
from ralf_tpu.train.trainer import Trainer
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.core import sampling as tsamp
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import diffusion as tdiff
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.models import positional as tpos
from ralf_tpu_torch.ops import relation_costs as trc
from ralf_tpu_torch.utils import tracing
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4
HW = (64, 48)
T_STEPS = 12  # the tiny models' timesteps: steps 10 and 11 take the relation update
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}", "debug=true",
        "synthetic_data=true", "sampling.name=deterministic",
        f"generator_kwargs.num_timesteps={T_STEPS}", "generator_kwargs.top_k=4"]
TASKS = ("uncond", "c", "cwh", "partial", "refinement", "relation")
JGREEDY = jsamp.SamplingConfig(name="deterministic")
TGREEDY = tsamp.SamplingConfig(name="deterministic")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def _kmeans_cache(cache_dir, seed=3):
    """Fitted kmeans centers for every geometry key at 128 bins, where both
    packages' `build_tokenizer` read them (the diffusion presets' vocabulary)."""
    from ralf_tpu import cache as jcache
    from ralf_tpu.core.bucketizer import fit_kmeans_1d

    rng = np.random.default_rng(seed)
    os.makedirs(cache_dir, exist_ok=True)
    centers = {f"{k}-128": fit_kmeans_1d(rng.uniform(0, 1, 600), 128, n_iters=5)
               for k in jcache.GEO_KEYS}
    with open(jcache.kmeans_clusters_path(cache_dir, "pku10"), "wb") as f:
        pickle.dump(centers, f)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cache"))
    _kmeans_cache(d)
    return d


def _generators(experiment, cache_dir, extra=()):
    over = TINY + [f"cache_dir={cache_dir}", *extra]
    jcfg, tcfg = jconfig.build_config(experiment, over), tconfig.build_config(experiment, over)
    jg = jconfig.build_generator(jcfg, jconfig.build_tokenizer(jcfg))
    tg = tconfig.build_generator(tcfg, tconfig.build_tokenizer(tcfg), device="cpu")
    v = _np(jg.init(jax.random.PRNGKey(0)))
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    return jg, tg, v, jcfg, tcfg


@pytest.fixture(scope="module")
def models(cache_dir):
    """{preset: (JAX generator, port generator, JAX variables, (JAX batch, port batch))}"""
    out = {}
    for exp in ("layoutdm", "vqdiffusion", "layoutdm_ra"):
        jg, tg, v, jcfg, tcfg = _generators(exp, cache_dir)
        assert isinstance(tg, tdiff.LayoutDMGenerator) and tg.num_timesteps == T_STEPS
        jd, _, jtest = jconfig.build_datasets(jcfg)
        td, _, ttest = tconfig.build_datasets(tcfg)
        kw = dict(shuffle=False, transforms=(), use_native=False)
        jb = next(iter(jdata.BatchLoader(jtest, 4, prefetch=0, **kw)))
        tb = next(iter(tdata.BatchLoader(ttest, 4, **kw)))
        if tg.with_retrieval:  # neighbours from the train split, the same rows for both
            idx = np.random.default_rng(1).integers(0, len(td), size=(4, tg.top_k))
            jl, tl = jd.get_layouts(idx.reshape(-1)), td.get_layouts(idx.reshape(-1))
            jb["retrieved"] = {k: a.reshape(4, tg.top_k, -1) for k, a in jl.items()}
            tb["retrieved"] = {k: a.reshape(4, tg.top_k, -1) for k, a in tl.items()}
        out[exp] = (jg, tg, v, (jb, tb))
    return out


# ---- schedules and tables ---------------------------------------------------------


def test_alpha_schedule_is_exact():
    for T, N in ((50, 129), (12, 516), (2, 4)):
        for j, t in zip(jdiff.alpha_schedule(T, N), tdiff.alpha_schedule(T, N), strict=True):
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("q_type", ["constrained", "default"])
def test_transition_tables_are_exact(models, q_type):
    exp = "layoutdm" if q_type == "constrained" else "vqdiffusion"
    jg, tg, _, _ = models[exp]
    want = jdiff.build_tables(jg.tokenizer, T_STEPS, q_type)
    got = tdiff.build_tables(tg.tokenizer, T_STEPS, q_type)
    for field in ("log_at", "log_bt", "log_ct", "log_1_min_ct", "log_cum_at", "log_cum_bt",
                  "log_cum_ct", "log_1_min_cum_ct", "log_ind"):
        a = getattr(got, field)
        assert a.dtype == torch.float32, field
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, field)), err_msg=field)
    with pytest.raises(ValueError):
        tdiff.build_tables(tg.tokenizer, T_STEPS, "uniform")


# ---- the diffusion math -------------------------------------------------------------


def _log_x(rng, B, L, V, mask_share=0.3):
    """Random log one-hots with about mask_share of the positions at MASK."""
    idx = rng.integers(0, V - 1, size=(B, L))
    idx = np.where(rng.random((B, L)) < mask_share, V - 1, idx)
    return idx, np.asarray(jdiff.index_to_log_onehot(jnp.asarray(idx), V))


@pytest.mark.parametrize("q_type", ["constrained", "default"])
def test_q_pred_posterior_and_predict_start_match_jax(models, q_type):
    """q_pred (t = -1 included: row T, the identity), q_pred_one_timestep,
    q_posterior at t = 0 and per-row timesteps, predict_start."""
    jg, tg, _, _ = models["layoutdm" if q_type == "constrained" else "vqdiffusion"]
    jd, td = jg.diffusion, tg.diffusion
    V, L = td.V, td.L
    rng = np.random.default_rng(0)
    idx, log_x_t = _log_x(rng, 5, L, V)
    np.testing.assert_array_equal(tdiff.index_to_log_onehot(_t(idx), V).numpy(), log_x_t)
    np.testing.assert_array_equal(tdiff.log_onehot_to_index(_t(log_x_t)).numpy(), idx)
    logits = rng.normal(size=(5, L, V)).astype(np.float32) * 3
    x0_j = jd.predict_start(jnp.asarray(logits))
    x0_t = td.predict_start(_t(logits))
    _close(x0_t.numpy(), np.asarray(x0_j))
    t_rows = np.array([0, 1, 5, T_STEPS - 1, 0], np.int32)
    for t in (t_rows, 0, T_STEPS - 1):
        jt = jnp.asarray(t if isinstance(t, np.ndarray) else np.full(5, t, np.int32))
        tt = _t(t).long() if isinstance(t, np.ndarray) else t
        _close(td.q_pred(_t(log_x_t), tt).numpy(), np.asarray(jd.q_pred(jnp.asarray(log_x_t), jt)))
        _close(td.q_pred(_t(log_x_t), tt - 1).numpy(),
               np.asarray(jd.q_pred(jnp.asarray(log_x_t), jt - 1)))
        _close(td.q_pred_one_timestep(_t(log_x_t), tt).numpy(),
               np.asarray(jd.q_pred_one_timestep(jnp.asarray(log_x_t), jt)))
        _close(td.q_posterior(x0_t, _t(log_x_t), tt).numpy(),
               np.asarray(jd.q_posterior(x0_j, jnp.asarray(log_x_t), jt)))
    # t - 1 = -1 is the identity row of the cumulative tables
    ident = td.q_pred(_t(log_x_t), -1)
    _close(ident.numpy(), np.asarray(jd.q_pred(jnp.asarray(log_x_t), jnp.full(5, -1))))
    assert bool((ident.argmax(-1) == _t(idx)).all())


@pytest.mark.parametrize("terms", ["plain", "strong", "weak", "pad_disable", "all"])
def test_sample_single_step_matches_jax(models, terms):
    """One reverse step from a random x_t with each conditioning term:
    the strong replacement of known tokens, the weak refinement prior, PAD
    forbidden where the element count is known; at t = 7."""
    jg, tg, v, (jb, tb) = models["layoutdm"]
    jd, td = jg.diffusion, tg.diffusion
    V, L, B = td.V, td.L, 4
    rng = np.random.default_rng(3)
    _, log_z = _log_x(rng, B, L, V, mask_share=0.6)
    logits = rng.normal(size=(B, L, V)).astype(np.float32) * 2
    kw_j, kw_t = {}, {}
    if terms in ("strong", "all"):
        seq = rng.integers(0, V - 1, size=(B, L))
        known = rng.random((B, L)) < 0.4
        kw_j.update(strong_seq=jnp.asarray(seq), strong_mask=jnp.asarray(known))
        kw_t.update(strong_seq=_t(seq).long(), strong_mask=_t(known))
    if terms in ("weak", "all"):
        weak = (rng.normal(size=(B, L, V)) * 3).astype(np.float32)
        wmask = np.broadcast_to(rng.random((B, L, 1)) < 0.5, (B, L, V))
        kw_j.update(weak_logits=jnp.asarray(weak), weak_mask=jnp.asarray(wmask))
        kw_t.update(weak_logits=_t(weak), weak_mask=_t(wmask))
    if terms in ("pad_disable", "all"):
        pd = rng.random((B, L)) < 0.7
        kw_j.update(pad_disable_mask=jnp.asarray(pd))
        kw_t.update(pad_disable_mask=_t(pd))
    want = jd.sample_single_step(jax.random.PRNGKey(0), jnp.asarray(log_z),
                                 lambda x, t: jnp.asarray(logits), jnp.full((B,), 7), 0,
                                 JGREEDY, **kw_j)
    got = td.sample_single_step(_t(log_z), lambda x, t: _t(logits), 7, TGREEDY, **kw_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- relation costs -------------------------------------------------------------


def _relation_inputs(rng, B, S, E, V):
    log_prob = rng.normal(size=(B, 5 * S, V)).astype(np.float32) * 2
    edge_idx = rng.integers(0, S + 1, size=(B, E, 2))
    edge_idx[:, ::5] = -1  # invalid edges
    edge_attr = rng.integers(0, 2**10, size=(B, E))
    return log_prob, edge_idx, edge_attr


def test_relation_cost_and_update_match_jax_grad(models):
    """The 14 CLG-LO terms on expected coordinates, and three gradient steps
    of update_logits_for_relation against jax.grad, gated per row by t >= 10;
    also under torch.inference_mode, where the samplers may run."""
    jg, tg, _, _ = models["layoutdm"]
    rng = np.random.default_rng(4)
    B, S, E = 4, tg.tokenizer.max_seq_length, 9
    lp, ei, ea = _relation_inputs(rng, B, S, E, tg.tokenizer.N_total)
    jc = jrc.stochastic_convert(jnp.asarray(lp), jg.tokenizer)
    tc = trc.stochastic_convert(_t(lp), tg.tokenizer)
    for k in jc:
        _close(tc[k].numpy(), np.asarray(jc[k]))
    bbox = rng.uniform(0, 1, size=(B, S + 1, 4)).astype(np.float32)
    _close(trc.relation_cost(_t(bbox), _t(ei), _t(ea)).numpy(),
           np.asarray(jrc.relation_cost(jnp.asarray(bbox), jnp.asarray(ei), jnp.asarray(ea))))
    t = np.array([12, 9, 10, 30])
    want = jrc.update_logits_for_relation(jnp.asarray(lp), jnp.asarray(t), jnp.asarray(ei),
                                          jnp.asarray(ea), jg.tokenizer, 1.0, 3)
    got = trc.update_logits_for_relation(_t(lp), _t(t), _t(ei), _t(ea), tg.tokenizer)
    _close(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), lp[1])  # t = 9: gated off
    assert np.abs(got[0].numpy() - lp[0]).max() > 0
    with torch.inference_mode():
        again = trc.update_logits_for_relation(_t(lp), _t(t), _t(ei), _t(ea), tg.tokenizer)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


# ---- the decoder and the cores --------------------------------------------------


def test_trap_timestep_embedding_follows_the_jitted_program():
    """AdaLayerNorm's angle t / max_timestep * 4000 * freq as JAX's jitted
    samplers compute it: XLA folds 4000 * fp32(1 / max_timestep) into one
    constant, and computes the frequencies correctly rounded, where eager
    jnp.exp and torch.exp may each miss by an ulp; at some 4000 radians an
    ulp of either moves a sine by 5e-5."""
    half = 16
    want = jax.jit(lambda x: jnp.exp(jnp.arange(half) * (-np.log(10000.0) / (half - 1))) * x)(
        jnp.float32(1.0))
    np.testing.assert_array_equal(tdiff.timestep_frequencies(2 * half), np.asarray(want))
    eager = np.asarray(jnp.exp(jnp.arange(half) * (-np.log(10000.0) / (half - 1))))
    assert (eager != np.asarray(want)).any()  # the eager path rounds otherwise
    for T in (7, 12, 50, 1000):
        t = jnp.arange(T)
        jitted = jax.jit(lambda t: t.astype(jnp.float32) / T * 4000.0)(t)
        got = torch.arange(T).float() * tdiff.AdaLayerNorm(32, T).t_scale
        np.testing.assert_array_equal(got.numpy(), np.asarray(jitted), err_msg=f"T={T}")


def test_elem_attr_positional_encoding_matches_jax():
    x = np.random.default_rng(5).normal(size=(3, 50, 32)).astype(np.float32)
    jm = jpos.ElemAttrPositionalEncoding1D(32, n_attr_per_elem=5)
    v = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tm = tpos.ElemAttrPositionalEncoding1D(32, n_attr_per_elem=5).eval()
    load_jax_params(tm, v["params"])
    with torch.no_grad():
        _close(tm(_t(x)).numpy(), np.asarray(jm.apply(v, jnp.asarray(x))))
        with pytest.raises(ValueError, match="multiple"):
            tm(_t(x[:, :49]))


@pytest.mark.parametrize("exp", ["layoutdm", "vqdiffusion", "layoutdm_ra"])
def test_cores_match_jax(models, exp):
    """encode_memory (with the retrieval augmentation for RA: FIDNet over the
    B*K neighbours, adapter, cross-attention, fusion) and the decoder's
    logits at per-row timesteps, with each position encoding."""
    jg, tg, v, (jb, tb) = models[exp]
    retrieved_j = retrieved_t = None
    if tg.with_retrieval:
        retrieved_j = {k: jnp.asarray(a) for k, a in jb["retrieved"].items()}
        dtypes = {"label": torch.int64, "mask": torch.bool}
        retrieved_t = {k: _t(a).to(dtypes.get(k, torch.float32))
                       for k, a in tb["retrieved"].items()}
    want_mem = jg.core.apply(v, jnp.asarray(jb["image"]), retrieved_j,
                             method=jdiff.LayoutDMCore.encode_memory)
    with torch.no_grad():
        mem = tg.core.encode_memory(_t(tb["image"]), retrieved_t)
    M = 4 * 3  # the 64x48 canvas's feature grid; RA adds its cross-attended copy and K
    assert mem.shape == want_mem.shape == (4, 2 * M + tg.top_k if tg.with_retrieval else M, 32)
    _close(mem.numpy(), np.asarray(want_mem))
    rng = np.random.default_rng(6)
    seq = rng.integers(0, tg.tokenizer.N_total, size=(4, tg.tokenizer.max_token_length))
    t = np.array([0, 3, T_STEPS - 1, 7], np.int32)
    want = jax.jit(jg.decoder_module.apply)({"params": v["params"]["decoder"]},
                                            jnp.asarray(seq), want_mem, jnp.asarray(t))
    with torch.no_grad():
        got = tg.core.decoder(_t(seq).long(), _t(want_mem), _t(t).long())
    _close(got.numpy(), np.asarray(want))


def _decoder_core(pos_emb, seed=0):
    torch.manual_seed(seed)
    return tdiff.DiffusionDecoderCore(37, d_model=32, nhead=4, num_layers=3, dim_feedforward=64,
                                      dropout=0.0, max_timestep=T_STEPS, pos_emb=pos_emb)


@pytest.mark.parametrize("route", ["einsum", "kernel"])
@pytest.mark.parametrize("pos_emb", ["elem_attr", "layout"])
def test_decoder_cross_kv_is_the_projection(monkeypatch, pos_emb, route):
    """The decoder over K and V projected once (`cross_kv`) equals the decoder
    projecting the memory at each call, bit for bit: the same GEMMs on the
    same inputs.  "kernel": K10's dispatch stood in on the CPU (`on_card`
    patched true), its plain version running."""
    if route == "kernel":
        monkeypatch.setattr(tnn, "on_card", lambda t: True)
    core = _decoder_core(pos_emb).eval()
    g = torch.Generator().manual_seed(1)
    tgt = torch.randint(0, 37, (3, 10), generator=g)
    memory = torch.randn(3, 12, 32, generator=g)
    t = torch.tensor([0, 5, T_STEPS - 1])
    with torch.no_grad(), tracing.traced():
        want = core(tgt, memory, t)
        got = core(tgt, memory, t, core.cross_kv(memory))
        plain = tracing.counters().get("attn.cross.plain", 0)
    assert torch.equal(got, want)
    assert plain == (0 if route == "kernel" else 2 * core.num_layers)


def test_decoder_train_mode_takes_no_kernel(monkeypatch):
    """A train-mode forward never reaches K10, even where it would on the
    card, and counts no `attn.cross.plain`; its gradients are the einsum
    path's exactly."""
    g = torch.Generator().manual_seed(2)
    tgt = torch.randint(0, 37, (3, 10), generator=g)
    memory = torch.randn(3, 12, 32, generator=g)
    t = torch.tensor([1, 4, 9])
    grads = []
    for stood_in in (False, True):
        if stood_in:
            monkeypatch.setattr(tnn, "on_card", lambda t: True)
            monkeypatch.setattr(tnn, "cross_attention", lambda *a: pytest.fail("K10 in train mode"))
        core = _decoder_core("elem_attr").train()
        mem = memory.clone().requires_grad_()
        with tracing.traced():
            core(tgt, mem, t).square().sum().backward()
            assert "attn.cross.plain" not in tracing.counters()
        grads.append([mem.grad] + [p.grad for p in core.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_sampling_projects_the_memory_once(models):
    """A request's denoising loop projects each layer's cross-attention K and
    V once, before its T steps, not at every step."""
    _, tg, _, (_, tb) = models["layoutdm"]
    tc, _ = tg.build_condition(tb, np.random.default_rng(0), task="uncond")
    calls = []
    hooks = [layer.MultiHeadAttention_1.k_proj.register_forward_hook(
        lambda *a, i=i: calls.append(i)) for i, layer in enumerate(tg.core.decoder.layers())]
    try:
        with torch.inference_mode():
            tg.sample(tc, TGREEDY, torch.Generator().manual_seed(3))
    finally:
        for h in hooks:
            h.remove()
    assert calls == list(range(tg.core.decoder.num_layers))


# ---- sampling ---------------------------------------------------------------------


@pytest.mark.parametrize("exp", ["layoutdm", "vqdiffusion"])
@pytest.mark.parametrize("task", TASKS)
def test_deterministic_samples_equal_jax(models, exp, task):
    """Every task's tokens equal JAX's (its jitted sampler, as its CLI runs
    it; the port's under torch.inference_mode, as its CLI runs it); the
    user's tokens stay in place and a given element is never PAD."""
    jg, tg, v, (jb, tb) = models[exp]
    jc, _ = jg.build_condition(jb, np.random.default_rng(21), task=task)
    tc, _ = tg.build_condition(tb, np.random.default_rng(21), task=task)
    sampler = _jax_sampler(jg)
    _, want = sampler.sample(v, jc, jax.random.PRNGKey(3), return_tokens=True)
    with torch.inference_mode():
        _, got = tg.sample(tc, TGREEDY, torch.Generator().manual_seed(3), return_tokens=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    toks = got.numpy()
    assert not (toks == tg.diffusion.mask_id).any()
    if tc.seq is not None:
        known = np.asarray(tc.seq_mask)
        np.testing.assert_array_equal(toks[known], np.asarray(tc.seq)[known])
    if task in ("c", "cwh", "refinement", "relation"):
        given = (np.arange(toks.shape[1]) % 5 != 0)[None] & (np.asarray(tc.seq) != tg.tokenizer.pad_id)
        assert not (toks[given] == tg.tokenizer.pad_id).any()


_SAMPLERS = {}


def _jax_sampler(jg):
    """JAX's jitted diffusion sampler (its CLI's `--mesh auto` path on one
    device), one per generator so that a conditioning pattern compiles once."""
    if id(jg) not in _SAMPLERS:
        _SAMPLERS[id(jg)] = DiffusionMeshSampler(jg, make_decode_mesh(), JGREEDY)
    return _SAMPLERS[id(jg)]


def test_ra_layoutdm_samples_equal_jax(models):
    jg, tg, v, (jb, tb) = models["layoutdm_ra"]
    jc, _ = jg.build_condition(jb, np.random.default_rng(2), task="c")
    tc, _ = tg.build_condition(tb, np.random.default_rng(2), task="c")
    _, want = _jax_sampler(jg).sample(v, jc, jax.random.PRNGKey(0), return_tokens=True)
    _, got = tg.sample(tc, TGREEDY, return_tokens=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tc.retrieved = None
    with pytest.raises(ValueError, match="retrieved"):
        tg.sample(tc, TGREEDY)


def test_prepare_sample_schedule_and_seq_dist(models):
    """JAX's schedule at the CLI's default (every step, T - 1 down to 0, no
    skip), which the port's loop takes, and use_seq_dist pinning the
    positions past a drawn element count to PAD."""
    jg, tg, v, (jb, tb) = models["layoutdm"]
    jc, _ = jg.build_condition(jb, np.random.default_rng(0), task="uncond")
    tc, _ = tg.build_condition(tb, np.random.default_rng(0), task="uncond")
    _, jts, jskips = jg.prepare_sample(jc, jax.random.PRNGKey(0))
    assert list(np.asarray(jts)) == list(range(T_STEPS - 1, -1, -1))
    assert not np.asarray(jskips).any()
    tg.use_seq_dist = True
    try:
        prepared = tg.prepare_sample(tc, torch.Generator().manual_seed(4))
        n = tg.seq_dist.sample(np.random.default_rng(4), 4)
        beyond = np.arange(tg.tokenizer.max_token_length)[None] >= 5 * n[:, None]
        np.testing.assert_array_equal(prepared["strong_mask"].numpy(), beyond)
        toks = tg.sample(tc, TGREEDY, torch.Generator().manual_seed(4), return_tokens=True)[1]
        assert (toks.numpy()[beyond] == tg.tokenizer.pad_id).all()
    finally:
        tg.use_seq_dist = False


# ---- cli.inference end to end ---------------------------------------------------


def _run_jax(main, argv):
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        main()
    finally:
        sys.argv = old


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("exp,cond", [("layoutdm", "c"), ("layoutdm_ra", "uncond")])
def test_cli_inference_writes_jax_pickles_and_violations(tmp_path, cache_dir, exp, cond):
    """One job dir (kmeans vocabulary from the cache, JAX's orbax checkpoint
    and the .npz of the same tree); JAX's CLI at its default --mesh auto on
    one CPU device and the port's write equal pickles and violation csvs;
    --kv-quant and --self-quant raise for the diffusion presets."""
    job = str(tmp_path / "job")
    cfg = jconfig.build_config(exp, TINY + [f"cache_dir={cache_dir}", f"train.job_dir={job}"])
    cfg.save(job)
    trainer = Trainer(jconfig.build_generator(cfg, jconfig.build_tokenizer(cfg)), cfg.train)
    state = trainer.init_state(jax.random.PRNGKey(0))
    trainer.save(state, "final")
    flat = {f"{name}/{k}": np.asarray(a) for name, tree in
            (("params", state.params), ("batch_stats", state.batch_stats))
            for k, a in flatten_dict(jax.device_get(tree), sep="/").items()}
    np.savez(os.path.join(job, "ckpt_final.npz"), **flat)
    args = ["--job-dir", job, "--cond", cond, "--num-seeds", "1", "--batch-size", "8"]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    want, got = _pickle(f"{job}/jax/test_0.pkl"), _pickle(f"{job}/port/test_0.pkl")
    assert len(got["results"]) == 16 and got == want
    assert _csv(f"{job}/port/test_0_violation.csv") == _csv(f"{job}/jax/test_0_violation.csv")
    if cond == "c":
        assert _csv(f"{job}/port/test_0_violation.csv")[1][2] == "0.0"
    for flag in ("--kv-quant", "--self-quant"):
        with pytest.raises(ValueError, match="kv-quant/--self-quant"):
            tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/q8", flag])
