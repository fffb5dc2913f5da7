"""The port's training slice against the JAX package, on the CPU.

Tiny `ralf` and `autoreg` generators (d_model 32, 4 heads, 1+1 layers,
resnet18, 64x48 canvases, top-4 retrieval) are initialised in JAX and
loaded into the port through the weights bridge; both packages then train
from that state on the same synthetic splits, loaders and seeds, in
float32 with dropout 0.  JAX's `Trainer` compiles one train step and one
eval step per model, shared by every run of that model here.

Tolerances: per-step losses and val losses rtol 2e-4; each top-level
subtree's update by cosine > 0.99 and norm ratio 0.97-1.03 (AdamW's first
steps are about lr * sign(g), so an element whose gradient is at the
cross-framework noise floor may step the other way: the rule of
tests/test_optim_torch_parity.py); BatchNorm statistics after the first
step rtol 1e-4 (+ 1e-6 absolute for a mean at zero), and after the last
by the change's cosine and ratio as the parameters: from the second step
on, the running means near zero inherit the parameters' elementwise
noise (measured: up to 3e-4 of a leaf's largest value after 3 steps);
the schedulers, optimizer partitions and metrics.jsonl's keys and LR
scales exactly; smoothed CE and flax's BatchNorm rtol 1e-6; the backward
of K1, K5, K6 against jax.grad through their custom_vjps rtol 1e-5, plus
1e-6 of the gradient's largest magnitude (a weight's gradient sums B*S
products in another order).
"""

import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ralf_tpu.core.tokenizer import LayoutSequenceTokenizer as JTokenizer
from ralf_tpu.core.tokenizer import TokenizerConfig as JTokCfg
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import nn as jnn
from ralf_tpu.models.autoreg import AutoregGenerator as JAutoreg
from ralf_tpu.models.autoreg import smoothed_ce_loss as j_smoothed_ce
from ralf_tpu.models.base import GeneratorConfig as JCfg
from ralf_tpu.models.ralf import RALFGenerator as JRALF
from ralf_tpu.ops.pallas import decode_attention as jda
from ralf_tpu.ops.pallas import encoder_attention as jea
from ralf_tpu.ops.pallas import encoder_ffn as jef
from ralf_tpu.parallel.mesh import replicate
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu.retrieval import wrapper as jwrap
from ralf_tpu.train import optim as joptim
from ralf_tpu.train import schedulers as jsched
from ralf_tpu.train.trainer import Trainer as JTrainer
from ralf_tpu.train.trainer import TrainConfig as JTrainConfig
from ralf_tpu.train.trainer import TrainState as JTrainState
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer as TTokenizer
from ralf_tpu_torch.core.tokenizer import TokenizerConfig as TTokCfg
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.models.autoreg import AutoregGenerator as TAutoreg
from ralf_tpu_torch.models.autoreg import smoothed_ce_loss as t_smoothed_ce
from ralf_tpu_torch.models.base import GeneratorConfig as TCfg
from ralf_tpu_torch.models.dropout import Dropout, set_dropout_generator
from ralf_tpu_torch.models.ralf import RALFGenerator as TRALF
from ralf_tpu_torch.models.resnet import BatchNorm
from ralf_tpu_torch.ops import encoder_attention as tea
from ralf_tpu_torch.ops import encoder_ffn as tef
from ralf_tpu_torch.retrieval import retriever as tret
from ralf_tpu_torch.retrieval import wrapper as twrap
from ralf_tpu_torch.train import optim as toptim
from ralf_tpu_torch.train import schedulers as tsched
from ralf_tpu_torch.train.trainer import Trainer as TTrainer
from ralf_tpu_torch.train.trainer import TrainConfig as TTrainConfig
from ralf_tpu_torch.utils.weights import export_params, load_jax_params, load_params_npz

torch.set_num_threads(2)
TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, backbone="resnet18", dropout=0.0)
HW, TOP_K, BATCH = (64, 48), 4, 8  # 8: one canvas per device of JAX's CPU mesh
N_TRAIN, N_VAL = 32, 16  # 4 train batches, 2 val batches
LOSS_RTOL, STATS_RTOL, STATS_ATOL = 2e-4, 1e-4, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the pair of generators, the data, and a run of each trainer -----------


@pytest.fixture(scope="module")
def pairs():
    """{name: (JAX generator, its initial variables as numpy, port generator)}."""
    out = {}
    for name, jcls, tcls, kw in (("ralf", JRALF, TRALF, {"top_k": TOP_K}),
                                 ("autoreg", JAutoreg, TAutoreg, {})):
        jt = JTokenizer(JTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
        tt = TTokenizer(TTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
        jg = jcls(jt, JCfg(**TINY), "uncond", image_hw=HW, **kw)
        v = _np(jg.init(jax.random.PRNGKey(0)))
        tg = tcls(tt, TCfg(**TINY), "uncond", image_hw=HW, device="cpu", **kw)
        out[name] = (jg, v, tg)
    return out


def _loaders(pkg: str, name: str):
    """Fresh (train, val) loaders of one package, seeded alike."""
    data, ret, wrap = (jdata, jret, jwrap) if pkg == "jax" else (tdata, tret, twrap)
    cfg = data.DatasetConfig(name="synthetic")
    train = data.SyntheticPosterDataset(cfg, N_TRAIN, 0, HW)
    val = data.SyntheticPosterDataset(cfg, N_VAL, 1, HW)
    kw = dict(use_native=False, prefetch=0)
    tl = data.BatchLoader(train, BATCH, seed=0, **kw)
    vl = data.BatchLoader(val, BATCH, shuffle=False, seed=0, **kw)
    if name == "ralf":
        retriever = (ret.Retriever.build(train) if pkg == "jax"
                     else ret.Retriever.build(train, device="cpu"))
        tl = wrap.RetrievalAugmentedLoader(tl, retriever, TOP_K, is_train_split=True)
        vl = wrap.RetrievalAugmentedLoader(vl, retriever, TOP_K)
    return tl, vl


_JAX_STEPS: dict = {}  # one compiled train and eval step per model, for every run


def run_jax(pairs, name, job_dir, cap, resume=False, **cfg):
    """JAX's Trainer.fit from the shared initial state: (final params,
    batch_stats, per-step losses, metrics.jsonl records, batch_stats after
    the first step)."""
    jg, v, _ = pairs[name]
    tcfg = JTrainConfig(job_dir=str(job_dir), batch_size=BATCH, **cfg)
    tr = JTrainer(jg, tcfg)
    if name not in _JAX_STEPS:
        tr.tx = joptim.build_optimizer(v["params"], base_lr=tcfg.lr,
                                       weight_decay=tcfg.weight_decay,
                                       clip_max_norm=tcfg.clip_max_norm)
        tr._build_steps()
        _JAX_STEPS[name] = (tr.tx, tr._train_step, tr._eval_step)
    tr.tx, step, tr._eval_step = _JAX_STEPS[name]
    losses, first = [], []

    def recorded(*args):
        state, metrics = step(*args)
        losses.append(float(metrics["loss"]))
        first.extend([] if first else [_np(state.batch_stats)])
        return state, metrics

    tr._train_step = recorded
    params = jax.tree.map(jnp.asarray, v["params"])
    state = replicate(tr.mesh, JTrainState(
        params=params, batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=tr.tx.init(params), step=jnp.zeros((), jnp.int32)))
    state = tr.fit(*_loaders("jax", name), state=state, num_steps_cap=cap, resume=resume)
    return _np(state.params), _np(state.batch_stats), losses, _records(job_dir), first


def run_port(pairs, name, job_dir, cap, resume=False, dropout=None, **cfg):
    """The port's Trainer.fit from the same initial state."""
    jg, v, tg = pairs[name]
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    if dropout is not None:
        for m in tg.core.modules():
            if isinstance(m, Dropout):
                m.p = dropout
    tr = TTrainer(tg, TTrainConfig(job_dir=str(job_dir), batch_size=BATCH, **cfg))
    losses, first = [], []
    step = tr.train_step

    def recorded(*args):
        metrics = step(*args)
        losses.append(float(metrics["loss"]))
        first.extend([] if first else [export_params(tg.core)[1]])
        return metrics

    tr.train_step = recorded
    tr.fit(*_loaders("port", name), num_steps_cap=cap, resume=resume)
    params, stats = export_params(tg.core)
    if dropout is not None:
        for m in tg.core.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return params, stats, losses, _records(job_dir), first


@pytest.fixture
def job_root(tmp_path):
    """tmp_path, emptied when the test ends: a run's checkpoints (the tiny
    RALF's parameters and AdamW state, both packages) take some 0.5 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _records(job_dir):
    with open(job_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def _same_change(key, before, after_j, after_t):
    """Cosine > 0.99 and norm ratio 0.97-1.03 of the two changes."""
    d_j, d_t = _flat(after_j) - _flat(before), _flat(after_t) - _flat(before)
    mag = float(np.linalg.norm(d_j))
    assert mag > 0, f"{key} did not move; the test has no teeth"
    cos = float(d_j @ d_t / (mag * np.linalg.norm(d_t)))
    ratio = float(np.linalg.norm(d_t)) / mag
    assert cos > 0.99 and 0.97 < ratio < 1.03, (key, cos, ratio)


def assert_same_training(j, t, init, n_steps):
    """Losses, per-subtree updates, the frozen tower, BatchNorm statistics
    and metrics.jsonl (see the module docstring for the tolerances)."""
    (jp, jbs, jl, jrec, jfirst), (tp, tbs, tl, trec, tfirst) = j, t
    assert len(jl) == len(tl) == n_steps
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for key in init["params"]:
        if key == "layout_encoder":  # frozen: no update, no decay, on both sides
            for after in (jp, tp):
                for a, b in zip(jax.tree.leaves(after[key]), jax.tree.leaves(init["params"][key])):
                    np.testing.assert_array_equal(a, b)
            continue
        _same_change(key, init["params"][key], jp[key], tp[key])
    for a, b in zip(jax.tree.leaves(tfirst), jax.tree.leaves(jfirst)):
        np.testing.assert_allclose(a, b, rtol=STATS_RTOL, atol=STATS_ATOL)
    if jbs:
        _same_change("batch_stats", init["batch_stats"], jbs, tbs)
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    assert [r["lr_scale"] for r in trec] == [r["lr_scale"] for r in jrec]
    assert [r["epoch"] for r in trec] == [r["epoch"] for r in jrec]
    np.testing.assert_allclose([r["val_loss"] for r in trec], [r["val_loss"] for r in jrec],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([r["train_loss"] for r in trec],
                               [r["train_loss"] for r in jrec], rtol=LOSS_RTOL)


# ---- schedulers, partitions, loss, BatchNorm, dropout ----------------------


def test_export_params_copies_what_training_changes_in_place():
    """On the CPU a tensor's .numpy() shares its storage: the exported tree
    must not follow the module's later in-place updates."""
    bn = BatchNorm(4)
    params, stats = export_params(bn)
    with torch.no_grad():
        bn.weight.add_(1.0)
        bn.running_mean.add_(1.0)
    assert (params["scale"] == 1.0).all() and (stats["mean"] == 0.0).all()


@pytest.mark.parametrize("name,kwargs,metrics", [
    ("multi_step_lr", dict(epochs=20, milestones=[0.3, 0.75]), None),
    ("multi_step_lr", dict(epochs=20, milestones=[2, 5, 11], gamma=0.5), None),
    ("reduce_lr_on_plateau", dict(epochs=20),
     [1.0, 0.9, 0.95, 0.9, 0.899, 0.95, 0.5, 0.5, 0.6, 0.49, 0.7, 0.7, 0.7, 0.7, 0.3, 0.3,
      0.3, 0.31, 0.29, 0.3]),
    ("dsgan", dict(epochs=300), None),
    ("dsgan", dict(epochs=300, intended_stair=True), None),
    ("dsgan", dict(epochs=300, intended_stair=True, network="discriminator"), None),
    ("void", dict(epochs=5), None),
])
def test_schedulers_give_jax_scales(name, kwargs, metrics):
    kwargs = dict(kwargs)
    epochs = kwargs.pop("epochs")
    js = jsched.build_scheduler(name, epochs, **kwargs)
    ts = tsched.build_scheduler(name, epochs, **kwargs)
    seq = metrics or [None] * epochs
    got = [ts.scale(e, m) for e, m in enumerate(seq)]
    assert got == [js.scale(e, m) for e, m in enumerate(seq)]
    if name == "reduce_lr_on_plateau":
        assert min(got) < 1.0  # the planted sequence crosses a reduction


@pytest.mark.parametrize("name", ["ralf", "autoreg"])
def test_optimizer_partitions_match_jax(pairs, name):
    """Decayed, trunk (0.1x LR) and frozen element counts, by group, equal
    those of JAX's decay_mask and lr_group_labels: LayerNorm scales and
    embeddings are `weight` in torch, and stay undecayed."""
    jg, v, tg = pairs[name]
    labels = jax.tree.leaves(joptim.lr_group_labels(v["params"]))
    decay = jax.tree.leaves(joptim.decay_mask(v["params"]))
    sizes = [a.size for a in jax.tree.leaves(v["params"])]
    want: dict = {}
    for lab, d, n in zip(labels, decay, sizes):
        want[(lab, d)] = want.get((lab, d), 0) + n
    tl, td = toptim.lr_group_labels(tg.core), toptim.decay_mask(tg.core)
    got: dict = {}
    for pname, p in tg.core.named_parameters():
        got[(tl[pname], td[pname])] = got.get((tl[pname], td[pname]), 0) + p.numel()
    assert got == want
    assert ("frozen", True) in got if name == "ralf" else "frozen" not in {k[0] for k in got}
    opt = toptim.Optimizer(tg.core)
    in_opt = sum(p.numel() for g in opt.opt.param_groups for p in g["params"])
    assert in_opt == sum(n for (lab, _), n in want.items() if lab != "frozen")
    opt.set_learning_rate(2e-3)
    assert {g["label"]: g["lr"] for g in opt.opt.param_groups} == {"rest": 2e-3, "trunk": 2e-3 * 0.1}


@pytest.mark.parametrize("scale", [1.25, 0.1])  # global norm above and below max_norm 1
def test_clip_follows_optax_global_norm(scale):
    """The clip scales by max_norm / norm, as optax.clip_by_global_norm does
    (within 3e-7: the two round g * (m / n) and g / n * m); torch's
    clip_grad_norm_ divides by norm + 1e-6, 8e-7 apart here."""
    import optax

    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 5), (7,), (3, 2, 2))]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    grads = [g * np.float32(scale / norm) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    module = torch.nn.ParameterList([torch.nn.Parameter(torch.zeros(g.shape)) for g in grads])
    opt = toptim.Optimizer(module, clip_max_norm=1.0)
    for p, g in zip(module, grads):
        p.grad = _t(g)
    opt.step()  # clips the gradients in place, then AdamW moves the parameters
    for p, w in zip(module, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=3e-7, atol=0)
    if scale > 1:  # torch's own clip lands elsewhere
        tg = [_t(g) for g in grads]
        torch.nn.utils.clip_grad_norm_(tg, 1.0)
        assert not all(np.allclose(a.numpy(), np.asarray(w), rtol=3e-7, atol=0)
                       for a, w in zip(tg, want))


def test_smoothed_ce_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 7, 23)).astype(np.float32)
    targets = rng.integers(0, 23, (4, 7))
    targets[0, 3:] = 5  # pad positions
    targets[2, :] = 5  # a row of pads only
    want = float(j_smoothed_ce(jnp.asarray(logits), jnp.asarray(targets), 5, 0.1))
    got = float(t_smoothed_ce(_t(logits), _t(targets), 5, 0.1))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_batchnorm_train_mode_matches_flax():
    """Output and running statistics after two calls equal flax's
    BatchNorm(use_running_average=False, momentum=0.9); torch's own
    F.batch_norm stores the unbiased variance and misses them."""
    rng = np.random.default_rng(1)
    xs = [rng.normal(1.5, 2.0, (3, 5, 4, 6)).astype(np.float32) for _ in range(2)]  # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = {"scale": jnp.asarray(rng.normal(1, 0.2, 6).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(0, 0.2, 6).astype(np.float32))}
    stats = v["batch_stats"]
    tb = BatchNorm(6).train()
    load_jax_params(tb, _np(params), _np(stats))
    for x in xs:
        ref, upd = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            mutable=["batch_stats"])
        stats = upd["batch_stats"]
        out = tb(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(tb.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    # torch's train-mode update (momentum 0.1, unbiased variance) lands elsewhere
    rm, rv = torch.zeros(6), torch.ones(6)
    for x in xs:
        torch.nn.functional.batch_norm(_t(x).permute(0, 3, 1, 2), rm, rv, training=True,
                                       momentum=0.1)
    assert not np.allclose(rv.numpy(), np.asarray(stats["var"]), rtol=1e-4)


def test_dropout_keeps_a_binomial_share_scaled_by_its_inverse():
    d = Dropout(0.1).train()
    set_dropout_generator(d, torch.Generator().manual_seed(0))
    x = torch.rand(200_000) + 0.5
    out = d(x)
    n = x.numel()
    zeros = int((out == 0).sum())
    sd = (n * 0.1 * 0.9) ** 0.5
    assert abs(zeros - 0.1 * n) < 5 * sd, zeros  # within 5 standard deviations
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / 0.9, rtol=1e-6, atol=0)
    d.eval()
    assert d(x) is x
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.1).train()(x)


# ---- the kernel gate --------------------------------------------------------


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the port modules' calls of the K1, K5 and K6 wrappers."""
    calls = {"K1": 0, "K5": 0, "K6": 0}

    def spy(kid, fn):
        def wrapped(*args):
            calls[kid] += 1
            return fn(*args)
        return wrapped

    for kid, name in (("K1", "encoder_attention"), ("K5", "fused_ffn"),
                      ("K6", "encoder_self_attention")):
        monkeypatch.setattr(tnn, name, spy(kid, getattr(tnn, name)))
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_encoders_take_the_einsum_path_in_train_mode(wrapper_calls, fused):
    """An encoder in train mode takes none of K1, K5, K6, at dropout 0 too
    (JAX gates on `deterministic`, not on the rate); in eval mode it takes
    K1, or with the fused flags K6 and K5 (S = 20 >= 16)."""
    enc = tnn.TransformerEncoder(32, 4, 2, 64, dropout=0.0)
    for m in enc.modules():
        if isinstance(m, tnn.MultiHeadAttention):
            m.use_qkv_folded = fused
        elif isinstance(m, tnn.FeedForward):
            m.use_pallas = fused
    x = torch.randn(3, 20, 32)
    keep = torch.ones(3, 20, dtype=torch.bool)
    keep[0, 12:] = False
    train_out = enc.train()(x, keep)
    assert wrapper_calls == {"K1": 0, "K5": 0, "K6": 0}
    eval_out = enc.eval()(x, keep)
    assert wrapper_calls == ({"K1": 0, "K5": 2, "K6": 2} if fused else {"K1": 2, "K5": 0, "K6": 0})
    torch.testing.assert_close(train_out, eval_out, rtol=1e-5, atol=1e-5)


def test_fidnet_takes_k1_inside_the_ralf_train_step(pairs, wrapper_calls, job_root):
    """The frozen tower stays in eval mode in a train step (K1 for its 4
    layers, no gradient); the eval step adds the 1 + 1 encoder layers."""
    jg, v, tg = pairs["ralf"]
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    tr = TTrainer(tg, TTrainConfig(job_dir=str(job_root), batch_size=BATCH))
    state = tr.init_state()
    batch = next(iter(_loaders("port", "ralf")[0]))
    inputs, targets = tg.preprocess(batch, np.random.default_rng(0))
    tr.train_step(state, inputs, targets)
    assert tg.core.training and not tg.core.layout_encoder.training
    assert wrapper_calls == {"K1": 4, "K5": 0, "K6": 0}
    # the tower requires grad, as every leaf does, but runs under no_grad
    # (JAX's stop_gradient): no gradient reaches it
    assert all(p.grad is None and p.requires_grad for p in tg.core.layout_encoder.parameters())
    tr.eval_step(state, inputs, targets)
    assert wrapper_calls == {"K1": 4 + 4 + 2, "K5": 0, "K6": 0}


# ---- the backward of K1, K5, K6 ----------------------------------------------


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX modules' Pallas paths, run in interpret mode on the CPU."""
    monkeypatch.setattr(jda, "pallas_decode_available", lambda: True)
    folded, unfolded = jea._fused_qkv_forward, jea._fused_forward
    monkeypatch.setattr(jea, "_fused_qkv_forward",
                        lambda x, w, h, kb, interp, bb, qc: folded(x, w, h, kb, True, bb, qc))
    monkeypatch.setattr(jea, "_fused_forward", lambda q, k, v, h, kb, interp, bb, qc:
                        unfolded(q, k, v, h, kb, True, bb, qc))


def _grads_close(got, want):
    for g, w in zip(got, want):
        _grad_close(g, w)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_k1_backward_matches_jax_custom_vjp():
    rng = np.random.default_rng(0)
    B, S, E, H = 3, 9, 32, 4
    q, k, v, g = (rng.normal(size=(B, S, E)).astype(np.float32) for _ in range(4))
    keep = rng.random((B, S)) > 0.3
    keep[1] = False  # a fully masked row
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jea.fused_encoder_attention(q, k, v, H, jnp.asarray(bias),
                                                                 interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tea.encoder_attention(*ins, H, _t(bias))
    _grads_close(torch.autograd.grad(out, ins, _t(g)), want)


def test_k5_backward_matches_jax_custom_vjp():
    rng = np.random.default_rng(1)
    B, S, E, F = 2, 17, 32, 64
    x, g = (rng.normal(size=(B, S, E)).astype(np.float32) for _ in range(2))
    w1 = (rng.normal(size=(E, F)) / 6).astype(np.float32)  # flax's [in, out]
    w2 = (rng.normal(size=(F, E)) / 8).astype(np.float32)
    b1, b2 = rng.normal(size=F).astype(np.float32), rng.normal(size=E).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    _, vjp = jax.vjp(functools.partial(jef.fused_ffn, interpret=True), *args)
    want = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_() for a in (x, w1.T, b1, w2.T, b2)]  # nn.Linear's [out, in]
    out = tef.fused_ffn(*ins)
    got = list(torch.autograd.grad(out, ins, _t(g)))
    got[1], got[3] = got[1].t(), got[3].t()
    _grads_close(got, want)


def test_k6_backward_matches_jax_and_gives_q_bias_no_gradient(jax_interpret):
    """Through MultiHeadAttention's folded path in eval mode: every
    parameter's gradient equals jax.grad through JAX's custom_vjp, and
    q_proj's bias, whose per-key logit rides in key_bias, gets none."""
    rng = np.random.default_rng(2)
    B, S, D, H = 3, 12, 32, 4
    x, g = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(2))
    keep = rng.random((B, S)) > 0.3
    keep[:, 0] = True
    jm = jnn.MultiHeadAttention(D, H, dropout=0.0, use_qkv_folded=True)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype),
                          params)  # nonzero biases
    jbias = jnn.keep_to_bias(jnp.asarray(keep))[:, None, None, :]

    xj = jnp.asarray(x)

    def loss(p):  # q_in is kv_in: the folded path
        return jnp.sum(jm.apply({"params": p}, xj, xj, jbias) * jnp.asarray(g))

    want = jax.grad(loss)(params)
    tm = tnn.MultiHeadAttention(D, H, dropout=0.0, use_qkv_folded=True).eval()
    load_jax_params(tm, _np(params))

    tx = _t(x)
    (tm(tx, tx, tnn.keep_to_bias(_t(keep))[:, None, None, :]) * _t(g)).sum().backward()
    assert not np.asarray(want["q_proj"]["bias"]).any()
    for mod in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lin = getattr(tm, mod)
        _grad_close(lin.weight.grad.t(), want[mod]["kernel"])
        _grad_close(torch.zeros_like(lin.bias) if lin.bias.grad is None else lin.bias.grad,
                    want[mod]["bias"])
    assert tm.q_proj.bias.grad is None  # no path reaches it, as JAX's zero cotangent


def _gradient_case(name, dtype, seed=4):
    """Small inputs with masked keys (no row fully masked), the shipped
    wrapper's gradients on the CPU (plain forward, reference backward), and
    chip_smoke.py's plain gradients with their allowances."""
    import chip_smoke

    g = torch.Generator().manual_seed(seed)
    B, S, E, H, F = 2, 24, 64, 2, 128

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    keep = torch.ones(B, S, dtype=torch.bool)
    keep[0, 15:] = False
    bias = tnn.keep_to_bias(keep)
    kb = rand(B, H, S) + bias[:, None, :]
    if name == "encoder_attention":
        raw, key_bias = [rand(B, S, E, scale=(E // H) ** -0.5), rand(B, S, E), rand(B, S, E)], bias
        function = lambda q, k, v: tea.encoder_attention(q, k, v, H, bias)  # noqa: E731
    elif name == "fused_ffn":
        raw, key_bias = [rand(B, S, E), rand(F, E, scale=E ** -0.5), rand(F),
                         rand(E, F, scale=F ** -0.5), rand(E)], None
        function = tef.fused_ffn
    else:
        raw, key_bias = [rand(B, S, E), rand(3 * E, E, scale=E ** -0.5)], kb
        function = lambda x, w: tea.encoder_self_attention(x, w, H, kb)  # noqa: E731
    ins = [t.to(dtype).requires_grad_() for t in raw]
    out = function(*ins)
    gout = rand(*out.shape).to(dtype)
    got = torch.autograd.grad(out, ins, gout)
    want, allow = chip_smoke.plain_gradients(torch, name, ins, gout, H, key_bias)
    return [bool(((a.float() - b.float()).abs() <= t).all()) for a, b, t in zip(got, want, allow)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["encoder_attention", "fused_ffn", "encoder_self_attention"])
def test_k1_k5_k6_gradients_agree_with_their_plain_versions(name, dtype):
    """The backward JAX's reference gives equals autograd of the plain
    version, which the kernel is held to, within the forward's tolerance
    taken against each gradient's sums: the check chip_smoke.py makes of
    the kernels' Functions on the card."""
    assert all(_gradient_case(name, dtype))


def test_gradient_allowance_refuses_a_misplaced_key_bias_or_b1(monkeypatch):
    """The allowance takes roundings, not another function: a reference
    that drops K6's key bias, or adds K5's b1 after the relu, fails it."""
    reference = tea.attention_reference
    monkeypatch.setattr(tea, "attention_reference",
                        lambda q, k, v, nhead, key_bias=None: reference(q, k, v, nhead))
    assert not all(_gradient_case("encoder_self_attention", torch.float32))
    monkeypatch.setattr(tef, "ffn_reference", lambda x, w1, b1, w2, b2:
                        (torch.relu(x @ w1.t()) + b1) @ w2.t() + b2)
    assert not all(_gradient_case("fused_ffn", torch.float32))


# ---- trajectories and resume against JAX -----------------------------------


@pytest.mark.parametrize("name", ["ralf", "autoreg"])
def test_three_step_trajectory_matches_jax(pairs, name, job_root):
    j = run_jax(pairs, name, job_root / "jax", cap=3, epochs=1)
    t = run_port(pairs, name, job_root / "port", cap=3, epochs=1)
    assert_same_training(j, t, pairs[name][1], 3)


def test_multi_step_lr_milestone_inside_the_run_matches_jax(pairs, job_root):
    """2 epochs of 2 steps with a milestone at epoch 1: epoch 2 runs at 0.1x."""
    cfg = dict(epochs=2, scheduler="multi_step_lr", scheduler_kwargs={"milestones": [1]})
    j = run_jax(pairs, "autoreg", job_root / "jax", cap=2, **cfg)
    t = run_port(pairs, "autoreg", job_root / "port", cap=2, **cfg)
    assert [r["lr_scale"] for r in t[3]] == [0.1, 0.1]
    assert_same_training(j, t, pairs["autoreg"][1], 4)


def test_resume_matches_jax(pairs, job_root):
    """Two steps and a step checkpoint, then a resume with two more, on
    both sides: the resumed steps' losses agree, and so does the result."""
    out = {}
    for pkg, run in (("jax", run_jax), ("port", run_port)):
        d = job_root / pkg
        first = run(pairs, "autoreg", d, cap=2, epochs=1, save_every_steps=2)
        second = run(pairs, "autoreg", d, cap=4, resume=True, epochs=1, save_every_steps=2)
        with open(d / "ckpt_step_meta.json") as f:
            assert json.load(f) == {"epoch": 1, "step_in_epoch": 4, "global_step": 4}
        out[pkg] = (first, second)
    np.testing.assert_allclose(out["port"][0][2], out["jax"][0][2], rtol=LOSS_RTOL)
    assert len(out["port"][1][2]) == 2
    np.testing.assert_allclose(out["port"][1][2], out["jax"][1][2], rtol=LOSS_RTOL)
    assert_same_training((*out["jax"][1][:2], [], [], []), (*out["port"][1][:2], [], [], []),
                         pairs["autoreg"][1], 0)


def test_resume_with_dropout_replays_the_run_bit_for_bit(pairs, job_root):
    """Dropout 0.1: four uninterrupted steps equal two, a step checkpoint, a
    resume and two more, bit for bit (the per-step dropout generator)."""
    whole = run_port(pairs, "autoreg", job_root / "whole", cap=4, dropout=0.1, epochs=1)
    d = job_root / "split"
    first = run_port(pairs, "autoreg", d, cap=2, dropout=0.1, epochs=1, save_every_steps=2)
    second = run_port(pairs, "autoreg", d, cap=4, resume=True, dropout=0.1, epochs=1,
                      save_every_steps=2)
    assert first[2] + second[2] == whole[2]
    for a, b in zip(jax.tree.leaves((whole[0], whole[1])), jax.tree.leaves((second[0], second[1]))):
        np.testing.assert_array_equal(a, b)
    # dropout was on: the same four steps at rate 0 give other losses
    plain = run_port(pairs, "autoreg", job_root / "plain", cap=4, epochs=1)
    assert plain[2] != whole[2]


# ---- the entry points and the checkpoint ------------------------------------


def test_trainer_and_cli_refuse_what_waits_for_later_items(pairs, job_root):
    """The row-sharded gallery is ported (item 10): cli.train refuses a
    train.gallery_shards that does not divide the world size, as JAX's does
    (a plain start is a world of one; tests/test_torch_port_dp_train.py
    trains at world 2).  bf16 training is ported (item 11): the trainer
    takes a core cast whole to bf16, as serving builds it, and trains it
    with fp32 master weights."""
    from ralf_tpu_torch.cli import train as cli_train

    _, _, tg = pairs["autoreg"]
    with pytest.raises(SystemExit, match="gallery_shards=2 must divide the world size 1"):
        cli_train.main(["--experiment", "ralf", "--synthetic", "--debug", "--device", "cpu",
                        "--job-dir", str(job_root / "gs2"), "--cache-dir",
                        str(job_root / "cache"), *CLI_TINY, "train.gallery_shards=2"])
    bf16 = dataclasses.replace(tg.cfg, dtype=torch.bfloat16)
    served = TAutoreg(tg.tokenizer, bf16, "uncond", image_hw=HW, device="cpu")
    assert {t.dtype for t in served.core.state_dict().values() if t.is_floating_point()} == {
        torch.bfloat16}
    TTrainer(served, TTrainConfig(job_dir=str(job_root)))
    assert {t.dtype for t in served.core.state_dict().values() if t.is_floating_point()} == {
        torch.float32}


CLI_TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
            "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
            "generator_kwargs.top_k=4"]


def test_cli_train_checkpoint_reads_in_cli_inference_and_in_jax(job_root):
    """cli.train --synthetic --debug on the CPU writes the job dir; the
    port's cli.inference reads its checkpoint as it is; the .npz loaded as a
    numpy tree into JAX's RALF gives the port's logits."""
    from ralf_tpu import config as jconfig
    from ralf_tpu_torch.cli import inference as cli_inf
    from ralf_tpu_torch.cli import train as cli_train
    from ralf_tpu_torch.config import FrameworkConfig, build_generator, build_tokenizer

    job = job_root / "job"
    cli_train.main(["--experiment", "ralf", "--synthetic", "--debug", "--device", "cpu",
                    "--batch-size", "4", "--job-dir", str(job), "--cache-dir",
                    str(job_root / "cache"), *CLI_TINY])
    for f in ("config.json", "ckpt_final.npz", "ckpt_best.npz", "metrics.jsonl",
              "ckpt_final_opt.pt"):
        assert (job / f).exists(), f
    (rec,) = _records(job)
    assert sorted(rec) == ["epoch", "lr_scale", "sec", "train_loss", "val_loss"]
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    summary = cli_inf.main(["--job-dir", str(job), "--cond", "c", "--device", "cpu",
                            "--num-seeds", "1", "--batch-size", "16"])
    assert (job / "generated_samples_c" / "test_0.pkl").exists() and summary["ms_per_sample"]

    cfg = FrameworkConfig.load(str(job))
    tg = build_generator(cfg, build_tokenizer(cfg), device="cpu")
    params, stats = load_params_npz(str(job / "ckpt_final.npz"))
    load_jax_params(tg.core, params, stats)
    jcfg = jconfig.FrameworkConfig.load(str(job))  # JAX reads the port's config.json
    jg = jconfig.build_generator(jcfg, jconfig.build_tokenizer(jcfg))
    train_ds = tdata.SyntheticPosterDataset(cfg.dataset, size=64, seed=0)
    loader = twrap.RetrievalAugmentedLoader(
        tdata.BatchLoader(train_ds, 2, shuffle=False, use_native=False),
        tret.Retriever.build(train_ds, device="cpu"), 4)
    inputs, _ = tg.preprocess(next(iter(loader)), np.random.default_rng(0))
    with torch.no_grad():
        got = tg.logits(inputs).numpy()
    j_in = {k: (jax.tree.map(lambda t: jnp.asarray(t.numpy()), v) if isinstance(v, dict)
                else jnp.asarray(v.numpy())) for k, v in inputs.items()}
    want = jg.core.apply({"params": params, "batch_stats": stats}, j_in["seq"], j_in["image"],
                         j_in["retrieved"], j_in["const_seq"], j_in["const_keep"],
                         j_in["tgt_keep"], False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
