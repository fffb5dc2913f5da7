"""Training MaskGIT in the port against the JAX package, on the CPU, and
the helpers that hold every zoo preset's training so (the diffusion
presets' files, `test_torch_port_diffusion_train.py` and
`test_torch_port_layoutdm_ra_train.py`, call them): each preprocess's numpy
side, each loss and its terms given JAX's draws, a three-step `Trainer.fit`
against JAX's, and `cli.train --debug` whose checkpoint both packages'
`cli.inference` read.  Here also the diffusion's draw and its pieces that
need no model: the Gumbel-max draw given JAX's uniforms, the port's
uniforms by their law and the auxiliary weight's jitted arithmetic.

Models are tiny (d_model 32, 4 heads, 1+1 layers, resnet18, 64x48
canvases, 12 diffusion timesteps, top-4 retrieval, dropout 0), initialised
in JAX and loaded into the port through the weights bridge; both run in
float32.  JAX draws the training noise from `jax.random` (MaskGIT's mask
positions, the diffusion's Gumbel uniforms), which torch cannot reproduce:
the `jax_draws` fixture replaces the port's draw functions with JAX's draws
for the same seed, and the port's own draws are held by their law.

Tolerances: preprocess outputs exactly; losses and their terms rtol 1e-5;
`sample_time` and `update_importance` bit for bit; trajectories by
`tests/test_torch_port_train.py::assert_same_training` (losses rtol 2e-4,
each subtree's update by cosine > 0.99 and norm ratio 0.97-1.03, the
frozen towers unchanged on both sides); pickles from the two CLIs equal
(deterministic sampling).
"""

import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_port_train import _records, assert_same_training

from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.core import mask as jmask
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import diffusion as jdiff
from ralf_tpu.parallel.mesh import replicate
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu.retrieval import wrapper as jwrap
from ralf_tpu.train import optim as joptim
from ralf_tpu.train.trainer import Trainer as JTrainer
from ralf_tpu.train.trainer import TrainState as JTrainState
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.cli import train as tcli_train
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import diffusion as tdiff
from ralf_tpu_torch.models import maskgit as tmg
from ralf_tpu_torch.retrieval import retriever as tret
from ralf_tpu_torch.retrieval import wrapper as twrap
from ralf_tpu_torch.train.trainer import Trainer as TTrainer
from ralf_tpu_torch.utils.weights import export_params, load_jax_params, load_params_npz

torch.set_num_threads(2)
RTOL = 1e-5
HW, BATCH, TOP_K, T_STEPS = (64, 48), 8, 4, 12  # 8: one canvas per device of JAX's CPU mesh
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        "model.dropout=0.0", f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}",
        "debug=true", "synthetic_data=true", "sampling.name=deterministic",
        "sampling.temperature=0.0"]
DIFFUSION = [f"generator_kwargs.num_timesteps={T_STEPS}", f"generator_kwargs.top_k={TOP_K}"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def overrides(preset: str, cache_dir: str) -> list:
    extra = [] if preset == "maskgit" else DIFFUSION
    return TINY + extra + [f"cache_dir={cache_dir}"]


def kmeans_cache(cache_dir: str, seed: int = 3) -> None:
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
    kmeans_cache(d)
    return d


_PAIRS: dict = {}  # one pair of generators per preset and process


def pair(preset: str, cache_dir: str):
    """(JAX generator, its initial variables, port generator, JAX config, port config)"""
    if preset not in _PAIRS:
        over = overrides(preset, cache_dir)
        jcfg, tcfg = jconfig.build_config(preset, over), tconfig.build_config(preset, over)
        jg = jconfig.build_generator(jcfg, jconfig.build_tokenizer(jcfg))
        tg = tconfig.build_generator(tcfg, tconfig.build_tokenizer(tcfg), device="cpu")
        _PAIRS[preset] = (jg, _np(jg.init(jax.random.PRNGKey(0))), tg, jcfg, tcfg)
    return _PAIRS[preset]


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's training draws replaced by JAX's for the same seed: MaskGIT's
    mask (`sample_mask` under PRNGKey(seed)) and the diffusion's uniforms
    (`uniform` under fold_in(PRNGKey(0), seed))."""
    def loss_mask(ratio, T, seed):
        r = jnp.asarray(_host(ratio))
        m = jmask.sample_mask(jax.random.PRNGKey(seed), jnp.ones((r.shape[0], T), bool), r)
        return torch.from_numpy(np.array(m)).to(ratio.device)

    def uniforms(shape, seed, device):
        key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.uint32(seed))
        return torch.from_numpy(np.array(jax.random.uniform(key, shape))).to(device)

    monkeypatch.setattr(tmg, "draw_loss_mask", loss_mask)
    monkeypatch.setattr(tdiff, "gumbel_uniforms", uniforms)


@pytest.fixture
def job_root(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def loaders(pkg: str, cfg, retrieval: bool, shuffle: bool = True):
    """Fresh (train, val) loaders of one package over the preset's debug
    splits (64/16 canvases), seeded alike; with retrieval, each canvas's
    top-k from the train split."""
    data, ret, wrap = (jdata, jret, jwrap) if pkg == "jax" else (tdata, tret, twrap)
    train, val, _ = (jconfig if pkg == "jax" else tconfig).build_datasets(cfg)
    kw = dict(transforms=cfg.transforms, use_native=False, prefetch=0, seed=0)
    tl = data.BatchLoader(train, BATCH, shuffle=shuffle, **kw)
    vl = data.BatchLoader(val, BATCH, shuffle=False, **kw)
    if retrieval:
        retriever = (ret.Retriever.build(train) if pkg == "jax"
                     else ret.Retriever.build(train, device="cpu"))
        tl = wrap.RetrievalAugmentedLoader(tl, retriever, TOP_K, is_train_split=True)
        vl = wrap.RetrievalAugmentedLoader(vl, retriever, TOP_K)
    return tl, vl


def first_batches(zoo_entry):
    """One train batch of each package, the same canvases."""
    jg, _, tg, jcfg, tcfg = zoo_entry
    ra = getattr(tg, "with_retrieval", False)
    return (next(iter(loaders("jax", jcfg, ra, shuffle=False)[0])),
            next(iter(loaders("port", tcfg, ra, shuffle=False)[0])))


# ---- Trainer.fit on both sides ----------------------------------------------------

_JAX_STEPS: dict = {}  # one compiled train and eval step per model, for every run


def run_jax(name, jg, v, job_dir, train_val, cap, **cfg):
    """JAX's Trainer.fit from the shared initial state: (final params,
    batch_stats, per-step losses, metrics.jsonl records, batch_stats after
    the first step)."""
    from ralf_tpu.train.trainer import TrainConfig as JTrainConfig

    tr = JTrainer(jg, JTrainConfig(job_dir=str(job_dir), batch_size=BATCH, **cfg))
    if name not in _JAX_STEPS:
        tr.tx = joptim.build_optimizer(v["params"], base_lr=tr.cfg.lr,
                                       weight_decay=tr.cfg.weight_decay,
                                       clip_max_norm=tr.cfg.clip_max_norm)
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
        params=params, batch_stats=jax.tree.map(jnp.asarray, v.get("batch_stats", {})),
        opt_state=tr.tx.init(params), step=jnp.zeros((), jnp.int32)))
    state = tr.fit(*train_val, state=state, num_steps_cap=cap)
    return _np(state.params), _np(state.batch_stats), losses, _records(job_dir), first


def run_port(tg, v, job_dir, train_val, cap, on_step=None, **cfg):
    """The port's Trainer.fit from the same initial state; `on_step(trainer,
    metrics)` sees each train step's output."""
    from ralf_tpu_torch.train.trainer import TrainConfig as TTrainConfig

    tr = TTrainer(tg, TTrainConfig(job_dir=str(job_dir), batch_size=BATCH, **cfg))
    load_jax_params(tg.core, v["params"], v.get("batch_stats"))  # into the trained (fp32) core
    losses, first = [], []
    step = tr.train_step

    def recorded(*args):
        metrics = step(*args)
        losses.append(float(metrics["loss"]))
        first.extend([] if first else [export_params(tg.core)[1]])
        if on_step is not None:
            on_step(args[0], metrics)
        return metrics

    tr.train_step = recorded
    tr.fit(*train_val, num_steps_cap=cap)
    params, stats = export_params(tg.core)
    return params, stats, losses, _records(job_dir), first


def assert_frozen(init, *afters, path=("retrieval_aug", "layout_encoder")):
    """The subtree at `path` equals its initial values in every run."""
    def sub(tree):
        for k in path:
            tree = tree[k]
        return tree

    for after in afters:
        for a, b in zip(jax.tree.leaves(sub(after)), jax.tree.leaves(sub(init)), strict=True):
            np.testing.assert_array_equal(a, b)


# ---- the checks each preset's file runs ------------------------------------------


def check_preprocess(entry) -> None:
    """Same batch, same numpy seed (and MaskGIT's mask drawn as JAX draws
    it from the seed the rng gave): every output equal, the element-count
    EMA updated alike, and the rng left at the same point."""
    jg, _, tg, _, _ = entry
    jb, tb = first_batches(entry)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    (ji, jt), (ti, tt) = jg.preprocess(jb, jr), tg.preprocess(tb, tr)
    assert sorted(ji) == sorted(ti) and sorted(jt) == sorted(tt)
    for k in ji:
        if k == "retrieved":
            for r in ji[k]:
                np.testing.assert_array_equal(_host(ti[k][r]), ji[k][r], err_msg=r)
        else:
            np.testing.assert_array_equal(_host(ti[k]), np.asarray(ji[k]), err_msg=k)
    for k in jt:
        np.testing.assert_array_equal(_host(tt[k]), np.asarray(jt[k]), err_msg=k)
    np.testing.assert_array_equal(tg.seq_dist.n_elements_prob, jg.seq_dist.n_elements_prob)
    assert jr.integers(2**31) == tr.integers(2**31)
    if isinstance(tg, tmg.MaskGITGenerator):  # the masked tokens are MASK, the rest the target
        mask = _host(tt["loss_mask"])
        assert mask.any() and (~mask).any()
        assert (_host(ti["seq"])[mask] == tg.mask_id).all()
        np.testing.assert_array_equal(_host(ti["seq"])[~mask], _host(tt["seq"])[~mask])


def check_loss(entry, train: bool) -> None:
    """The loss and each term of the aux given JAX's draws, in eval mode (K1's
    plain version in the encoders) or in train mode (dropout 0, the einsum
    path); a diffusion batch holds t = 0 samples (the decoder NLL,
    q_posterior's wrap) and the last step."""
    jg, v, tg, _, _ = entry
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    jb, tb = first_batches(entry)
    (ji, jt), (ti, tt) = jg.preprocess(jb, np.random.default_rng(7)), tg.preprocess(
        tb, np.random.default_rng(7))
    diffusion = hasattr(tg, "diffusion")
    if diffusion:
        t = np.asarray([0, 3, T_STEPS - 1, 0, 5, 7, 1, 0], np.int32)
        ji = {**ji, "t": t}
        ti = {**ti, "t": torch.from_numpy(t).long()}
    want, jaux = jg.loss(v, jax.tree.map(jnp.asarray, ji), jax.tree.map(jnp.asarray, jt),
                         train=train, rngs={"dropout": jax.random.PRNGKey(1)})
    tg.core.train(train)
    with torch.no_grad():
        got, taux = tg.loss(ti, tt)
    tg.core.eval()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert sorted(taux) == sorted(k for k in jaux if k != "state")
    for k in taux:
        np.testing.assert_allclose(_host(taux[k]), np.asarray(jaux[k]), rtol=RTOL, err_msg=k)
    if diffusion:
        assert taux["kl_per_sample"].shape == (BATCH,)


def check_fit(preset: str, entry, job_root) -> None:
    """Three train steps and the two validation batches of one epoch on
    both sides: losses, updates, BatchNorm statistics and metrics.jsonl
    (`assert_same_training`); RA-LayoutDM's FIDNet unchanged on both sides.
    The trainer calls no generator hook, as in JAX: the timesteps stay
    uniform; each preprocess, validation batches included, updates the
    element-count EMA."""
    jg, v, tg, jcfg, tcfg = entry
    ra = getattr(tg, "with_retrieval", False)
    j = run_jax(preset, jg, v, job_root / "jax", loaders("jax", jcfg, ra), 3, epochs=1)
    ema0 = tg.seq_dist.n_elements_prob.copy()
    t = run_port(tg, v, job_root / "port", loaders("port", tcfg, ra), 3, epochs=1)
    assert_same_training(j, t, v, 3)
    if ra:
        assert_frozen(v["params"], j[0], t[0])
    assert not (ema0 == tg.seq_dist.n_elements_prob).all()
    if hasattr(tg, "diffusion"):
        assert not tg.Lt_count.any() and not jg.Lt_count.any()


# ---- the diffusion's pieces ---------------------------------------------------------------


def test_log_sample_categorical_given_the_uniforms_equals_jax():
    """Given JAX's uniforms, the Gumbel-max draw equals JAX's token for token."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (6, 15, 21)).astype(np.float32)
    logits[0, :, 3] = 50.0  # a sure token
    key = jax.random.PRNGKey(11)
    diff = jdiff.MaskAndReplaceDiffusion.__new__(jdiff.MaskAndReplaceDiffusion)
    diff.V = 21
    want = diff.log_sample_categorical(key, jnp.asarray(logits))
    u = torch.from_numpy(np.array(jax.random.uniform(key, logits.shape)))
    port = tdiff.MaskAndReplaceDiffusion.__new__(tdiff.MaskAndReplaceDiffusion)
    port.V = 21
    got = port.log_sample_categorical(u, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.argmax(-1)[0] == 3).all()


def test_port_gumbel_draws_follow_the_categorical_law():
    """The port's own uniforms: each position's token falls on each class at
    its softmax probability (within 5 standard deviations over 4000 draws)."""
    port = tdiff.MaskAndReplaceDiffusion.__new__(tdiff.MaskAndReplaceDiffusion)
    port.V = 5
    logits = torch.log(torch.tensor([0.5, 0.25, 0.15, 0.07, 0.03]))
    u = tdiff.gumbel_uniforms((4000, 1, 5), 123, "cpu")
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    idx = port.log_sample_categorical(u, logits.expand(4000, 1, 5)).argmax(-1).ravel()
    freq = torch.bincount(idx, minlength=5).double() / 4000
    p = logits.exp().double()
    assert ((freq - p).abs() <= 5 * (p * (1 - p) / 4000).sqrt()).all(), (freq, p)
    assert not torch.equal(u, tdiff.gumbel_uniforms((4000, 1, 5), 124, "cpu"))


def test_trap_aux_weight_follows_the_jitted_division():
    """`(1 - t / T) + 1` in the auxiliary weight, int32 / int under jax.jit,
    equals `aux_weight` at every t of T = 50, 12 and 7; fp32's true division
    and its two roundings miss it (Queue C 42's pattern)."""
    for T in (50, 12, 7):
        t = np.arange(T, dtype=np.int32)
        want = np.asarray(jax.jit(lambda t: (1 - t / T) + 1.0)(jnp.asarray(t)))
        got = tdiff.aux_weight(torch.from_numpy(t).long(), T)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        naive = (1 - torch.from_numpy(t).float() / T) + 1.0
        assert not np.array_equal(naive.numpy(), want)


# ---- MaskGIT's draw -------------------------------------------------------------------


def test_maskgit_mask_draw_keeps_its_count_and_is_uniform():
    """Each row masks exactly max(int(ratio * T), 1) positions (fp32
    product), and over many rows every position is masked at the rate the
    counts give (within 5 standard deviations)."""
    T, B = 50, 4000
    ratio = torch.from_numpy(np.random.default_rng(0).uniform(1e-6, 1, B).astype(np.float32))
    ratio[:3] = torch.tensor([1e-6, 1.0, 0.5])
    mask = tmg.draw_loss_mask(ratio, T, 77)
    want = np.maximum((ratio.numpy() * np.float32(T)).astype(np.int32), 1)
    np.testing.assert_array_equal(mask.sum(1).numpy(), want)
    assert want[0] == 1 and want[1] == T
    share = float(want.sum()) / (B * T)
    freq = mask.double().mean(0)
    assert ((freq - share).abs() <= 5 * (share * (1 - share) / B) ** 0.5).all()
    assert not torch.equal(mask, tmg.draw_loss_mask(ratio, T, 78))


# ---- cli.train -> cli.inference, in both packages ------------------------------------------


def _run_jax(main, argv):
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        main()
    finally:
        sys.argv = old


def write_jax_checkpoint(job: str, tag: str = "final") -> None:
    """JAX's orbax checkpoint `ckpt_<tag>/` of the port's `ckpt_<tag>.npz`:
    the flax tree as it is, in a TrainState that JAX's `Trainer.restore`
    reads (a fresh optimizer state: inference reads none)."""
    cfg = jconfig.FrameworkConfig.load(job)
    params, stats = load_params_npz(os.path.join(job, f"ckpt_{tag}.npz"))
    trainer = JTrainer(jconfig.build_generator(cfg, jconfig.build_tokenizer(cfg)), cfg.train)
    state = trainer.init_state(jax.random.PRNGKey(0))
    flat = flatten_dict(jax.device_get(state.params), sep="/")
    assert sorted(flat) == sorted(flatten_dict(params, sep="/"))  # the same tree, leaf by leaf
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    trainer.save(state, tag)


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def check_cli(preset: str, cache_dir: str, job_root, cond: str = "c") -> None:
    """cli.train --synthetic --debug on the CPU writes the job dir; its
    ckpt_final.npz serves the port's cli.inference as it is and, as JAX's
    checkpoint of the same tree, JAX's: with deterministic sampling the
    pickles are equal."""
    job = str(job_root / "job")
    tcli_train.main(["--experiment", preset, "--synthetic", "--debug", "--device", "cpu",
                     "--batch-size", "8", "--job-dir", job, "--cache-dir", cache_dir,
                     *overrides(preset, cache_dir)])
    for f in ("config.json", "ckpt_final.npz", "ckpt_best.npz", "metrics.jsonl",
              "ckpt_final_opt.pt"):
        assert os.path.exists(os.path.join(job, f)), f
    (rec,) = _records(job_root / "job")
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    write_jax_checkpoint(job)
    args = ["--job-dir", job, "--cond", cond, "--num-seeds", "1", "--batch-size", "8"]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    summary = tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    want, got = _pickle(f"{job}/jax/test_0.pkl"), _pickle(f"{job}/port/test_0.pkl")
    assert summary["ms_per_sample"] and len(got["results"]) == 16 and got == want


# ---- MaskGIT -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def maskgit(cache_dir):
    return pair("maskgit", cache_dir)


def test_maskgit_preprocess_matches_jax(maskgit, jax_draws):
    check_preprocess(maskgit)


@pytest.mark.parametrize("train", [False, True])
def test_maskgit_loss_matches_jax_given_its_mask(maskgit, jax_draws, train):
    check_loss(maskgit, train)


def test_maskgit_three_step_fit_matches_jax(maskgit, jax_draws, job_root):
    check_fit("maskgit", maskgit, job_root)


def test_maskgit_cli_train_checkpoint_reads_in_both_cli_inferences(cache_dir, job_root):
    check_cli("maskgit", cache_dir, job_root)


def test_trap_maskgit_ignores_its_unmasked_positions(maskgit):
    """JAX's sentinel target -1 marks the positions outside the mask, an
    ignore index and not a class: the loss reads the masked positions only
    (changing an unmasked target leaves it), over their count, and a batch
    with no masked position gives 0, not a division by zero."""
    _, v, tg, _, _ = maskgit
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    _, tb = first_batches(maskgit)
    inputs, targets = tg.preprocess(tb, np.random.default_rng(3))
    with torch.no_grad():
        base = float(tg.loss(inputs, targets)[0])
        other = dict(targets, seq=torch.where(targets["loss_mask"], targets["seq"],
                                              (targets["seq"] + 1) % tg.mask_id))
        assert float(tg.loss(inputs, other)[0]) == base
        none = dict(targets, loss_mask=torch.zeros_like(targets["loss_mask"]))
        assert float(tg.loss(inputs, none)[0]) == 0.0
