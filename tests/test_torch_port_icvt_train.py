"""Training ICVT in the port against the JAX package, on the CPU: the
preprocess, the posterior encoder and the teacher-forced pass given JAX's
eps, the loss and its terms, the cyclical KL beta, the port's eps by its
law, the clip over every gradient (the frozen `layout_encoder`'s too), a
three-step `Trainer.fit` against JAX's with the clip active, `cli.train
--debug` whose checkpoint both packages' `cli.inference` read, and K1's
plain version at the GA encoder's shape against Pallas.

The model is tiny (d_model 40, a multiple of 4 and 5 as ICVT needs; 4 heads
in the image encoder, 1+1 layers, resnet18, 64x48 canvases, dropout 0),
initialised in JAX and loaded into the port through the weights bridge;
both run in float32.  JAX draws the posterior's eps from `jax.random`: the
`jax_eps` fixture replaces the port's `seeded_normal` with JAX's draw for
the same seed.  ICVT's GT-layout embedding is named `layout_encoder`, which
JAX's optimizer freezes by name (a JAX-side trap the port follows), yet its
gradient is not zero and counts in the clip's norm.

Tolerances: preprocess exactly; mu and logvar within 1e-5 absolute + 1e-5
relative, the logits (up to 20 in size) 1e-4 + 1e-4, as
`test_torch_port_icvt.py` holds them; losses and terms rtol 1e-5; the betas
exactly; the clipped
gradients against optax over the same gradients rtol 1e-6; trajectories by
`assert_same_training`; the CLIs' pickles by form (the sample's latent is
a draw of each package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_train import assert_same_training
from test_torch_port_zoo_train import (  # noqa: F401  (fixtures)
    BATCH,
    HW,
    _host,
    _np,
    _pickle,
    _run_jax,
    job_root,
    loaders,
    run_jax,
    run_port,
    write_jax_checkpoint,
)

from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.ops.pallas.encoder_attention import fused_encoder_attention
from ralf_tpu.train import optim as joptim
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.cli import train as tcli_train
from ralf_tpu_torch.models import icvt as ticvt
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.ops import encoder_attention as ea
from ralf_tpu_torch.train.optim import lr_group_labels
from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
from ralf_tpu_torch.utils.weights import flax_names, load_jax_params, load_params_npz

torch.set_num_threads(2)
RTOL = 1e-5
TINY = ["model.d_model=40", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.backbone=resnet18", "model.dropout=0.0",
        f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}", "debug=true",
        "synthetic_data=true"]
ATTRS = ("label", "center_x", "center_y", "width", "height")


def jax_eps_draw(shape, seed):
    return jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(17), jnp.uint32(seed)), shape)


@pytest.fixture(scope="module")
def icvt():
    """(JAX generator, its initial variables, port generator, JAX config, port config)"""
    jcfg, tcfg = jconfig.build_config("icvt", TINY), tconfig.build_config("icvt", TINY)
    jg = jconfig.build_generator(jcfg, None)
    tg = tconfig.build_generator(tcfg, None, device="cpu")
    return jg, _np(jg.init(jax.random.PRNGKey(0))), tg, jcfg, tcfg


@pytest.fixture
def jax_eps(monkeypatch):
    """The port's N(0, I) draws replaced by JAX's eps for the same seed."""
    monkeypatch.setattr(ticvt, "seeded_normal", lambda shape, seed, device: torch.from_numpy(
        np.array(jax_eps_draw(shape, seed))).to(device))


def batches(entry, seed=3):
    """(JAX inputs, targets), (port inputs, targets) of one train batch from one numpy seed."""
    jg, _, tg, jcfg, tcfg = entry
    jb = next(iter(loaders("jax", jcfg, False, shuffle=False)[0]))
    tb = next(iter(loaders("port", tcfg, False, shuffle=False)[0]))
    return (jg.preprocess(jb, np.random.default_rng(seed)),
            tg.preprocess(tb, np.random.default_rng(seed)))


def _jin(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_preprocess_matches_jax(icvt):
    """The ids (BG for padding), the mask and the image exactly; the seed is
    the rng's next integer on both sides."""
    (ji, jt), (ti, tt) = batches(icvt)
    assert sorted(ji) == sorted(ti) and sorted(jt) == sorted(tt) == sorted(ATTRS)
    for k in ji:
        np.testing.assert_array_equal(_host(ti[k]), np.asarray(ji[k]), err_msg=k)
    for k in jt:
        np.testing.assert_array_equal(_host(tt[k]), np.asarray(jt[k]), err_msg=k)
    assert (_host(ti["label"]) == 3).any() and _host(ti["mask"]).any()  # BG and elements


def test_posterior_and_teacher_forced_pass_match_jax_given_eps(icvt):
    """encode_posterior (the GA encoder with the layout's key mask, K1's plain
    version in eval mode; the pooling by the learnable token) and the
    teacher-forced decode whose GA query is the PE'd shifted target."""
    jg, v, tg, _, _ = icvt
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    (ji, _), (ti, _) = batches(icvt)
    ids = {k: ji[k] for k in (*ATTRS, "mask")}
    key = jax.random.PRNGKey(4)
    (jout, jmu, jlv) = jg.core.apply(v, _jin(ids), jnp.asarray(ji["image"]), key, False)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (BATCH, 1, 40))))
    with torch.no_grad():
        out, mu, logvar = tg.core({k: ti[k] for k in (*ATTRS, "mask")}, ti["image"], eps)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlv), rtol=RTOL, atol=1e-5)
    for k in ATTRS:
        assert out[k].shape == jout[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_loss_and_terms_match_jax_given_its_eps(icvt, jax_eps, train):
    """Each attribute's cross-entropy, the KL and the total (kl_mult * kl_beta
    weighting the KL), in eval mode and in train mode (dropout 0)."""
    jg, v, tg, _, _ = icvt
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    (ji, jt), (ti, tt) = batches(icvt)
    want, jaux = jg.loss(v, _jin(ji), _jin(jt), train=train,
                         rngs={"dropout": jax.random.PRNGKey(1)})
    tg.core.train(train)
    with torch.no_grad():
        got, taux = tg.loss(ti, tt)
    tg.core.eval()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert sorted(taux) == sorted(k for k in jaux if k != "state")
    for k in taux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=RTOL, err_msg=k)
    assert float(taux["loss_kl"]) > 0


def test_update_per_epoch_gives_jax_betas(icvt):
    """The 2-cycle KL beta at every epoch of a few schedules, exactly."""
    jg, _, tg, _, _ = icvt
    try:
        for max_epoch in (1, 2, 7, 50, 300):
            for epoch in range(max_epoch + 2):
                jg.update_per_epoch(epoch, 0, max_epoch)
                tg.update_per_epoch(epoch, 0, max_epoch)
                assert tg.kl_beta == jg.kl_beta, (max_epoch, epoch)
    finally:
        jg.kl_beta = tg.kl_beta = 1e-3
    betas = set()
    for epoch in range(50):
        tg.update_per_epoch(epoch, 0, 50)
        betas.add(tg.kl_beta)
    tg.kl_beta = 1e-3
    assert min(betas) == 0.001 and max(betas) == 0.3 and len(betas) > 3  # the ramp too


def test_port_eps_by_its_law():
    """seeded_normal: 4096 x 40 draws with mean within 5 standard errors of 0
    and variance within 2% of 1; a seed gives its draws again, another seed others."""
    z = ticvt.seeded_normal((4096, 1, 40), 5, "cpu")
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n**0.5 and abs(float(z.var()) - 1.0) < 0.02
    assert torch.equal(z, ticvt.seeded_normal((4096, 1, 40), 5, "cpu"))
    assert not torch.equal(z, ticvt.seeded_normal((4096, 1, 40), 6, "cpu"))


# ---- the clip over every gradient --------------------------------------------------------


def _tree(core, arrays: dict) -> dict:
    """{torch name: array} as a nested dict by each parameter's flax path."""
    out: dict = {}
    for name, path in flax_names(core).items():
        if name in arrays:
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = arrays[name]
    return out


def _leaf(tree: dict, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def test_clip_counts_the_frozen_layout_encoder_gradient(icvt, jax_eps, job_root):
    """One train step: the clip scales by 1 / the norm of every gradient,
    the frozen `layout_encoder`'s included, as optax.chain(clip_by_global_norm,
    multi_transform) does over the same gradients; the step leaves
    `layout_encoder` unchanged, as it does in JAX."""
    jg, v, tg, _, _ = icvt
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    (ji, jt), (ti, tt) = batches(icvt)
    trainer = Trainer(tg, TrainConfig(job_dir=str(job_root)))
    state = trainer.init_state()
    core = tg.core
    names = [n for n, _ in core.named_parameters()]
    labels = lr_group_labels(core)
    before = {n: p.detach().clone() for n, p in core.named_parameters()}

    # the raw gradient of every leaf, taken apart from the trainer's step
    flags = [p.requires_grad for p in core.parameters()]
    for p in core.parameters():
        p.requires_grad_(True)
    core.train()
    raw = torch.autograd.grad(tg.loss(ti, tt)[0], list(core.parameters()), allow_unused=True)
    for p, f in zip(core.parameters(), flags):
        p.requires_grad_(f)
    raw = {n: (torch.zeros_like(before[n]) if g is None else g).numpy() for n, g in zip(names, raw)}
    frozen = [n for n in names if labels[n] == "frozen"]
    assert frozen and all(n.startswith("layout_encoder.") for n in frozen)
    norm2 = {k: sum(float((raw[n].astype(np.float64) ** 2).sum()) for n in names
                    if (labels[n] == "frozen") == (k == "frozen")) for k in ("frozen", "rest")}
    assert norm2["frozen"] + norm2["rest"] > 1.0  # the clip is active
    assert norm2["frozen"] / norm2["rest"] > 1e-3  # and the frozen leaves move its factor

    grads, params = _tree(core, raw), _tree(core, {n: t.numpy() for n, t in before.items()})
    # jitted: eager, each of optax's per-leaf ops compiles on its own
    clipped = jax.jit(lambda g: optax.clip_by_global_norm(1.0).update(g, optax.EmptyState())[0])(
        grads)
    tx = joptim.build_optimizer(params, base_lr=1e-4, weight_decay=0.01, clip_max_norm=1.0)
    updates = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(grads, params)

    trainer.train_step(state, ti, tt)
    paths = flax_names(core)
    for n, p in core.named_parameters():
        if labels[n] == "frozen":
            assert torch.equal(p, before[n]), n
            assert not np.asarray(_leaf(updates, paths[n])).any()
        else:
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(_leaf(clipped, paths[n])),
                                       rtol=1e-6, atol=0, err_msg=n)

    # JAX's own step: its gradient has the same global norm, and its update
    # leaves layout_encoder as it was
    def loss_fn(p):
        return jg.loss({"params": p, "batch_stats": v["batch_stats"]}, _jin(ji), _jin(jt),
                       train=True, rngs={"dropout": jax.random.PRNGKey(1)})[0]

    jgrads = jax.jit(jax.grad(loss_fn))(_jin(v["params"]))
    jnorm, jfrozen = jax.jit(lambda g: (optax.global_norm(g), optax.global_norm(
        g["layout_encoder"])))(jgrads)
    np.testing.assert_allclose(float(jnorm), (norm2["frozen"] + norm2["rest"]) ** 0.5, rtol=1e-4)
    np.testing.assert_allclose(float(jfrozen), norm2["frozen"] ** 0.5, rtol=1e-4)
    jtx = joptim.build_optimizer(v["params"])
    after = jax.jit(lambda g, p: optax.apply_updates(p, jtx.update(g, jtx.init(p), p)[0]))(
        jgrads, _jin(v["params"]))
    for a, b in zip(jax.tree.leaves(after["layout_encoder"]),
                    jax.tree.leaves(v["params"]["layout_encoder"])):
        np.testing.assert_array_equal(np.asarray(a), b)


# ---- Trainer.fit, the CLIs, K1 -----------------------------------------------------------


def test_three_step_fit_matches_jax_with_the_clip_active(icvt, jax_eps, job_root):
    """Three train steps and two validation batches on both sides
    (`assert_same_training`: `layout_encoder` unchanged on both); every
    step's global norm exceeds 1, so each one clips; kl_beta stays 1e-3 on
    both sides, as no trainer calls update_per_epoch."""
    jg, v, tg, jcfg, tcfg = icvt
    j = run_jax("icvt", jg, v, job_root / "jax", loaders("jax", jcfg, False), 3, epochs=1)
    norms = []

    def clipped_norm(state, metrics):  # after the step the gradients hold the clipped ones
        opt = state.optimizer
        grads = [p.grad for p in opt.params + opt.frozen if p.grad is not None]
        norms.append(float(torch.nn.utils.get_total_norm(grads)))

    t = run_port(tg, v, job_root / "port", loaders("port", tcfg, False), 3, on_step=clipped_norm,
                 epochs=1)
    assert_same_training(j, t, v, 3)
    assert "layout_encoder" in v["params"]
    # a clipped step's norm is max_norm 1 over the trainable leaves and the
    # frozen ones; the frozen ones are not scaled, so it sits a hair above
    assert len(norms) == 3 and all(1.0 - 1e-6 < n for n in norms), norms
    assert tg.kl_beta == jg.kl_beta == 1e-3


def test_train_and_eval_steps_take_k1_only_in_eval_mode(icvt, jax_eps, job_root, monkeypatch):
    """The train step's encoders take the einsum path (no K1); the eval step
    takes K1 in the image encoder's and the GA encoder's self-attention
    (1 + 1 layers; the GA encoder's with the layout's key mask) and in no
    causal or cross-attention."""
    _, v, tg, _, _ = icvt
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    calls = []
    launch = tnn.encoder_attention
    monkeypatch.setattr(tnn, "encoder_attention",
                        lambda *a: calls.append(a[4] is not None) or launch(*a))
    trainer = Trainer(tg, TrainConfig(job_dir=str(job_root)))
    state = trainer.init_state()
    _, (ti, tt) = batches(icvt)
    trainer.train_step(state, ti, tt)
    assert calls == []
    trainer.eval_step(state, ti, tt)
    assert sorted(calls) == [False, True]  # the image encoder's unmasked, the GA encoder's masked


def test_cli_train_checkpoint_reads_in_both_cli_inferences(icvt, jax_eps, job_root):
    """cli.train --debug on the CPU writes the job dir; the port's
    cli.inference --cond uncond serves ckpt_final.npz and JAX's serves the
    same tree (pickles of the same form: the latent is each package's own
    draw); the tree in JAX's ICVT gives the port's eval loss."""
    jg, _, tg, _, _ = icvt
    job = str(job_root / "job")
    tcli_train.main(["--experiment", "icvt", "--synthetic", "--debug", "--device", "cpu",
                     "--batch-size", "8", "--job-dir", job, *TINY])
    write_jax_checkpoint(job)
    args = ["--job-dir", job, "--cond", "uncond", "--num-seeds", "1", "--batch-size", "8"]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    want, got = _pickle(f"{job}/jax/test_0.pkl"), _pickle(f"{job}/port/test_0.pkl")
    assert sorted(got) == sorted(want) and len(got["results"]) == len(want["results"]) == 16
    for g, w in zip(got["results"], want["results"]):
        assert sorted(g) == sorted(w) and g["id"] == w["id"]
        assert all(0.0 <= x <= 1.0 for k in ("center_x", "center_y", "width", "height")
                   for x in g[k])

    params, stats = load_params_npz(f"{job}/ckpt_final.npz")
    variables = {"params": _jin(params), "batch_stats": _jin(stats)}
    load_jax_params(tg.core, params, stats)
    (ji, jt), (ti, tt) = batches(icvt)
    want_loss, _ = jg.loss(variables, _jin(ji), _jin(jt), train=False)
    with torch.no_grad():
        got_loss, _ = tg.loss(ti, tt)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_at_the_ga_encoder_shape_matches_pallas(dtype):
    """K1's plain version at the GA encoder's self-attention (B=2, S=10, E=200,
    H=8, Dh=25, the layout's key mask, a row with no element) against the
    Pallas kernel in interpret mode: fp32 to 1e-5, bf16 within one rounding
    of the output (atol 1e-3, rtol 2^-7)."""
    B, S, E, H = 2, 10, 200, 8
    rng = np.random.default_rng(12)
    q = rng.normal(size=(B, S, E)).astype(np.float32) * (E // H) ** -0.5
    k, v = (rng.normal(size=(B, S, E)).astype(np.float32) for _ in range(2))
    keep = np.arange(S)[None, :] < np.asarray([[6], [0]])  # 6 elements; none
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = fused_encoder_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), H,
                                  jnp.asarray(bias), interpret=True)
    out = ea.encoder_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), H,
                               torch.from_numpy(bias))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-3, rtol=2**-7)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)
