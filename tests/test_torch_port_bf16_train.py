"""bf16 training in the port against the JAX package's, on the CPU.

`model.dtype=bfloat16` trains in both packages with fp32 parameters: flax
keeps `param_dtype` float32 and computes each module in bf16; the port's
Trainer casts the core it trains to fp32 (parameters and BatchNorm
statistics) and runs each step's forward and loss under `torch.autocast`.  The models
are the tiny ones of tests/test_torch_port_zoo_train.py (d_model 32, 4
heads, 1+1 layers, resnet18, 64x48 canvases, dropout 0, top-4 retrieval,
12 diffusion timesteps), initialised in JAX and loaded into the port
through the weights bridge after the port's Trainer is built, so that
they load into fp32 unrounded; the diffusion's uniforms are JAX's (the
`jax_draws` fixture).

Tolerances (bf16 rounds at other places in each framework, and AdamW's
first steps are about lr * sign(g), so an element whose gradient is at
bf16's noise floor steps the other way):
  * losses and val losses rtol 1e-2 (measured: 7e-5 for `ralf`, 5e-4
    for `autoreg`, 4e-4 for `layoutdm`);
  * each top-level subtree's update by cosine >= 0.95 and norm ratio
    0.9-1.1 (measured cosine 0.979-1.000, ratio 0.994-1.004), but for
    LayoutDM's image encoder cosine >= 0.9 (measured 0.933): its resnet18
    trunk's gradients sit at bf16's noise floor, where JAX's own bf16
    update is at cosine 0.81-0.97 a leaf to its fp32 update;
  * BatchNorm statistics by the change's cosine >= 0.99 and ratio
    0.97-1.03 (measured 0.99999 and 1.00004).
After each run every parameter, BatchNorm statistic and AdamW moment is
fp32, as is every array of the checkpoint, and a hooked Linear's and
Conv2d's output was bf16 in every step: the steps ran in bf16.
"""

import os

import jax
import numpy as np
import pytest
import torch
from test_torch_port_zoo_train import (  # noqa: F401  (fixtures)
    cache_dir,
    jax_draws,
    job_root,
    loaders,
    run_jax,
    run_port,
)

from ralf_tpu import config as jconfig
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import train as tcli_train
from ralf_tpu_torch.utils.weights import load_params_npz

torch.set_num_threads(2)
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        "model.dropout=0.0", "dataset.image_h=64", "dataset.image_w=48", "debug=true",
        "synthetic_data=true", "model.dtype=bfloat16"]
EXTRA = {"ralf": ["generator_kwargs.top_k=4"], "autoreg": [],
         "layoutdm": ["generator_kwargs.top_k=4", "generator_kwargs.num_timesteps=12"],
         "layoutdm_ra": ["generator_kwargs.top_k=4", "generator_kwargs.num_timesteps=12"],
         "vqdiffusion": ["generator_kwargs.num_timesteps=12"], "maskgit": [],
         "icvt": ["model.d_model=40"]}
LOSS_RTOL, COS, RATIO = 1e-2, 0.95, (0.9, 1.1)
COS_AT = {("layoutdm", "encoder"): 0.9}  # the trunk's gradients at bf16's noise floor


def overrides(preset: str, cache: str) -> list:
    return TINY + EXTRA[preset] + [f"cache_dir={cache}"]


_PAIRS: dict = {}


def bf16_pair(preset: str, cache: str):
    """(JAX generator, its initial variables, port generator, JAX config,
    port config), all at model.dtype=bfloat16."""
    if preset not in _PAIRS:
        over = overrides(preset, cache)
        jcfg, tcfg = jconfig.build_config(preset, over), tconfig.build_config(preset, over)
        jg = jconfig.build_generator(jcfg, jconfig.build_tokenizer(jcfg))
        tg = tconfig.build_generator(tcfg, tconfig.build_tokenizer(tcfg), device="cpu")
        v = jax.tree.map(np.asarray, jg.init(jax.random.PRNGKey(0)))
        _PAIRS[preset] = (jg, v, tg, jcfg, tcfg)
    return _PAIRS[preset]


def output_dtypes(module: torch.nn.Module, kinds=(torch.nn.Linear, torch.nn.Conv2d)):
    """{kind name: set of output dtypes} filled by forward hooks, and the hooks."""
    seen: dict = {}
    hooks = []
    for m in module.modules():
        if isinstance(m, kinds):
            def hook(mod, args, out, name=type(m).__name__):
                out = out[0] if isinstance(out, tuple) else out
                seen.setdefault(name, set()).add(out.dtype)
            hooks.append(m.register_forward_hook(hook))
    return seen, hooks


def assert_fp32_state(module: torch.nn.Module, optimizer) -> None:
    """Every parameter and buffer, and every AdamW moment, in fp32."""
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
    moments = [t for s in optimizer.state.values() for k, t in s.items() if k != "step"]
    assert moments and all(t.dtype == torch.float32 for t in moments)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def same_change(key, before, after_j, after_t, cos_min=COS, ratio=RATIO):
    d_j, d_t = _flat(after_j) - _flat(before), _flat(after_t) - _flat(before)
    mag = float(np.linalg.norm(d_j))
    assert mag > 0, f"{key} did not move; the test has no teeth"
    cos = float(d_j @ d_t / (mag * np.linalg.norm(d_t)))
    r = float(np.linalg.norm(d_t)) / mag
    assert cos >= cos_min and ratio[0] < r < ratio[1], (key, cos, r)


def assert_same_bf16_training(preset, j, t, init, n_steps):
    (jp, jbs, jl, jrec, _), (tp, tbs, tl, trec, _) = j, t
    assert len(jl) == len(tl) == n_steps
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[k] for r in trec], [r[k] for r in jrec], rtol=LOSS_RTOL)
    for key in init["params"]:
        if key == "layout_encoder":  # RALF's frozen tower: unmoved on both sides
            for a in (jp, tp):
                np.testing.assert_array_equal(_flat(a[key]), _flat(init["params"][key]))
            continue
        same_change(key, init["params"][key], jp[key], tp[key], COS_AT.get((preset, key), COS))
    same_change("batch_stats", init["batch_stats"], jbs, tbs, 0.99, (0.97, 1.03))


@pytest.mark.parametrize("preset", ["ralf", "autoreg", "layoutdm"])
def test_three_step_bf16_fit_matches_jax(cache_dir, jax_draws, job_root, preset):
    """Three train steps and the validation batches of one epoch, bf16 in
    both packages (see the module docstring for the tolerances)."""
    jg, v, tg, jcfg, tcfg = bf16_pair(preset, cache_dir)
    ra = preset == "ralf"
    j = run_jax(f"bf16-{preset}", jg, v, job_root / "jax", loaders("jax", jcfg, ra), 3,
                epochs=1)
    seen, hooks = output_dtypes(tg.core)
    states = []
    try:
        t = run_port(tg, v, job_root / "port", loaders("port", tcfg, ra), 3,
                     on_step=lambda state, _: states.append(state), epochs=1)
    finally:
        for h in hooks:
            h.remove()
    assert seen == {"Linear": {torch.bfloat16}, "Conv2d": {torch.bfloat16}}
    assert_fp32_state(tg.core, states[-1].optimizer.opt)
    assert_same_bf16_training(preset, j, t, v, 3)
    params, stats = load_params_npz(str(job_root / "port" / "ckpt_final.npz"))
    assert all(a.dtype == np.float32 for a in jax.tree.leaves((params, stats)))
    saved = torch.load(job_root / "port" / "ckpt_final_opt.pt", weights_only=True)
    assert all(t.dtype == torch.float32 for s in saved["optimizer"]["state"].values()
               for k, t in s.items() if k != "step")


def test_cli_train_bf16_ralf_serves_in_the_port_and_in_jax(cache_dir, job_root):
    """`ralf` at model.dtype=bfloat16 through cli.train: the fp32 checkpoint
    loads in JAX's RALF (bf16, the config the job wrote) and in the port's
    served core (cast whole to bf16), whose logits on one batch agree
    within bf16's rounding (atol 0.1 on logits of magnitude some 3)."""
    import jax.numpy as jnp

    from ralf_tpu_torch.config import FrameworkConfig, build_generator, build_tokenizer
    from ralf_tpu_torch.utils.weights import load_jax_params

    job = str(job_root / "job")
    tcli_train.main(["--experiment", "ralf", "--synthetic", "--debug", "--device", "cpu",
                     "--batch-size", "8", "--job-dir", job, "--cache-dir", cache_dir,
                     *overrides("ralf", cache_dir)])
    params, stats = load_params_npz(os.path.join(job, "ckpt_final.npz"))
    cfg = FrameworkConfig.load(job)
    tg = build_generator(cfg, build_tokenizer(cfg), device="cpu")  # served: cast whole
    assert {p.dtype for p in tg.core.parameters()} == {torch.bfloat16}
    load_jax_params(tg.core, params, stats)
    jcfg = jconfig.FrameworkConfig.load(job)
    jg = jconfig.build_generator(jcfg, jconfig.build_tokenizer(jcfg))
    loader = loaders("port", tconfig.build_config("ralf", overrides("ralf", cache_dir)), True,
                     shuffle=False)[1]
    inputs, _ = tg.preprocess(next(iter(loader)), np.random.default_rng(0))
    with torch.no_grad():
        got = tg.logits(inputs).float().numpy()
    j_in = {k: (jax.tree.map(lambda t: jnp.asarray(t.numpy()), x) if isinstance(x, dict)
                else jnp.asarray(x.numpy())) for k, x in inputs.items()}
    apply = jax.jit(lambda v, *a: jg.core.apply(v, *a, False))
    want = apply({"params": params, "batch_stats": stats}, j_in["seq"], j_in["image"],
                 j_in["retrieved"], j_in["const_seq"], j_in["const_keep"], j_in["tgt_keep"])
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=0.1, rtol=0)


def test_training_core_keeps_fp32_where_serving_casts_whole(cache_dir, job_root):
    """A generator built at bf16 is cast whole, as it serves; the Trainer
    casts its core to fp32, every parameter and statistic, and JAX's fp32
    values then load into it unrounded."""
    from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
    from ralf_tpu_torch.utils.weights import export_params, load_jax_params

    _, v, _, _, tcfg = bf16_pair("ralf", cache_dir)
    tg = tconfig.build_generator(tcfg, tconfig.build_tokenizer(tcfg), device="cpu")
    assert {t.dtype for t in tg.core.state_dict().values() if t.is_floating_point()} == {
        torch.bfloat16}
    Trainer(tg, TrainConfig(job_dir=str(job_root / "t")))
    assert {t.dtype for t in tg.core.state_dict().values() if t.is_floating_point()} == {
        torch.float32}
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    params, stats = export_params(tg.core)
    for a, b in zip(jax.tree.leaves((params, stats)), jax.tree.leaves((v["params"],
                                                                        v["batch_stats"]))):
        np.testing.assert_array_equal(a, b)


def test_layer_norm_and_attention_under_autocast_match_flax_at_bf16():
    """Under autocast the port's LayerNorm is flax's LayerNorm(dtype=bf16)
    (statistics in fp32, a bf16 result) and MultiHeadAttention's einsum
    path flax's at bf16 (the softmax in fp32, cast back): on the same fp32
    parameters and a bf16 input, outputs bf16 on both sides, within two
    bf16 roundings (2^-7 relative, plus 1e-2 absolute for the attention's
    sums of bf16 products)."""
    import jax.numpy as jnp
    from flax import linen as fnn

    from ralf_tpu.models import nn as jnn
    from ralf_tpu_torch.models import nn as tnn
    from ralf_tpu_torch.utils.weights import load_jax_params

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (3, 12, 32)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    jln = fnn.LayerNorm(dtype=jnp.bfloat16)
    lv = jln.init(jax.random.PRNGKey(0), xb)
    lv = jax.tree.map(lambda a: a + jnp.asarray(rng.normal(0, 0.3, a.shape), a.dtype), lv)
    tln = tnn.layer_norm(32)
    load_jax_params(tln, jax.tree.map(np.asarray, lv["params"]))
    jm = jnn.MultiHeadAttention(32, 4, dropout=0.0, dtype=jnp.bfloat16)
    keep = np.ones((3, 12), bool)
    keep[0, 7:] = False
    bias = jnn.keep_to_bias(jnp.asarray(keep))[:, None, None, :]
    mv = jm.init(jax.random.PRNGKey(1), xb, xb, bias)
    tm = tnn.MultiHeadAttention(32, 4, dropout=0.0).train()  # the einsum path
    load_jax_params(tm, jax.tree.map(np.asarray, mv["params"]))
    want_ln = jln.apply(lv, xb)
    want_att = jm.apply(mv, xb, xb, bias, deterministic=False)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got_ln = tln(tx)
        got_att = tm(tx, tx, tnn.keep_to_bias(torch.from_numpy(keep))[:, None, None, :])
    assert want_ln.dtype == want_att.dtype == jnp.bfloat16
    assert got_ln.dtype == got_att.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in list(tln.parameters()) + list(tm.parameters()))
    for got, want, atol in ((got_ln, want_ln, 0.0), (got_att, want_att, 1e-2)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=atol)
