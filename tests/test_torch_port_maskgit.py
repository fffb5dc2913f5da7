"""MaskGIT in the port against the JAX package, with what it brings: the
masking helpers, the element-count distribution, the `shuffle` transform
and the loader's rng stream, the cgl image encoder, the generator's
deterministic samples under every task, and `cli.inference` end to end.

Models are tiny (d_model 32, 4 heads, 1+1 layers, resnet18, 64x48
canvases), initialised in JAX and loaded into the port through the
weights bridge; both run on the CPU in float32, where the port's kernel
wrappers (K1 in the image encoder) run their plain versions and JAX its
einsum paths.  Logits agree within 1e-5 absolute + 1e-4 relative, tokens
exactly.  MaskGIT re-masks by confidence plus Gumbel noise from
`jax.random`, which torch cannot reproduce: parity holds with
deterministic sampling at temperature 0, where the noise vanishes; the
port's own noise is held by its frequencies.
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
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.core import mask as jmask
from ralf_tpu.core import sampling as jsamp
from ralf_tpu.core import seq_length as jseq
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import resnet as jres
from ralf_tpu.models.nn import TokenDecoder as JTokenDecoder
from ralf_tpu.train.trainer import Trainer
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.core import mask as tmask
from ralf_tpu_torch.core import sampling as tsamp
from ralf_tpu_torch.core import seq_length as tseq
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import resnet as tres
from ralf_tpu_torch.models.maskgit import MaskGITGenerator, remask_rate
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4
HW = (64, 48)
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}", "debug=true",
        "synthetic_data=true", "sampling.name=deterministic", "sampling.temperature=0.0"]
MASKGIT_TASKS = ("uncond", "c", "cwh", "partial", "refinement")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


# ---- the masking helpers --------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "ties", "nothing_eligible"])
def test_batch_topk_mask_matches_jax(case):
    """>= the k-th eligible score, ties included; a row with nothing eligible
    comes back all True (-inf >= -inf), the quirk MaskGIT's step 0 needs."""
    rng = np.random.default_rng(0)
    B, S = 6, 11
    scores = rng.normal(size=(B, S)).astype(np.float32)
    mask = rng.random((B, S)) > 0.3
    if case == "ties":
        scores = rng.integers(0, 3, size=(B, S)).astype(np.float32)
    if case == "nothing_eligible":
        mask[::2] = False
    topk = np.array([1, 2, 3, 0, 11, 20], np.int32)  # 0 and past S clip to [1, S]
    jm, jk = jmask.batch_topk_mask(jnp.asarray(scores), jnp.asarray(topk), jnp.asarray(mask))
    tm, tk = tmask.batch_topk_mask(torch.from_numpy(scores), torch.from_numpy(topk),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if case == "nothing_eligible":
        assert tm[::2].all()
    jm, _ = jmask.batch_topk_mask(jnp.asarray(scores), jnp.asarray(topk))
    tm, _ = tmask.batch_topk_mask(torch.from_numpy(scores), torch.from_numpy(topk))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_sequence_mask_and_schedules_match_jax():
    lengths = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(tmask.sequence_mask(torch.from_numpy(lengths), 7).numpy(),
                                  np.asarray(jmask.sequence_mask(jnp.asarray(lengths), 7)))
    ratio = np.linspace(0, 1, 23).astype(np.float32)
    for name in ("linear", "cosine", "square", "cubic", "sqrt"):
        got = tmask.mask_schedule(torch.from_numpy(ratio), name)
        assert got.dtype == torch.float32
        _close(got.numpy(), np.asarray(jmask.mask_schedule(jnp.asarray(ratio), name)),
               atol=1e-7, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tmask.mask_schedule(torch.from_numpy(ratio), "exp")


def test_sample_mask_picks_the_ratio_uniformly():
    """The port's draws (torch.Generator): each row picks max(int(ratio n), 1)
    of its eligible positions, every eligible position equally often."""
    mask = torch.ones(4000, 10, dtype=torch.bool)
    mask[:, 7:] = False
    ratio = torch.full((4000,), 0.5)
    picked = tmask.sample_mask(mask, ratio, torch.Generator().manual_seed(0))
    assert not (picked & ~mask).any()
    assert (picked.sum(1) == 3).all()  # int(0.5 * 7)
    freq = picked[:, :7].float().mean(0)  # 3/7 each; 5 sigma of a binomial share
    assert (freq - 3 / 7).abs().max() < 5 * (3 / 7 * 4 / 7 / 4000) ** 0.5


def test_seq_length_distribution_matches_jax():
    j, t = jseq.SeqLengthDistribution(10), tseq.SeqLengthDistribution(10)
    rng = np.random.default_rng(3)
    for _ in range(4):
        n = rng.integers(0, 11, size=16)
        m = np.arange(10)[None] < n[:, None]
        j.update(m)
        t.update(m)
    np.testing.assert_array_equal(t.n_elements_prob, j.n_elements_prob)
    np.testing.assert_array_equal(t.sample(np.random.default_rng(5), 64),
                                  j.sample(np.random.default_rng(5), 64))
    with pytest.raises(ValueError):
        t.update(np.ones(10, bool))


# ---- shuffle and the loader ----------------------------------------------------


@pytest.mark.parametrize("use_native", [False, True])
def test_shuffle_loader_rng_stream_matches_jax_over_two_epochs(use_native):
    """The zoo's presets shuffle each layout's elements: per row with n > 1 a
    permutation from the loader's rng (numpy path), or one collate seed
    per batch (native path), in JAX's order, so the batches and the next
    epoch's order are JAX's."""
    jd = jdata.SyntheticPosterDataset(jdata.DatasetConfig(name="synthetic"), 21, 3, HW)
    td = tdata.SyntheticPosterDataset(tdata.DatasetConfig(name="synthetic"), 21, 3, HW)
    kw = dict(seed=4, use_native=use_native, with_images=False, transforms=("shuffle",))
    jl, tl = jdata.BatchLoader(jd, 8, prefetch=0, **kw), tdata.BatchLoader(td, 8, **kw)
    moved = 0
    for _ in range(2):
        for jb, tb in zip(jl, tl, strict=True):
            np.testing.assert_array_equal(tb["indices"], jb["indices"])
            for k, a in tb["layout"].numpy().items():
                np.testing.assert_array_equal(a, np.asarray(getattr(jb["layout"], k)), err_msg=k)
            raw = td.get_layouts(tb["indices"])
            moved += int((tb["layout"].numpy()["center_x"] != raw["center_x"]).any())
    assert moved > 0  # the elements were shuffled


# ---- the cgl image encoder ------------------------------------------------------


def test_trap_bilinear_upsample_is_align_corners_false():
    """jax.image.resize(..., "bilinear") from 11x8 to 22x15 (a 350x240
    canvas; a width factor that is not an integer) is torch's bilinear with
    align_corners=False: half-pixel centres, the edges clamped."""
    x = np.random.default_rng(0).normal(size=(2, 11, 8, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 22, 15, 5), method="bilinear")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(22, 15),
                        mode="bilinear", align_corners=False, antialias=False)
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    corners = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(22, 15),
                            mode="bilinear", align_corners=True)
    assert np.abs(corners.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("uint8", [False, True])
def test_cgl_image_encoder_matches_jax(uint8):
    """ImageEncoder with the cgl FPN (ImageNet-normalised RGB, half-width
    laterals, the bilinear upsample, concat to d_model) and the zoo's FFN
    width; float or uint8 canvases 240 wide, as the 350x240 canvas, whose
    8 -> 15 upsample is not by an integer factor."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 64, 240, 4)).astype(np.float32)
    if uint8:
        img = (img * 255).astype(np.uint8)
    jm = jres.ImageEncoder(backbone="resnet18", d_model=32, nhead=4, num_layers=1,
                           dim_feedforward=128, fpn_style="cgl")
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(img)))
    want = jm.apply(v, jnp.asarray(img))
    tm = tres.ImageEncoder("resnet18", 32, 4, 1, 128, fpn_style="cgl").eval()
    load_jax_params(tm, v["params"], v["batch_stats"])
    assert tm.extractor.normalize_rgb
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    assert got.shape == (2, 4 * 15, 32)
    _close(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)  # resnet18 + 1 layer, fp32
    with pytest.raises(ValueError, match="fpn_style"):
        tres.ResNetFPNEncoder("resnet18", 32, fpn_style="fpn")


def test_trap_maskgit_remask_counts_follow_the_jitted_loop():
    """JAX's sampler runs in a jitted fori_loop, where XLA computes the
    linear schedule's 1 - (t + 1) / T as 1 - (t + 1) * fp32(1 / T) in one
    rounding: at T = 10, n = 50 it re-masks 14 after step 6 where the
    correctly rounded ratio gives 15.  `remask_rate` computes what the
    jitted loop computes."""
    ns = jnp.arange(1, 51, dtype=jnp.int32)

    def jitted(T):
        def body(t, acc):
            ratio = jmask.mask_schedule(jnp.full((50,), (t + 1.0) / T), "linear")
            return acc.at[t].set(jnp.maximum((ns * ratio).astype(jnp.int32), 1))

        return np.asarray(jax.lax.fori_loop(0, T, body, jnp.zeros((T, 50), jnp.int32)))

    n = torch.arange(1, 51)
    for T in (1, 2, 3, 7, 10, 13, 25, 50):
        got = np.stack([torch.clamp((n * torch.tensor(remask_rate(t, T))).to(torch.int32), min=1)
                        .numpy() for t in range(T)])
        np.testing.assert_array_equal(got, jitted(T), err_msg=f"T={T}")
    assert int(50 * remask_rate(6, 10)) == 14 and int(50 * np.float32(1 - np.float32(0.7))) == 15


# ---- the generator --------------------------------------------------------------


@pytest.fixture(scope="module")
def maskgit():
    """(JAX generator, port generator, JAX variables, batch pair) on one set of weights."""
    jcfg = jconfig.build_config("maskgit", TINY)
    tcfg = tconfig.build_config("maskgit", TINY)
    jg = jconfig.build_generator(jcfg, jconfig.build_tokenizer(jcfg))
    tg = tconfig.build_generator(tcfg, tconfig.build_tokenizer(tcfg), device="cpu")
    assert isinstance(tg, MaskGITGenerator) and tg.num_timesteps == 10
    v = _np(jg.init(jax.random.PRNGKey(0)))
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    jd, _, _ = jconfig.build_datasets(jcfg)
    td, _, _ = tconfig.build_datasets(tcfg)
    kw = dict(shuffle=False, transforms=(), use_native=False)
    jb = next(iter(jdata.BatchLoader(jd, 6, prefetch=0, **kw)))
    tb = next(iter(tdata.BatchLoader(td, 6, **kw)))
    return jg, tg, v, (jb, tb)


def test_maskgit_core_matches_jax(maskgit):
    jg, tg, v, (jb, tb) = maskgit
    rng = np.random.default_rng(2)
    L, V = tg.tokenizer.max_token_length, tg.tokenizer.N_total
    seq = rng.integers(0, V, size=(6, L)).astype(np.int32)
    want_mem = jg.core.apply(v, jnp.asarray(jb["image"]), method=type(jg.core).encode_memory)
    want = jg.core.apply(v, jnp.asarray(seq), jnp.asarray(jb["image"]))
    with torch.no_grad():
        mem = tg.core.encode_memory(torch.from_numpy(np.asarray(tb["image"])))
        got = tg.core(torch.from_numpy(seq).long(), torch.from_numpy(np.asarray(tb["image"])))
    _close(mem.numpy(), np.asarray(want_mem), atol=1e-4, rtol=1e-3)
    _close(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)
    # one denoising step's logits on the same memory: the decoder alone
    with torch.no_grad():
        step = tg.core.decoder(torch.from_numpy(seq).long(), torch.from_numpy(np.array(want_mem)),
                               causal=False)
    c = jg.cfg
    want_step = JTokenDecoder(vocab_size=V, d_model=c.d_model, nhead=c.nhead,
                              num_layers=c.num_decoder_layers, dim_feedforward=4 * c.d_model,
                              dropout=c.dropout).apply({"params": v["params"]["decoder"]},
                                                       jnp.asarray(seq), want_mem, causal=False)
    _close(step.numpy(), np.asarray(want_step))


@pytest.mark.parametrize("task", MASKGIT_TASKS)
def test_maskgit_deterministic_samples_equal_jax(maskgit, task):
    jg, tg, v, (jb, tb) = maskgit
    jc, _ = jg.build_condition(jb, np.random.default_rng(11), task=task)
    tc, _ = tg.build_condition(tb, np.random.default_rng(11), task=task)
    js = jsamp.SamplingConfig(name="deterministic", temperature=0.0)
    ts = tsamp.SamplingConfig(name="deterministic", temperature=0.0)
    _, want = jg.sample(v, jc, js, jax.random.PRNGKey(5), return_tokens=True)
    layout, got = tg.sample(tc, ts, torch.Generator().manual_seed(5), return_tokens=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got == tg.mask_id).any()
    if tc.seq is not None:  # the user's tokens stay in place
        known = np.asarray(tc.seq_mask)
        np.testing.assert_array_equal(got.numpy()[known], np.asarray(tc.seq)[known])
    if task in ("c", "cwh", "refinement"):  # a given element is never PAD
        given = np.asarray(tc.seq) != tg.pad_id
        assert not (got.numpy()[given] == tg.pad_id).any()


def test_maskgit_gumbel_noise_changes_the_samples_by_its_temperature(maskgit):
    """The port's own re-masking noise: at temperature 0 the generator's seed
    does not matter; at temperature 1 two seeds give different samples."""
    _, tg, _, (_, tb) = maskgit
    tc, _ = tg.build_condition(tb, np.random.default_rng(0), task="uncond")

    def run(temperature, seed):
        cfg = tsamp.SamplingConfig(name="deterministic", temperature=temperature)
        return tg.sample(tc, cfg, torch.Generator().manual_seed(seed), return_tokens=True)[1]

    assert torch.equal(run(0.0, 1), run(0.0, 2))
    assert not torch.equal(run(1.0, 1), run(1.0, 2))


def test_maskgit_generator_guards(monkeypatch):
    """A tokenizer with BOS raises; without CUDA the default device raises for
    every zoo preset, and device="cpu" builds."""
    ar = tconfig.build_config("autoreg", TINY)
    with pytest.raises(ValueError, match="pad, mask"):
        MaskGITGenerator(tconfig.build_tokenizer(ar), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for exp in ("maskgit", "layoutdm", "layoutdm_ra", "vqdiffusion"):
        cfg = tconfig.build_config(exp, TINY + ["allow_linear_fallback=true"])
        tok = tconfig.build_tokenizer(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tconfig.build_generator(cfg, tok)
        assert tconfig.build_generator(cfg, tok, device="cpu").device == torch.device("cpu")


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


@pytest.mark.parametrize("cond", ["c"])
def test_cli_inference_maskgit_writes_jax_pickles_and_violations(tmp_path, cond):
    """One job dir from one set of variables (JAX's orbax checkpoint and the
    .npz); JAX's CLI at its default --mesh auto (one CPU device) and the
    port's write equal pickles and violation csvs."""
    job = str(tmp_path / "job")
    cfg = jconfig.build_config("maskgit", TINY + [f"cache_dir={tmp_path}/cache",
                                                 f"train.job_dir={job}"])
    cfg.save(job)
    trainer = Trainer(jconfig.build_generator(cfg, jconfig.build_tokenizer(cfg)), cfg.train)
    state = trainer.init_state(jax.random.PRNGKey(0))
    trainer.save(state, "final")
    flat = {f"{name}/{k}": np.asarray(a) for name, tree in
            (("params", state.params), ("batch_stats", state.batch_stats))
            for k, a in flatten_dict(jax.device_get(tree), sep="/").items()}
    np.savez(os.path.join(job, "ckpt_final.npz"), **flat)
    args = ["--job-dir", job, "--cond", cond, "--num-seeds", "1", "--batch-size", "16"]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    want, got = _pickle(f"{job}/jax/test_0.pkl"), _pickle(f"{job}/port/test_0.pkl")
    assert len(got["results"]) == 16 and got == want
    assert _csv(f"{job}/port/test_0_violation.csv") == _csv(f"{job}/jax/test_0_violation.csv")
    if cond == "c":
        assert _csv(f"{job}/port/test_0_violation.csv")[1][2] == "0.0"
    with pytest.raises(ValueError, match="kv-quant"):
        tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/q8", "--kv-quant"])
