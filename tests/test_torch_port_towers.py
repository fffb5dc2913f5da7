"""The port's feature towers, their checkpoint loader and LPIPS against the
JAX package, on the CPU.

  * Each tower on JAX's variables (`load_jax_params`): ViT-B/16 (both
    `pre_norm`) and DreamSim at dim 96, depth 2, 64x64; InceptionV3 whole at
    75x75; AlexNet's taps at 64x64; VGG16's taps at 32x32 (its 7x7
    pre-logits need a 224 input and 138 M parameters: its pooled feature is
    a `slow` test and a card check).  Limit: JAX's tower tests' 1e-4 of the
    largest magnitude (tests/test_towers.py).  JAX's variables are drawn
    from numpy on the tree of `jax.eval_shape(init)`.
  * The resize (`jax.image.resize(method="cubic", antialias=True)` against
    torch's antialiased bicubic) from 350x240 canvases to 224 and 299
    within 2e-5.
  * The loader: for each kind, a random tests/tower_twins.py state_dict in
    a file goes (a) through JAX's `torch_port.load_tower_if_available` and
    `load_jax_params` and (b) through the port's `load_tower_if_available`;
    the two give equal tensors, every key of the file is read, and the
    port's tower gives the twin's output.  VGG16's key map is held on the
    `meta` device (no memory for its 138 M parameters).
  * LPIPS: `lpips_from_taps` on the same taps with and without the learned
    lins (rtol 1e-5), the distance's axioms, and `lpips_rerank`'s order
    equal to JAX's on one `lpips_alex.pth`.
  * `cli.evaluate --image-metrics` (and with `--unannotated`) against JAX's
    in process: JAX's keys in JAX's order, the image scores within 1e-5
    relative, both packages' `tower_feature_fn` patched to one shared
    deterministic feature function; the full towers on the same twin
    checkpoints are a `slow` test.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tower_twins
from ralf_tpu.cli import evaluate as jeval
from ralf_tpu.eval import image_metrics as jim
from ralf_tpu.models import towers as jtow
from ralf_tpu.retrieval import lpips as jlp
from ralf_tpu.utils import torch_port as jport
from ralf_tpu_torch.cli import evaluate as teval
from ralf_tpu_torch.config import build_config, build_datasets
from ralf_tpu_torch.eval import image_metrics as tim
from ralf_tpu_torch.models import towers as ttow
from ralf_tpu_torch.retrieval import lpips as tlp
from ralf_tpu_torch.utils import checkpoints as tck
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
TOWER_TOL = 1e-4  # relative to the largest magnitude, JAX's tower tests' limit


def _rel_err(a, b) -> float:
    a, b = (np.asarray(t.detach() if torch.is_tensor(t) else t) for t in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-8))


def _img(seed: int, B: int, H: int, W: int = None) -> np.ndarray:
    return np.random.default_rng(seed).random((B, H, W or H, 3), dtype=np.float32)


def shared_features(dim: int = 8):
    """A deterministic numpy feature function of canvases [B, H, W, C>=3]:
    a fixed random projection of their 8x8 block means."""
    proj = np.random.default_rng(0).normal(size=(8 * 8 * 3, dim)).astype(np.float32)

    def fn(images):
        x = np.asarray(images, np.float32)[..., :3]
        B, H, W, _ = x.shape
        x = x[:, : H // 8 * 8, : W // 8 * 8].reshape(B, 8, H // 8, 8, W // 8, 3).mean((2, 4))
        return x.reshape(B, -1) @ proj

    return fn


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_variables(module, x, seed: int, **kw) -> dict:
    """Variables of `module` at input `x`, drawn from numpy on the tree of
    jax.eval_shape(init) (nothing compiled)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw))

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("scale", "mean", "bias") or leaf.ndim < 2:
            return rng.normal(0.0 if name != "scale" else 1.0, 0.05, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, fan_in**-0.5, leaf.shape).astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, dict(t)) for c, t in shapes.items()}


def _bridge(jmod, tmod, x, seed: int, **kw):
    """(JAX's output, the port's) of the same tower on the same variables."""
    v = _jax_variables(jmod, x, seed, **kw)
    load_jax_params(tmod, v["params"], v.get("batch_stats"))
    want = jax.jit(lambda v, x: jmod.apply(v, x, **kw))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tmod.eval()(_nchw(x), **kw)
    return jax.tree.map(np.asarray, want), got


# ---- the towers on JAX's variables ---------------------------------------------


@pytest.mark.parametrize("size", [224, 299])
def test_resize_matches_jax(size):
    """The resize alone (DreamSim's transform: mean 0, std 1); a tower's
    normalisation then divides the difference by its std."""
    x = _img(0, 2, 350, 240)
    want = np.asarray(jtow.resize_normalize(jnp.asarray(x), size, (0.0,) * 3, (1.0,) * 3))
    got = ttow.resize_normalize(torch.from_numpy(x), size, (0.0,) * 3, (1.0,) * 3).numpy()
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_vit_b16_matches_jax(pre_norm):
    x = _img(1, 2, 64)
    want, got = _bridge(jtow.ViTB16(dim=96, depth=2, num_heads=4, pre_norm=pre_norm),
                        ttow.ViTB16(96, 2, 4, pre_norm=pre_norm, img_size=64), x, seed=1)
    assert got.shape == (2, 96)
    assert _rel_err(got, want) < TOWER_TOL


def test_dreamsim_matches_jax():
    x = _img(2, 2, 64)
    want, got = _bridge(jtow.DreamSimEnsemble(dim=96, depth=2, num_heads=4),
                        ttow.DreamSimEnsemble(96, 2, 4, img_size=64), x, seed=2)
    assert got.shape == (2, 3 * 96)
    assert _rel_err(got, want) < TOWER_TOL


def test_inception_v3_matches_jax():
    x = _img(3, 2, 75)  # the smallest input the stem and the reductions take
    want, got = _bridge(jtow.InceptionV3Features(), ttow.InceptionV3Features(), x, seed=3)
    assert got.shape == (2, 2048)
    assert _rel_err(got, want) < TOWER_TOL


def test_alexnet_taps_match_jax():
    x = _img(4, 2, 64)
    want, got = _bridge(jtow.AlexNetFeatures(), ttow.AlexNetFeatures(), x, seed=4)
    assert [tuple(t.shape[1:]) for t in got] == [(64, 15, 15), (192, 7, 7), (384, 3, 3),
                                                 (256, 3, 3), (256, 3, 3)]
    for g, w in zip(got, want):
        assert _rel_err(g.numpy().transpose(0, 2, 3, 1), w) < TOWER_TOL


def test_vgg16_taps_match_jax():
    """The conv stack at 32x32 through `return_taps` (JAX's tree then holds
    no pre-logits; the port's tower is cut to the same)."""
    x = _img(5, 2, 32)
    tmod = ttow.VGG16Features()
    del tmod.pre_logits_fc1, tmod.pre_logits_fc2
    want, got = _bridge(jtow.VGG16Features(), tmod, x, seed=5, return_taps=True)
    assert [t.shape[1] for t in got] == [64, 128, 256, 512, 512]
    for g, w in zip(got, want):
        assert _rel_err(g.numpy().transpose(0, 2, 3, 1), w) < TOWER_TOL


@pytest.mark.slow
def test_vgg16_pooled_feature_matches_jax():
    x = _img(6, 2, 224)
    want, got = _bridge(jtow.VGG16Features(), ttow.VGG16Features(), x, seed=6)
    assert got.shape == (2, 4096)
    assert _rel_err(got, want) < TOWER_TOL


# ---- the checkpoint loader against JAX's converters ----------------------------


def _alexnet_lpips_state_dict(seed: int, as_slices: bool) -> tuple:
    """A random lpips.LPIPS(net="alex")-shaped state_dict (the tower under
    lpips's `net.slice{k}.{i}` names, or torchvision's, and the five lins)
    and the torchvision feature stack it holds."""
    import torch.nn as nn

    g = torch.Generator().manual_seed(seed)
    feats = nn.Sequential(
        nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(), nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
        nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU())
    with torch.no_grad():
        for p in feats.parameters():
            p.normal_(0, 0.05, generator=g)
    sd = {}
    slice_of = {0: (1, 0), 3: (2, 2), 6: (3, 5), 8: (4, 8), 10: (5, 10)}
    for i, (k, base) in slice_of.items():
        for leaf in ("weight", "bias"):
            key = f"net.slice{k}.{i - base}.{leaf}" if as_slices else f"features.{i}.{leaf}"
            sd[key] = feats[i].state_dict()[leaf].clone()
    for k, ch in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{k}.model.1.weight"] = torch.rand(1, ch, 1, 1, generator=g) * 0.1
    return sd, feats


def _twin(kind: str):
    """(the checkpoint's state_dict, a function of NCHW images giving the
    twin's output, the port's empty tower, its input size)."""
    if kind in ("clip", "dino"):
        twin = tower_twins.randomize_(tower_twins.ViTTwin(
            dim=96, depth=2, num_heads=4, img_size=64, pre_norm=kind == "clip"), seed=7)
        return twin.state_dict(), twin, ttow.ViTB16(96, 2, 4, pre_norm=kind == "clip",
                                                    img_size=64), 64
    if kind == "dreamsim":
        sd, towers = {}, {}
        for i, (name, pre_norm) in enumerate(ttow.DREAMSIM_TOWERS):
            towers[name] = tower_twins.randomize_(tower_twins.ViTTwin(
                dim=96, depth=2, num_heads=4, img_size=64, pre_norm=pre_norm), seed=8 + i)
            sd.update({f"{name}.{k}": v for k, v in towers[name].state_dict().items()})

        def run(x):
            fs = [towers[n](x) for n, _ in ttow.DREAMSIM_TOWERS]
            return torch.cat([f / f.norm(dim=-1, keepdim=True).clamp_min(1e-6) for f in fs], -1)

        return sd, run, ttow.DreamSimEnsemble(96, 2, 4, img_size=64), 64
    if kind == "inception_v3":
        twin = tower_twins.randomize_(tower_twins.InceptionV3Twin(), seed=11)
        sd = {k: v for k, v in twin.state_dict().items() if not k.endswith("num_batches_tracked")}
        return sd, twin, ttow.InceptionV3Features(), 75
    sd, feats = _alexnet_lpips_state_dict(12, as_slices=kind == "lpips_alex")
    if kind == "alexnet":
        sd = {k: v for k, v in sd.items() if k.startswith("features.")}

    def taps(x):
        out = []
        for i, m in enumerate(feats):
            x = m(x)
            if i in (1, 4, 7, 9, 11):
                out.append(x)
        return out

    return sd, taps, ttow.AlexNetFeatures(), 64


@pytest.mark.parametrize("kind", ["clip", "dino", "dreamsim", "inception_v3", "alexnet",
                                  "lpips_alex"])
def test_loader_equals_jax_converters_and_gives_the_twins_output(kind, tmp_path):
    sd, twin, port_tower, size = _twin(kind)
    path = str(tmp_path / "tower.pt")
    torch.save(sd, path)
    # (a) JAX's converter, then the weights bridge
    jported = jport.load_tower_if_available(path, kind)
    via_jax = _twin(kind)[2]
    if kind == "inception_v3":
        load_jax_params(via_jax, *jported)
    elif kind == "lpips_alex":
        load_jax_params(via_jax, jported[0])
    else:
        load_jax_params(via_jax, jported)
    # (b) the port's loader
    state = tck.load_tower_if_available(path, kind)
    _, unread = tck.tower_state_dict(torch.load(path, weights_only=True), kind)
    assert unread == []
    if kind == "lpips_alex":
        state, lins = state
        assert len(lins) == 5
        for a, b in zip(lins, jported[1]):
            np.testing.assert_array_equal(a.numpy(), b)
    port_tower.load_state_dict(state, strict=True)
    want_t = via_jax.state_dict()
    for k, t in port_tower.state_dict().items():
        torch.testing.assert_close(t, want_t[k], rtol=0, atol=0, msg=k)
    x = _nchw(_img(13, 2, size))
    with torch.no_grad():
        got, ref = port_tower.eval()(x), twin(x)
    if isinstance(got, list):
        for g, r in zip(got, ref):
            assert _rel_err(g, r) < TOWER_TOL
    else:
        assert _rel_err(got, ref) < TOWER_TOL


def test_vgg16_loader_reads_every_timm_key_and_fills_every_tensor():
    with torch.device("meta"):
        sd = tower_twins.VGG16Twin().state_dict()
        port = ttow.VGG16Features().state_dict()
    state, unread = tck.tower_state_dict(sd, "vgg16")
    assert unread == []
    assert sorted(state) == sorted(port)
    assert all(state[k].shape == port[k].shape for k in port)
    assert tck.load_tower_if_available("/nonexistent/vgg16.pt", "vgg16") is None


def test_build_feature_fn_loads_the_checkpoint_or_runs_a_seeded_random_tower(
        tmp_path, monkeypatch, caplog):
    """`clip` cut to a small ViT: with the file the tower gives the twin's
    features of the resized, normalised canvases; without it, a warning and
    the same random features in every build."""
    small = (lambda: ttow.ViTB16(96, 2, 4, pre_norm=True, img_size=64), 64,
             *ttow.TOWER_SPECS["clip"][2:])
    monkeypatch.setitem(ttow.TOWER_SPECS, "clip", small)
    twin = tower_twins.randomize_(tower_twins.ViTTwin(dim=96, depth=2, num_heads=4,
                                                      img_size=64, pre_norm=True), seed=14)
    torch.save(twin.state_dict(), str(tmp_path / "clip_vit_b16.pt"))
    canvases = _img(15, 3, 50, 40)
    got = ttow.build_feature_fn("clip", str(tmp_path), "cpu")(canvases)
    with torch.no_grad():
        ref = twin(ttow.resize_normalize(torch.from_numpy(canvases), 64, ttow.CLIP_MEAN,
                                         ttow.CLIP_STD))
    assert _rel_err(got, ref) < TOWER_TOL
    empty = str(tmp_path / "none")
    with caplog.at_level("WARNING"):
        a = ttow.build_feature_fn("clip", empty, "cpu")(canvases)
    assert "RANDOMLY INITIALIZED" in caplog.text
    torch.testing.assert_close(a, ttow.build_feature_fn("clip", empty, "cpu")(canvases),
                               rtol=0, atol=0)



def test_random_towers_draw_flax_initialisers():
    """Without a checkpoint a tower draws flax's `nn.Conv`/`nn.Dense`
    initialisers' laws (lecun_normal: a normal cut at two deviations with
    variance 1/fan_in; zero biases), so a random VGG16's deepest tap still
    tells the synthetic canvases apart: under torch's default init it is its
    biases' constant (spread 1.7e-4 of its magnitude here, against 0.15)."""
    from ralf_tpu_torch.data.dataset import DatasetConfig, SyntheticPosterDataset

    vgg = ttow.seeded(ttow.VGG16Features)
    for name, m in vgg.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            w = m.weight.detach() * m.weight[0].numel() ** 0.5  # unit variance
            assert float(w.abs().max()) <= 2 / 0.87962566103423978 + 1e-5, name
            assert abs(float(w.var()) - 1) < 0.05, name
            assert not m.bias.any(), name
    ds = SyntheticPosterDataset(DatasetConfig(name="pku10"), 4, seed=0, image_hw=(64, 48))
    x = ttow.resize_normalize(torch.from_numpy(ds.get_images(np.arange(4))[..., :3]), 32,
                              ttow.IMAGENET_MEAN, ttow.IMAGENET_STD)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        default = ttow.VGG16Features()  # torch's own init

    def spread(tower):
        with torch.no_grad():
            f = tower(x, return_taps=True)[-1].flatten(1)
        return float((f - f.mean(0)).abs().max() / f.abs().max())

    assert spread(vgg) > 0.05 and spread(default) < 1e-3
    torch.testing.assert_close(ttow.seeded(ttow.VGG16Features).features_0.weight,
                               vgg.features_0.weight, rtol=0, atol=0)


def test_image_fid_and_rshm_match_jax():
    """`compute_image_fid` over the masked canvases' features and
    `compute_rshm` against JAX's on the same layouts, canvases and feature
    function (what `cli.evaluate --image-metrics` gathers per chunk)."""
    from ralf_tpu.core.layout import Layout as JLayout
    from ralf_tpu_torch.core.layout import Layout as TLayout

    rng = np.random.default_rng(3)
    B, S = 8, 6

    def layout():
        mask = rng.random((B, S)) < 0.7
        mask[:, 0] = True
        geo = {k: rng.uniform(0.1, 0.6, (B, S)).astype(np.float32)
               for k in ("center_x", "center_y", "width", "height")}
        return {"label": rng.integers(0, 3, (B, S)).astype(np.int32), "mask": mask, **geo}

    gt, pred = layout(), layout()
    images = rng.random((B, 40, 32, 4), dtype=np.float32)
    fn = shared_features(12)
    jl = {n: JLayout(**{k: jnp.asarray(v) for k, v in d.items()})
          for n, d in (("gt", gt), ("pred", pred))}
    want = jim.compute_image_fid(jl["gt"], jl["pred"], images, fn)
    got = tim.compute_image_fid(tim.masked_features(TLayout.fromdict(gt), images, fn),
                                tim.masked_features(TLayout.fromdict(pred), images, fn))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tim.compute_rshm(TLayout.fromdict(pred), images, fn),
                               np.asarray(jim.compute_rshm(jl["pred"], images, fn)),
                               rtol=1e-5, atol=1e-7)

# ---- LPIPS ----------------------------------------------------------------------


def _taps(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, c, h, h)).astype(np.float32)
            for c, h in ((64, 7), (192, 3), (384, 3), (256, 3), (256, 3))]


@pytest.mark.parametrize("with_lins", [False, True])
def test_lpips_from_taps_matches_jax(with_lins):
    a, b = _taps(0), _taps(1)
    lins = [np.random.default_rng(2 + i).random(t.shape[1]).astype(np.float32) for i, t in
            enumerate(a)] if with_lins else None
    want = np.asarray(jlp.lpips_from_taps(
        [jnp.asarray(t.transpose(0, 2, 3, 1)) for t in a],
        [jnp.asarray(t.transpose(0, 2, 3, 1)) for t in b],
        None if lins is None else [jnp.asarray(w) for w in lins]))
    got = tlp.lpips_from_taps([torch.from_numpy(t) for t in a], [torch.from_numpy(t) for t in b],
                              None if lins is None else [torch.from_numpy(w) for w in lins])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    scaled = np.random.default_rng(3).random((2, 3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tlp.lpips_scale(torch.from_numpy(scaled)).numpy().transpose(0, 2, 3, 1),
        np.asarray(jlp.lpips_scale(jnp.asarray(scaled.transpose(0, 2, 3, 1)))), rtol=1e-6)


@pytest.fixture(scope="module")
def lpips_cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    torch.save(_alexnet_lpips_state_dict(16, as_slices=True)[0], str(d / "lpips_alex.pth"))
    return str(d)


def test_lpips_distance_axioms(lpips_cache):
    embed, dist = tlp.make_lpips_fns(lpips_cache, size=32, device="cpu")
    x, y = _img(17, 3, 40, 30), _img(18, 3, 40, 30)
    tx, ty = embed(x), embed(y)
    d_xy, d_yx, d_xx = dist(tx, ty).numpy(), dist(ty, tx).numpy(), dist(tx, tx).numpy()
    assert d_xy.shape == (3,)
    np.testing.assert_allclose(d_xx, 0.0, atol=1e-6)
    np.testing.assert_allclose(d_xy, d_yx, rtol=1e-5)
    assert (d_xy > 1e-4).all()
    near = np.clip(x + np.random.default_rng(0).normal(0, 0.02, x.shape), 0, 1).astype(np.float32)
    assert (dist(tx, embed(near)).numpy() < d_xy).all()


def test_lpips_rerank_order_matches_jax(lpips_cache):
    gallery = _img(19, 12, 40, 30)
    queries = gallery[[7, 2, 5]]
    candidates = np.array([[0, 1, 3, 7, 9], [4, 5, 6, 2, 11], [5, 8, 10, 1, 0]])
    args = (lambda rows: queries[rows], candidates, lambda rows: gallery[rows])
    got = tlp.lpips_rerank(*args, cache_dir=lpips_cache, size=32, chunk=2, device="cpu")
    want = jlp.lpips_rerank(*args, cache_dir=lpips_cache, size=32, chunk=2)
    np.testing.assert_array_equal(got, want)
    assert list(got[:, 0]) == [7, 2, 5]
    assert all(sorted(g) == sorted(c) for g, c in zip(got, candidates))


# ---- cli.evaluate --image-metrics ------------------------------------------------


@pytest.fixture(scope="module")
def eval_job(tmp_path_factory):
    """A job dir (the ralf preset's config, synthetic debug splits) and two
    seeds' test pickles: the GT layouts jittered."""
    d = str(tmp_path_factory.mktemp("eval_job"))
    cfg = build_config("ralf", ["synthetic_data=true", "debug=true"])
    cfg.save(d)
    test = build_datasets(cfg)[2]
    lay = test.get_layouts(np.arange(len(test)))
    out = os.path.join(d, "out")
    os.makedirs(out)
    for seed in range(2):
        rng = np.random.default_rng(seed)
        records = []
        for i in range(len(test)):
            m = lay["mask"][i]
            rec = {"label": lay["label"][i][m].tolist()}
            for k in ("center_x", "center_y", "width", "height"):
                v = lay[k][i][m] + rng.normal(0, 0.03, m.sum())
                rec[k] = np.clip(v, 0.02, 0.98).astype(np.float32).tolist()
            records.append(rec)
        with open(os.path.join(out, f"test_{seed}.pkl"), "wb") as f:
            pickle.dump({"results": records}, f)
    return d, out


@pytest.fixture
def shared_image_towers(monkeypatch):
    fns = {"inception": shared_features(8), "vgg": shared_features(12)}
    monkeypatch.setattr(jim, "tower_feature_fn", lambda kind, cache_dir="cache", **kw: fns[kind])
    monkeypatch.setattr(tim, "tower_feature_fn", lambda kind, cache_dir="cache", **kw: fns[kind])


IMAGE_KEYS = ["image_precision", "image_recall", "image_density", "image_coverage", "image_fid",
              "R_shm"]


def _evaluate_both(monkeypatch, job, out, tmp_path, *extra):
    common = ["--input-dir", out, "--job-dir", job, "--image-metrics", *extra]
    monkeypatch.setattr(sys, "argv", ["evaluate", *common, "--cache-dir",
                                      str(tmp_path / "jcache")])
    jeval.main()
    with open(os.path.join(out, "scores_all.json")) as f:
        want = json.load(f)
    got = teval.main([*common, "--cache-dir", str(tmp_path / "tcache"), "--device", "cpu"])
    return got, want


@pytest.mark.parametrize("unannotated", [False, True])
def test_evaluate_image_metrics_match_jax(unannotated, eval_job, shared_image_towers,
                                          monkeypatch, tmp_path):
    job, out = eval_job
    got, want = _evaluate_both(monkeypatch, job, out, tmp_path,
                               *(["--unannotated"] if unannotated else []))
    assert list(got) == list(want)  # JAX's keys in JAX's order
    image_keys = IMAGE_KEYS[-1:] if unannotated else IMAGE_KEYS
    assert [k for k in got if k.startswith("image_") or k == "R_shm"] == image_keys
    for k in image_keys + ["validity", "occlusion", "unreadability", "utilization"]:
        for stat in ("mean", "std"):
            np.testing.assert_allclose(got[k][stat], want[k][stat], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} {stat}")
    assert got["R_shm"]["mean"] > 0


@pytest.mark.slow
def test_evaluate_image_metrics_with_the_full_towers_match_jax(eval_job, monkeypatch, tmp_path):
    """InceptionV3 and VGG16 at full size on the same twin checkpoints in both
    packages' cache dirs."""
    job, out = eval_job
    sd = {"inception_v3.pt": tower_twins.randomize_(tower_twins.InceptionV3Twin(), 30),
          "vgg16.pt": tower_twins.randomize_(tower_twins.VGG16Twin(), 31)}
    for d in ("jcache", "tcache"):
        os.makedirs(tmp_path / d)
        for name, twin in sd.items():
            torch.save(twin.state_dict(), str(tmp_path / d / name))
    got, want = _evaluate_both(monkeypatch, job, out, tmp_path)
    for k in IMAGE_KEYS:
        np.testing.assert_allclose(got[k]["mean"], want[k]["mean"], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
