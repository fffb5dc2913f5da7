"""The port's offline dataset build nets against the JAX package, on the CPU:
ISNet and BASNet (`preprocess/saliency_models.py`), `cli.saliency`, LaMa
(`preprocess/lama.py`) and `inpaint` (`preprocess/inpainting.py`).

  * The saliency modules on JAX's variables (`load_jax_params`), drawn from
    numpy on the tree of `jax.eval_shape(init)` with random BatchNorm
    statistics (flax's initial ones make BatchNorm the identity, where a
    wrong conversion would not show): REBNConv, RSUBlock, RSU4F, ISNetDIS at
    64^2 and 128^2, BASNet at 64^2, the sides with full=True, and train
    mode's batch statistics and running averages.  Limit: 1e-4 absolute on
    the maps, the towers' limit.
  * The released checkpoints' loaders against JAX's converters on random
    upstream-named state_dicts (BASNet's unused bn6d_2 among them).
  * `basnet_preprocess` divides by the max of the whole batch.
  * `cli.saliency --model basnet` of both packages in process on one `.pth`
    and three tiny PNGs: the PNGs within one grey level; the port's ISNet
    branch at a patched size against JAX's ISNetDIS on the same variables.
  * LaMa: JAX's params (`convert_lama_state_dict` of tests/test_lama.py's
    torch twin) through `lama_state_dict_from_jax` into the port's generator
    against `lama_forward`, within 3e-4 (tests/test_lama.py's limit); the
    default tree against the twin's keys and shapes; `inpaint` of both
    packages on one TorchScript file; `infer_config`, `pad_to_modulo` and the
    missing file.
  * `box_union_mask` equal to JAX's.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ralf_tpu.cli import saliency as jcli
from ralf_tpu.core.layout import random_layout
from ralf_tpu.preprocess import inpainting as jinp
from ralf_tpu.preprocess import lama as jlama
from ralf_tpu.preprocess import saliency_models as jsal
from ralf_tpu_torch.cli import saliency as tcli
from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.preprocess import inpainting as tinp
from ralf_tpu_torch.preprocess import lama as tlama
from ralf_tpu_torch.preprocess import saliency_models as tsal
from ralf_tpu_torch.utils.weights import load_jax_params, save_params_npz
from test_lama import TINY, _randomize_bn, build_torch_lama

torch.set_num_threads(2)
TOL = 1e-4  # absolute, on maps in [0, 1]
LAMA_TOL = 3e-4  # tests/test_lama.py


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _variables(module, x, seed: int, **kw) -> dict:
    """Variables of `module` at input `x` drawn from numpy on the tree of
    jax.eval_shape(init), BatchNorm's statistics and affine random."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw))

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.3 if name == "mean" else 0.2, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.normal(1.0, 0.2, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, fan_in**-0.5, leaf.shape).astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, dict(t)) for c, t in shapes.items()}


def _load(tmod, v):
    load_jax_params(tmod, v["params"], v["batch_stats"])
    return tmod.eval()


def _img(seed: int, B: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).random((B, size, size, 3), dtype=np.float32) - 0.5


# ---- the saliency modules on JAX's variables ------------------------------------------


@pytest.mark.parametrize("name,jmod,tmod,cin", [
    ("rebnconv", jsal.REBNConv(8, dirate=2), tsal.REBNConv(3, 8, dirate=2), 3),
    ("rsu", jsal.RSUBlock(4, 8, 16), tsal.RSUBlock(4, 3, 8, 16), 3),
    ("rsu4f", jsal.RSU4F(8, 16), tsal.RSU4F(5, 8, 16), 5),
])
def test_blocks_match_jax(name, jmod, tmod, cin):
    x = np.random.default_rng(1).random((2, 32, 32, cin), dtype=np.float32) - 0.5
    v = _variables(jmod, x, 1)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(_load(tmod, v)(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_block_train_mode_matches_jax():
    """BatchNorm with the batch's statistics (flax: momentum 0.99, the biased
    variance) in the output and in the running averages."""
    jmod, tmod = jsal.RSUBlock(4, 8, 16), tsal.RSUBlock(4, 3, 8, 16)
    x = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    v = _variables(jmod, x, 2)
    want, upd = jmod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    _load(tmod, v).train()
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    for path, stat in jax.tree_util.tree_leaves_with_path(upd["batch_stats"]):
        keys = [p.key for p in path]
        buf = {"mean": "running_mean", "var": "running_var"}[keys[-1]]
        t = tmod.get_submodule(".".join(keys[:-1])).get_buffer(buf)
        np.testing.assert_allclose(t.numpy(), np.asarray(stat), atol=1e-5, rtol=1e-5,
                                   err_msg="/".join(keys))


@pytest.fixture(scope="module")
def isnet():
    """(JAX's ISNetDIS, its variables, the port's loaded with them)."""
    jmod = jsal.ISNetDIS()
    v = _variables(jmod, _img(0, 1, 64), 3)
    return jmod, v, _load(tsal.ISNetDIS(), v)


@pytest.fixture(scope="module")
def basnet():
    """BASNet's tree with full=True: its setup's side convs are not reached
    otherwise, and the released file holds them."""
    jmod = jsal.BASNet()
    v = _variables(jmod, _img(0, 1, 64), 4, full=True)
    return jmod, v, _load(tsal.BASNet(), v)


@pytest.mark.parametrize("size", [64, 128])
def test_isnet_matches_jax(isnet, size):
    jmod, v, tmod = isnet
    x = _img(5, 2, size)
    want = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(_nchw(x)).numpy()
    assert got.shape == (2, size, size)
    assert want.max() - want.min() > 0.05  # the maps are no constants
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_isnet_full_matches_jax(isnet):
    jmod, v, tmod = isnet
    x = _img(6, 2, 64)
    sides_j, feats_j = jax.jit(lambda v, x: jmod.apply(v, x, full=True))(v, jnp.asarray(x))
    with torch.no_grad():
        sides_t, feats_t = tmod(_nchw(x), full=True)
    for i, (a, b) in enumerate(zip(sides_t, sides_j)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=f"side {i + 1}")
    for i, (a, b) in enumerate(zip(feats_t, feats_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(_nhwc(a), b, atol=TOL * max(1.0, np.abs(b).max()), rtol=0,
                                   err_msg=f"feature {i + 1}")


@pytest.mark.parametrize("full", [False, True])
def test_basnet_matches_jax(basnet, full):
    jmod, v, tmod = basnet
    x = _img(7, 2, 64)
    want = jax.jit(lambda v, x: jmod.apply(v, x, full=full))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x), full=full)
    if not full:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        return
    assert len(got) == len(want) == 8
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=TOL, rtol=0, err_msg=f"out {i}")


# ---- the released checkpoints ------------------------------------------------------------


def _upstream(tmod, kind: str, seed: int) -> dict:
    """A random state_dict under the upstream torch names of `tmod`'s tree:
    BatchNorm's step counters and, for BASNet, the unused bn6d_2 included."""
    g = torch.Generator().manual_seed(seed)

    def draw(k, shape):
        x = torch.randn(shape, generator=g)
        if len(shape) == 4:
            return x * (shape[1] * shape[2] * shape[3]) ** -0.5
        if k.endswith("running_var"):
            return torch.rand(shape, generator=g) + 0.5
        return x * 0.2 + (1.0 if k.endswith("weight") else 0.0)  # BatchNorm's scale near 1

    sd = {}
    for k, v in tmod.state_dict().items():
        if kind == "basnet":
            k = k.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
            head, _, rest = k.partition(".")
            if head.startswith("encoder"):
                k = head.replace("_", ".") + "." + rest
        sd[k] = draw(k, tuple(v.shape))
        if k.endswith("running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    if kind == "basnet":
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"bn6d_2.{leaf}"] = draw(leaf, (512,))
        sd["bn6d_2.num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.mark.parametrize("kind", ["isnet", "basnet"])
def test_released_loaders_match_jax_converters(kind, tmp_path):
    make = tsal.ISNetDIS if kind == "isnet" else tsal.BASNet
    sd = _upstream(make(), kind, seed=8)
    assert kind == "isnet" or "encoder2.0.downsample.1.running_var" in sd
    convert = jsal.convert_isnet_state_dict if kind == "isnet" else jsal.convert_basnet_state_dict
    via_jax = _load(make(), convert(sd))
    path = str(tmp_path / f"{kind}.pth")
    torch.save(sd, path)
    port = make()
    tsal.load_released(port, path, kind)  # strict: every tensor filled, none left over
    ours = port.state_dict()
    assert "bn6d_2.weight" not in ours
    for k, t in via_jax.state_dict().items():
        assert torch.equal(ours[k], t), k
    # {"state_dict": ...} holds the same
    torch.save({"state_dict": sd}, path)
    tsal.load_released(make(), path, kind)


def test_basnet_preprocess_divides_by_the_batch_max():
    """JAX's tester normalises by the max of the whole batch: an image's net
    input depends on the others'."""
    imgs = np.random.default_rng(9).random((3, 8, 8, 3), dtype=np.float32)
    imgs *= np.asarray([0.5, 1.0, 0.25], np.float32)[:, None, None, None]
    got = tsal.basnet_preprocess(imgs)
    np.testing.assert_array_equal(got, jsal.basnet_preprocess(imgs))
    alone = tsal.basnet_preprocess(imgs[:1])
    assert np.abs(alone - got[:1]).max() > 0.1
    np.testing.assert_array_equal(tsal.isnet_preprocess(imgs), jsal.isnet_preprocess(imgs))


# ---- cli.saliency ------------------------------------------------------------------------


def _pngs(d, sizes):
    os.makedirs(d)
    rng = np.random.default_rng(10)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, f"{i}.png"))
    return d


def test_saliency_cli_basnet_matches_jax(tmp_path, monkeypatch):
    """Both CLIs in process on the same .pth and three tiny PNGs of other
    sizes: the written maps equal within one grey level."""
    inp = _pngs(str(tmp_path / "in"), [(30, 20), (17, 23), (40, 40)])
    sd = _upstream(tsal.BASNet(), "basnet", seed=11)
    weights = str(tmp_path / "gdi-basnet.pth")
    torch.save(sd, weights)
    outs = {p: str(tmp_path / p) for p in ("jax", "port")}
    common = ["--model", "basnet", "--input-dir", inp, "--weights", weights, "--batch-size", "2"]
    monkeypatch.setattr(sys, "argv", ["saliency", *common, "--output-dir", outs["jax"]])
    jcli.main()
    tcli.main([*common, "--output-dir", outs["port"], "--device", "cpu"])
    names = sorted(os.listdir(inp))
    assert sorted(os.listdir(outs["jax"])) == sorted(os.listdir(outs["port"])) == names
    for n in names:
        a, b = (np.asarray(Image.open(os.path.join(outs[p], n)), np.int16) for p in outs)
        assert a.shape == b.shape == np.asarray(Image.open(os.path.join(inp, n))).shape[:2]
        assert np.abs(a - b).max() <= 1, n
        assert a.max() - a.min() > 50  # the min-max spans the grey range


def test_saliency_cli_isnet_at_a_patched_size(isnet, tmp_path, monkeypatch):
    """The ISNet branch of the port's CLI (weights from a flat .npz of JAX's
    variables) at 64^2 against JAX's ISNetDIS on the same variables and the
    same PIL resizes; an orbax directory is refused with a hint."""
    jmod, v, _ = isnet
    monkeypatch.setattr(tcli, "SIZES", {**tcli.SIZES, "isnet": 64})
    inp = _pngs(str(tmp_path / "in"), [(30, 20), (50, 70)])
    weights = str(tmp_path / "isnet.npz")
    save_params_npz(weights, v["params"], v["batch_stats"])
    out = str(tmp_path / "out")
    tcli.main(["--model", "isnet", "--input-dir", inp, "--output-dir", out, "--weights", weights,
               "--device", "cpu"])
    fwd = jax.jit(jmod.apply)
    for n in sorted(os.listdir(inp)):
        im = Image.open(os.path.join(inp, n)).convert("RGB")
        x = np.asarray(im.resize((64, 64)), np.float32)[None] / 255.0
        sal = np.asarray(fwd(v, jnp.asarray(jsal.isnet_preprocess(x))))
        sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-8)
        want = np.asarray(Image.fromarray((sal[0] * 255).astype(np.uint8)).resize(im.size), np.int16)
        got = np.asarray(Image.open(os.path.join(out, n)), np.int16)
        assert np.abs(got - want).max() <= 1, n
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(ValueError, match="orbax"):
        tcli.build_net("isnet", str(tmp_path / "orbax"), "cpu")


# ---- LaMa --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin():
    torch.manual_seed(0)
    model = build_torch_lama(TINY).eval()
    _randomize_bn(model)
    return model


def test_lama_from_jax_params_matches_lama_forward(twin):
    params = jlama.convert_lama_state_dict(twin.state_dict())
    gen = tlama.build_generator(tlama.lama_state_dict_from_jax(params))
    assert (dataclasses.astuple(tlama.infer_config(gen.state_dict()))
            == dataclasses.astuple(jlama.infer_config(params)) == dataclasses.astuple(TINY))
    rng = np.random.default_rng(12)
    img = rng.random((2, 40, 32, 3), np.float32)
    mask = (rng.random((2, 40, 32, 1)) > 0.8).astype(np.float32)
    want = np.asarray(jlama.lama_forward(params, img, mask, TINY))
    with torch.no_grad():
        got = _nhwc(gen(_nchw(img), _nchw(mask)))
    np.testing.assert_allclose(got, want, atol=LAMA_TOL, rtol=0)
    # the twin's own state_dict (prefixes, counters) loads the same generator
    port = tlama.build_generator(tlama.convert_lama_state_dict(twin.state_dict()))
    for k, t in gen.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], t, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [tlama.LamaConfig(ngf=8, n_blocks=2),
                                 tlama.LamaConfig(ngf=16, n_blocks=18)])
def test_lama_default_tree_is_the_upstream_tree(cfg):
    """The tree built from the config alone has the upstream generator's
    keys and shapes (the global branch from the last downsampling on);
    built from those keys it is the same tree."""
    want = {k: tuple(v.shape) for k, v in build_torch_lama(cfg).state_dict().items()
            if "num_batches_tracked" not in k}
    sd = tlama.LamaGenerator(cfg).state_dict()
    got = {k: tuple(v.shape) for k, v in sd.items()}
    assert got == want
    again = tlama.LamaGenerator(tlama.infer_config(sd), got).state_dict()
    assert {k: tuple(v.shape) for k, v in again.items()} == want


def test_lama_builds_its_paths_from_the_keys(twin):
    """An FFC whose keys are absent has no such path: a state_dict without
    a block's local-to-global conv builds a generator without it."""
    sd = tlama.convert_lama_state_dict(twin.state_dict())
    cut = {k: v for k, v in sd.items() if not k.startswith("model.5.conv1.ffc.convl2g.")}
    gen = tlama.build_generator(cut)
    assert not hasattr(gen.model["5"].conv1.ffc, "convl2g")
    assert hasattr(gen.model["5"].conv2.ffc, "convl2g")


def test_inpaint_matches_jax(twin, tmp_path):
    """Both packages' `inpaint` on one TorchScript file, through the loader,
    infer_config, the padding to 8 and the crop."""
    path = str(tmp_path / "big-lama.pt")
    torch.jit.trace(twin, (torch.rand(1, 3, 40, 32), torch.zeros(1, 1, 40, 32))).save(path)
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (3, 37, 30, 3), dtype=np.uint8)
    masks = np.where(rng.random((3, 37, 30)) > 0.7, 255, 0).astype(np.uint8)
    want = jinp.inpaint(images, masks, lama_path=path, batch_size=2)
    got = tinp.inpaint(images, masks, lama_path=path, batch_size=2, device="cpu")
    assert got.shape == want.shape == (3, 37, 30, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LAMA_TOL, rtol=0)


def test_pad_to_modulo_and_the_missing_file(tmp_path):
    arr = np.random.default_rng(14).random((2, 37, 50, 3), dtype=np.float32)
    (got, hw), (want, jhw) = tlama.pad_to_modulo(arr), jlama.pad_to_modulo(arr)
    assert got.shape == (2, 40, 56, 3) and hw == jhw == (37, 50)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 37:40, :50], arr[:, 36:33:-1])  # "symmetric": the edge twice
    with pytest.raises(FileNotFoundError, match="big-lama"):
        tinp.inpaint(np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 8, 8), np.uint8),
                     lama_path=str(tmp_path / "big-lama.pt"), device="cpu")


def test_box_union_mask_matches_jax():
    lay = random_layout(np.random.default_rng(15), 4, 10, 3)
    want = jinp.box_union_mask(lay, 64, 48)
    port = Layout.fromdict({k: np.asarray(getattr(lay, k)) for k in
                            ("label", "center_x", "center_y", "width", "height", "mask")})
    got = tinp.box_union_mask(port, 64, 48)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and 0 < (got == 255).mean() < 1
    np.testing.assert_array_equal(tinp.box_union_mask(port, 64, 48, dilate=0),
                                  jinp.box_union_mask(lay, 64, 48, dilate=0))
