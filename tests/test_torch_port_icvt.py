"""ICVT in the port against the JAX package: its tokenizer, the GA key
grid, the image encoder and one decode of the GA decoder stack under each
GA type, the argmax sample loop's ids under JAX's latent, the port's own
latent by its frequencies, and K1's plain version at ICVT's head width of
25 against the Pallas kernel in interpret mode.

The model is tiny (d_model 40, a multiple of 4 and 5 as ICVT needs; 4 heads
in the image encoder, 1+1 layers, resnet18, 64x48 canvases), initialised in
JAX and loaded into the port through the weights bridge; both run on the
CPU in float32.  Logits agree within 1e-4 absolute + 1e-4 relative; ids
and tokenizer outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu import config as jconfig
from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import icvt as jicvt
from ralf_tpu.models.base import GeneratorConfig as JGenCfg
from ralf_tpu.ops.pallas.encoder_attention import fused_encoder_attention
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.core.layout import Layout as TLayout
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import icvt as ticvt
from ralf_tpu_torch.models.base import GeneratorConfig as TGenCfg
from ralf_tpu_torch.models.base import build_core
from ralf_tpu_torch.ops import encoder_attention as ea
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-4
HW = (64, 48)
TINY = ["model.d_model=40", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.backbone=resnet18", f"dataset.image_h={HW[0]}",
        f"dataset.image_w={HW[1]}", "debug=true", "synthetic_data=true"]
ATTRS = ("label", "center_x", "center_y", "width", "height")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def icvt():
    """(JAX generator, port generator, JAX variables, (JAX batch, port batch))"""
    jcfg, tcfg = jconfig.build_config("icvt", TINY), tconfig.build_config("icvt", TINY)
    jg = jconfig.build_generator(jcfg, None)
    tg = tconfig.build_generator(tcfg, None, device="cpu")
    v = _np(jg.init(jax.random.PRNGKey(0)))
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    kw = dict(shuffle=False, transforms=(), use_native=False)
    jb = next(iter(jdata.BatchLoader(jconfig.build_datasets(jcfg)[2], 4, prefetch=0, **kw)))
    tb = next(iter(tdata.BatchLoader(tconfig.build_datasets(tcfg)[2], 4, **kw)))
    return jg, tg, v, (jb, tb)


def test_tokenizer_matches_jax():
    """Per-attribute buckets with BG for padding, and back."""
    rng = np.random.default_rng(0)
    mask = rng.random((5, 10)) > 0.4
    d = {"label": np.where(mask, rng.integers(0, 3, (5, 10)), 0).astype(np.int32), "mask": mask}
    for k in ATTRS[1:]:
        d[k] = np.where(mask, rng.uniform(0, 1, (5, 10)), 0).astype(np.float32)
    d["center_x"][0, :3] = (0.0, 1.0, 0.5)  # the edges and a boundary
    jt, tt = jicvt.ICVTTokenizer(3), ticvt.ICVTTokenizer(3)
    want = jt.encode(JLayout(**d))
    got = tt.encode(TLayout.fromdict(d))
    for k in (*ATTRS, "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    back = tt.decode(got).numpy()
    want_back = jt.decode(want)
    for k in (*ATTRS, "mask"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(want_back, k)), err_msg=k)


def test_ga_key_grid_matches_jax(icvt):
    jg, tg, v, _ = icvt
    want = jg.core.apply(v, 3, method=jicvt.ICVTCore.ga_key_grid)
    with torch.no_grad():
        got = tg.core.ga_key_grid(3)
    assert got.shape == (3, 4 * 3, 40)  # the 64x48 canvas's 4x3 grid
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_image_encoder_and_decode_step_match_jax(icvt):
    """encode_image (K1's plain version in the encoder) and every
    attribute's logits of one causal decode of a random target, whose GA
    query is the pre-PE target."""
    jg, tg, v, (jb, tb) = icvt
    want_mem = jg.core.apply(v, jnp.asarray(jb["image"]), method=jicvt.ICVTCore.encode_image)
    with torch.no_grad():
        mem = tg.core.encode_image(torch.from_numpy(tb["image"]))
    _close(mem.numpy(), np.asarray(want_mem))
    tgt = np.random.default_rng(1).normal(size=(4, 10, 40)).astype(np.float32)
    ga_k = jg.core.apply(v, 4, method=jicvt.ICVTCore.ga_key_grid)
    want = jg.core.apply(v, jnp.asarray(tgt), want_mem, ga_k,
                         method=jicvt.ICVTCore.decode_step_stack)
    with torch.no_grad():
        got = tg.core.decode_step_stack(torch.from_numpy(tgt), torch.from_numpy(np.array(want_mem)),
                                        tg.core.ga_key_grid(4))
    for k in ATTRS:
        _close(got[k].numpy(), np.asarray(want[k]))
    emb_ids = {k: np.random.default_rng(2).integers(0, 4, (4, 10)) for k in ATTRS}
    want_e = jg.core.apply(v, {k: jnp.asarray(a) for k, a in emb_ids.items()},
                           method=jicvt.ICVTCore.embed_layout)
    with torch.no_grad():
        got_e = tg.core.embed_layout({k: torch.from_numpy(a) for k, a in emb_ids.items()})
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))


@pytest.mark.parametrize("ga_type", ["add", None])
def test_other_ga_types_match_jax(ga_type):
    """ga_type "add" (the key carries the grid, the value not) and None (a
    plain cross-attention): the trees load whole (no cross_out), and a decode
    agrees."""
    jcfg = JGenCfg(d_model=40, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
                   backbone="resnet18")
    jcore = jicvt.ICVTCore(num_labels=3, ga_type=ga_type, image_hw=HW, cfg=jcfg)
    jgen = jicvt.ICVTGenerator(3, jcfg, ga_type=ga_type, image_hw=HW)
    v = _np(jgen.init(jax.random.PRNGKey(3)))
    tcfg = TGenCfg(d_model=40, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
                   backbone="resnet18")
    tcore = build_core(lambda: ticvt.ICVTCore(3, ga_type=ga_type, image_hw=HW, cfg=tcfg), tcfg,
                       torch.device("cpu"), 0)
    load_jax_params(tcore, v["params"], v["batch_stats"])
    rng = np.random.default_rng(4)
    tgt = rng.normal(size=(2, 10, 40)).astype(np.float32)
    mem = rng.normal(size=(2, 12, 40)).astype(np.float32)
    ga_k = jcore.apply(v, 2, method=jicvt.ICVTCore.ga_key_grid)
    want = jcore.apply(v, jnp.asarray(tgt), jnp.asarray(mem), ga_k,
                       method=jicvt.ICVTCore.decode_step_stack)
    with torch.no_grad():
        got = tcore.decode_step_stack(torch.from_numpy(tgt), torch.from_numpy(mem),
                                      tcore.ga_key_grid(2))
    for k in ATTRS:
        _close(got[k].numpy(), np.asarray(want[k]))


def test_ids_equal_jax_under_jax_latent(icvt):
    """The argmax loop's layouts from JAX's z, twice in a row from one numpy
    rng: equal, and the rng's stream in step (each sample draws one key)."""
    jg, tg, v, (jb, tb) = icvt
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(2):
        z = jax.random.normal(jax.random.PRNGKey(i), (4, 1, 40))
        want = jg.sample(v, jb, jr, z=z)
        got = tg.sample(tb, tr, z=torch.from_numpy(np.asarray(z))).numpy()
        for k in (*ATTRS, "mask"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
        assert got["mask"].any()
    assert jr.integers(1 << 30) == tr.integers(1 << 30)


def test_port_latent_by_its_frequencies(icvt):
    """The port's z ~ N(0, I): 4096 x 40 draws, mean within 5 standard
    errors of 0, standard deviation within 1%, rows of one call distinct; the
    same seed gives the same z, and sample(z=None) reads it from the rng."""
    _, tg, _, (_, tb) = icvt
    z = tg.draw_latent(4096, 11)
    assert z.shape == (4096, 1, 40) and z.dtype == torch.float32
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n**0.5
    assert abs(float(z.std()) - 1.0) < 0.01
    assert torch.equal(z, tg.draw_latent(4096, 11)) and not torch.equal(z, tg.draw_latent(4096, 12))
    seed = int(np.random.default_rng(6).integers(2**31))
    a = tg.sample(tb, np.random.default_rng(6)).numpy()
    b = tg.sample(tb, np.random.default_rng(6), z=tg.draw_latent(4, seed)).numpy()
    for k in (*ATTRS, "mask"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,mask", [(2, 330, "none"), (3, 33, "keys"), (4, 11, "dead_rows")])
def test_k1_plain_at_head_width_25_matches_pallas(dtype, B, S, mask):
    """K1's plain version (what the wrapper runs on CPU tensors) at E=200,
    H=8, Dh=25 against the Pallas kernel in interpret mode: fp32 to 1e-5,
    bf16 within one rounding of the output (atol 1e-3, rtol 2^-7)."""
    E, H = 200, 8
    rng = np.random.default_rng(B * 100 + S)
    q = rng.normal(size=(B, S, E)).astype(np.float32) * (E // H) ** -0.5
    k, v = (rng.normal(size=(B, S, E)).astype(np.float32) for _ in range(2))
    bias = None
    if mask != "none":
        keep = rng.random((B, S)) > 0.3
        if mask == "dead_rows":
            keep[1] = False
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = fused_encoder_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), H,
                                  None if bias is None else jnp.asarray(bias), interpret=True)
    out = ea.encoder_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), H,
                               None if bias is None else torch.from_numpy(bias))
    assert out.dtype == tdt
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-3, rtol=2**-7)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)
