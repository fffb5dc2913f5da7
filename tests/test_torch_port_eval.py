"""The port's evaluation metrics against the JAX package's, and the golden
cases of tests/test_metrics.py held for the port.

Seeded random layouts (with empty, single-element, underlay-only, tiny and
off-canvas samples) and canvases go through both packages in float32 on
the CPU.  Tolerance: 1e-6 absolute for the heuristic metrics (they differ
only by float32 summation order), 1e-5 for the normalised Sobel map (its
convolution sums in another order, then a division by the peak); the pixel
rasters and validity masks are exact; FID and prdc are the same numpy and
must be equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.eval import export_tex as jtex
from ralf_tpu.eval import metrics as jm
from ralf_tpu.eval import visualizer as jvis
from ralf_tpu_torch.core.layout import Layout as TLayout
from ralf_tpu_torch.eval import export_tex as ttex
from ralf_tpu_torch.eval import metrics as tm
from ralf_tpu_torch.eval import visualizer as tvis

ATOL = 1e-6
UNDERLAY, TEXT = 2, 1


def _arrays(B=48, S=10, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, size=B)
    n[:4] = (0, 1, 2, S)
    mask = np.arange(S)[None] < n[:, None]
    label = rng.integers(0, 3, size=(B, S))
    label[4] = UNDERLAY  # underlays only
    geo = {"center_x": rng.uniform(-0.1, 1.1, (B, S)), "center_y": rng.uniform(-0.1, 1.1, (B, S)),
           "width": rng.uniform(0.0, 0.7, (B, S)), "height": rng.uniform(0.0, 0.7, (B, S))}
    geo["width"][5, :3] = 0.01  # below the validity area
    geo["center_x"][6, :4] = 0.3  # aligned edges, nested boxes
    geo["width"][6, :4] = (0.2, 0.4, 0.6, 0.2)
    out = {"label": np.where(mask, label, 0).astype(np.int64), "mask": mask}
    out.update({k: np.where(mask, v, 0).astype(np.float32) for k, v in geo.items()})
    out["center_x"][7] = np.where(mask[7], 0.5, 1.0)  # garbage in the padding
    return out


def _pair(arrays):
    return JLayout.fromdict(arrays), TLayout.fromdict(arrays)


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_layout_metrics_match_jax(seed):
    jl, tl = _pair(_arrays(seed=seed))
    _close(tm.compute_alignment(tl), jm.compute_alignment(jl))
    _close(tm.compute_overlap(tl), jm.compute_overlap(jl))
    _close(tm.compute_overlay(tl, UNDERLAY), jm.compute_overlay(jl, UNDERLAY))
    jue, tue = jm.compute_underlay_effectiveness(jl, UNDERLAY), \
        tm.compute_underlay_effectiveness(tl, UNDERLAY)
    assert list(tue) == list(jue)
    for k in jue:
        _close(tue[k], jue[k])
    (jf, jr), (tf, tr) = jm.compute_validity(jl), tm.compute_validity(tl)
    assert float(tr) == pytest.approx(float(jr), abs=ATOL)
    for k, a in tf.numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jf, k)), err_msg=k)
    for name in ("alignment", "overlap"):
        fn_t, fn_j = getattr(tm, f"compute_{name}"), getattr(jm, f"compute_{name}")
        _close(fn_t(tf), fn_j(jf))
    assert tm.nanmean(tm.compute_overlay(tl, UNDERLAY)) == pytest.approx(
        jm.nanmean(jm.compute_overlay(jl, UNDERLAY)), abs=ATOL)


@pytest.mark.parametrize("hw", [(40, 32), (35, 24)])
def test_saliency_metrics_and_raster_match_jax(hw):
    H, W = hw
    arrays = _arrays(B=12, seed=2)
    jl, tl = _pair(arrays)
    rng = np.random.default_rng(3)
    img = rng.random((12, H, W, 4)).astype(np.float32)
    img[0] = 0.5  # flat canvas: no gradient
    keep = arrays["mask"] & (arrays["label"] == TEXT)
    np.testing.assert_array_equal(
        tm.pixel_box_mask(tl, H, W, torch.from_numpy(keep)).numpy(),
        np.asarray(jm._pixel_box_mask(jl, H, W, jnp.asarray(keep))))
    _close(tm.sobel_gradient_map(torch.from_numpy(img[..., :3])),
           jm.sobel_gradient_map(jnp.asarray(img[..., :3])), atol=1e-5)
    want = jm.compute_saliency_aware_metrics(jl, jnp.asarray(img), TEXT, UNDERLAY)
    got = tm.compute_saliency_aware_metrics(tl, torch.from_numpy(img), TEXT, UNDERLAY)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_generative_scores_are_jax_numpy():
    rng = np.random.default_rng(0)
    real = rng.normal(size=(64, 16))
    fake = rng.normal(0.3, 1.1, size=(48, 16))
    assert tm.compute_generative_model_scores(real, fake) == \
        jm.compute_generative_model_scores(real, fake)
    assert tm.frechet_distance(real, fake) == jm.frechet_distance(real, fake)
    assert tm.compute_prdc(real, fake, 3) == jm.compute_prdc(real, fake, 3)
    vals = np.asarray([0.5, np.nan, 1.5], np.float32)
    assert tm.nanmean(torch.from_numpy(vals)) == jm.nanmean(vals) == 1.0
    assert math.isnan(tm.nanmean(np.asarray([np.nan])))


# ---- the golden cases of tests/test_metrics.py ------------------------------

LABELS = {"text": 0, "logo": 1, "underlay": 2}
S = 4


def make_layout(label_names, cx, cy, w, h):
    n = len(label_names)
    pad = lambda xs: np.pad(np.asarray(xs, np.float32), (0, S - n))[None]  # noqa: E731
    return TLayout.fromdict({
        "label": np.pad(np.asarray([LABELS[x] for x in label_names]), (0, S - n))[None],
        "center_x": pad(cx), "center_y": pad(cy), "width": pad(w), "height": pad(h),
        "mask": (np.arange(S) < n)[None]})


UNDERLAY_CASES = [
    (["text", "underlay"], [0.5, 0.5], [0.5, 0.5], [0.2, 0.4], [0.2, 0.4], 1.0, 1.0),
    (["text", "underlay"], [0.1, 0.9], [0.1, 0.9], [0.2, 0.2], [0.2, 0.2], 0.0, 0.0),
    (["text", "underlay"], [0.5, 0.5], [0.5, 0.5], [0.2, 0.6], [0.6, 0.2], 1 / 3, 0.0),
    (["text", "underlay", "text"], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.2, 0.6, 0.3],
     [0.6, 0.2, 0.1], 1.0, 1.0),
    (["text", "underlay", "underlay"], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.2, 0.3, 0.4],
     [0.2, 0.3, 0.4], 1.0, 1.0),
]


@pytest.mark.parametrize("case", UNDERLAY_CASES)
def test_golden_underlay_effectiveness(case):
    labels, cx, cy, w, h, loose, strict = case
    out = tm.compute_underlay_effectiveness(make_layout(labels, cx, cy, w, h), LABELS["underlay"])
    assert math.isclose(float(out["underlay_effectiveness_loose"][0]), loose, rel_tol=1e-4)
    assert math.isclose(float(out["underlay_effectiveness_strict"][0]), strict, rel_tol=1e-4)


def test_golden_overlay_alignment_overlap_validity():
    lay = make_layout(["text"] * 3, [0.3, 0.5, 0.7], [0.5] * 3, [0.4] * 3, [0.4] * 3)
    assert math.isclose(float(tm.compute_overlay(lay, LABELS["underlay"])[0]),
                        (1 / 3 + 1 / 3 + 0) / 3, rel_tol=1e-4)
    for labels in (["text"], ["underlay"]):
        one = make_layout(labels, [0.3], [0.5], [0.4], [0.4])
        assert math.isnan(float(tm.compute_overlay(one, LABELS["underlay"])[0]))
    aligned = make_layout(["text", "text"], [0.3, 0.3], [0.2, 0.8], [0.2, 0.2], [0.2, 0.2])
    assert float(tm.compute_alignment(aligned)[0]) == pytest.approx(0.0, abs=1e-6)
    same = make_layout(["text", "text"], [0.5, 0.5], [0.5, 0.5], [0.2, 0.2], [0.2, 0.2])
    assert float(tm.compute_overlap(same)[0]) == pytest.approx(1.0, rel=1e-5)
    apart = make_layout(["text", "text"], [0.2, 0.8], [0.2, 0.8], [0.2, 0.2], [0.2, 0.2])
    assert float(tm.compute_overlap(apart)[0]) == pytest.approx(0.0, abs=1e-6)
    tiny = make_layout(["text", "text"], [0.5, 0.5], [0.5, 0.5], [0.2, 0.01], [0.2, 0.01])
    filtered, ratio = tm.compute_validity(tiny)
    assert float(ratio) == pytest.approx(0.5)
    assert bool(filtered.mask[0, 0]) and not bool(filtered.mask[0, 1])


def test_golden_saliency_aware_metrics():
    lay = make_layout(["text", "underlay"], [0.25, 0.75], [0.25, 0.75], [0.5, 0.5], [0.5, 0.5])
    img = np.zeros((1, 32, 32, 4), np.float32)
    img[..., :3] = 0.5
    img[0, :16, :16, 3] = 1.0
    out = tm.compute_saliency_aware_metrics(lay, torch.from_numpy(img), LABELS["text"],
                                            LABELS["underlay"])
    assert float(out["utilization"][0]) == pytest.approx(256 / 768, rel=1e-5)
    assert float(out["occlusion"][0]) == pytest.approx(0.5, rel=1e-5)
    assert float(out["unreadability"][0]) == pytest.approx(0.0, abs=1e-6)


def test_golden_generative_scores():
    feats = np.random.default_rng(0).normal(size=(256, 16))
    out = tm.compute_generative_model_scores(feats, feats.copy())
    assert out["fid"] == pytest.approx(0.0, abs=1e-6)
    assert out["precision"] == out["recall"] == out["coverage"] == pytest.approx(1.0)
    out2 = tm.compute_generative_model_scores(feats, feats + 10.0)
    assert out2["fid"] == pytest.approx(16 * 100.0, rel=1e-3)
    assert out2["precision"] == 0.0 and out2["recall"] == 0.0


# ---- rendering and the LaTeX export -------------------------------------------


def test_visualizer_matches_jax():
    arrays = _arrays(B=8, seed=4)
    jl, tl = _pair(arrays)
    img = np.random.default_rng(5).random((8, 30, 20, 4)).astype(np.float32)
    np.testing.assert_array_equal(tvis.render_layout(tl, img), jvis.render_layout(jl, img))
    np.testing.assert_array_equal(tvis.render_layout(tl, torch.from_numpy(img), alpha=0.3, border=1),
                                  jvis.render_layout(jl, img, alpha=0.3, border=1))
    np.testing.assert_array_equal(tvis.mask_out_bbox_area(tl, img), jvis.mask_out_bbox_area(jl, img))
    np.testing.assert_array_equal(tvis.montage(img[..., :3], ncols=4), jvis.montage(img[..., :3], 4))


def test_export_tex_matches_jax(tmp_path, capsys, monkeypatch):
    import json
    import sys

    for job, task, extra in (("ralf", "uncond", {}), ("autoreg", "c", {"fid": 0.25})):
        d = tmp_path / job / f"generated_samples_{task}"
        d.mkdir(parents=True)
        scores = {"alignment-LayoutGAN++": {"mean": 0.123456, "std": 0.0}, "validity": 0.99}
        scores.update({k: {"mean": v, "std": 0.1} for k, v in extra.items()})
        (d / "scores_all.json").write_text(json.dumps(scores))
    monkeypatch.setattr(sys, "argv", ["export_tex", "--jobs-root", str(tmp_path),
                                      "--out", str(tmp_path / "jax.tex")])
    jtex.main()
    ttex.main(["--jobs-root", str(tmp_path), "--out", str(tmp_path / "port.tex")])
    text = (tmp_path / "port.tex").read_text()
    assert text == (tmp_path / "jax.tex").read_text()
    assert "autoreg/c & 0.2500 & 0.1235" in text
    capsys.readouterr()
