"""The port's data-parallel training (`Trainer` and `GANTrainer` with a
mesh, `parallel/`) on the CPU over gloo, against a single process and
against JAX's `Trainer.fit` on its 8 CPU devices.

The ranks run in spawned processes (`tests/torch_port_ranks.py`) while this
process runs the single-process and JAX sides, on
tests/test_torch_port_train.py's tiny RALF and autoreg (JAX's initial
variables, its synthetic splits and loaders, batch 8) and on tiny maskgit
and cglgan presets:

  * world 2, a three-step `Trainer.fit` of ralf and of maskgit with dropout
    0.1 (the row-invariant masks, `parallel/rows.py`; maskgit's loss over the
    global count of masked tokens) against the single process's: the
    losses and val losses within LOSS_RTOL, the BatchNorm statistics after
    the first step within STATS_ATOL, and each top-level subtree's
    first-step averaged gradient and its change over the fit (the
    statistics' too) by cosine and norm ratio within DIRECTION_TOL of 1, as
    test_torch_port_train.py holds the statistics after the last step.  Not elementwise, nor bit for bit: the global batch's sums are the
    ranks' partial sums added, in another order than one process's, so the
    forward differs by its rounding (some 1e-6 in the image memory); a ReLU
    unit that close to 0 flips, and with it its whole contribution to a
    gradient (1.4% of the largest element of a cglgan discriminator FFN's
    gradient, measured); an attention key's bias, whose gradient is 0 up to
    rounding, takes AdamW steps lr * g / (|g| + eps) of pure noise, up to lr
    (2.2e-5 measured after 3 steps); one element in 16384 of ralf's
    attn/to_q moved by 1.9e-6 for a gradient near eps;
  * world 2, the ralf fit at dropout 0 against JAX's on its 8-device mesh by
    test_torch_port_train.py's measures (`assert_same_training`);
  * world 2, one cglgan GAN step against the single process's;
  * BatchNorm in train mode at world 2: the global batch's statistics and
    gradients, and the local batch's would not pass;
  * every step's collectives meet `assert_dp_train_hlo`;
  * world 4, the hybrid (dcn 2, data 2) mesh's step loss equals the flat
    (data 4) mesh's (tests/test_train_infra.py's hybrid test);
  * cli.train with train.gallery_shards=2 at world 2 (mesh (data 1, gallery
    2), the gallery's rows split) writes the checkpoint and metrics of the
    single-process cli.train: its retrieval table is the same.
"""

import json
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from test_torch_port_mesh import OVERRIDES, _flat_npz
from test_torch_port_train import CLI_TINY, assert_same_training, pairs, run_jax  # noqa: F401
from ralf_tpu_torch.parallel.mesh import assert_dp_train_hlo
from ralf_tpu_torch.utils.weights import export_params, load_params_npz

torch.set_num_threads(2)
LOSS_RTOL = 1e-6  # losses, world 2 against one process
STATS_ATOL = 1e-6  # BatchNorm statistics after the fit
DIRECTION_TOL = 1e-4  # 1 - cosine and |1 - norm ratio| of a subtree's gradient or change


def _cli_args(job, cache):
    return ["--experiment", "ralf", "--synthetic", "--debug", "--device", "cpu", "--job-dir",
            str(job), "--batch-size", "8", "--cache-dir", str(cache), *CLI_TINY]


@pytest.fixture(scope="module")
def runs(pairs, tmp_path_factory):  # noqa: F811  (the imported fixture)
    """The world-2 and world-4 ranks' results beside the single process's and
    JAX's; the work dir is removed at the end."""
    root = tmp_path_factory.mktemp("dp_train")
    params = {}
    for name in ("ralf", "autoreg"):
        params[name] = str(root / f"{name}.npz")
        _flat_npz(params[name], pairs[name][1])
    rng = np.random.default_rng(0)
    bn_x = rng.normal(1.0, 2.0, (8, 3, 5, 4)).astype(np.float32)
    bn_x[4:] += 3.0  # the two ranks' halves have other statistics
    bn_w = rng.normal(size=bn_x.shape).astype(np.float32)
    spec = {"params": params, "overrides": OVERRIDES, "bn_x": bn_x, "bn_w": bn_w,
            "cli": _cli_args(root / "cli_gs2", root / "cache_gs2") + ["train.gallery_shards=2"]}
    procs = {}
    for world, fn in ((2, ranks.dp_train), (4, ranks.hybrid_step)):
        d = root / f"world{world}"
        d.mkdir()
        with open(d / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        procs[world] = (ranks.start(fn, world, str(d)), d)
    # meanwhile: the single process and JAX
    single = {}
    single["ralf_0.1"] = ranks.fit(ranks.train_generator("ralf", params["ralf"], 0.1),
                                   ranks.train_loaders("ralf"), str(root / "single_ralf"))
    gen = ranks.port_generator("maskgit", OVERRIDES["maskgit"])
    init_maskgit = export_params(gen.core)
    single["maskgit"] = ranks.fit(gen, ranks.train_loaders("maskgit"), str(root / "single_mg"))
    gen = ranks.port_generator("cglgan", OVERRIDES["cglgan"])
    init_cglgan = {"gen": export_params(gen.core)[0],
                   "disc": export_params(gen.init_disc())[0]}
    gen.disc = None  # GANTrainer builds it as the ranks do
    single["cglgan"] = ranks.gan_step(gen, ranks.train_loaders("cglgan")[0],
                                      str(root / "single_gan"))
    single["bn"] = ranks.batchnorm_pass(bn_x, bn_w)
    jax_ralf = run_jax(pairs, "ralf", root / "jax_ralf", cap=3, epochs=1)
    from ralf_tpu_torch.cli import train as cli_train

    cli_train.main(_cli_args(root / "cli_gs1", root / "cache_gs1"))
    out = {w: ranks.finish(ctx, str(d)) for w, (ctx, d) in procs.items()}
    yield {"single": single, "jax_ralf": jax_ralf, "world2": out[2], "world4": out[4],
           "root": root, "init": pairs["ralf"][1],
           "init_ralf": (pairs["ralf"][1]["params"], pairs["ralf"][1]["batch_stats"]),
           "init_maskgit": init_maskgit, "init_cglgan": init_cglgan}
    shutil.rmtree(root, ignore_errors=True)  # the runs' checkpoints: some 3 GB


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _same_trees(got, want, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def _same_direction(got, want, what):
    """Cosine and norm ratio of two flat vectors within DIRECTION_TOL of 1
    (two zero vectors pass: a frozen subtree moves on neither side)."""
    n_got, n_want = np.linalg.norm(got), np.linalg.norm(want)
    if n_want == 0:
        assert n_got == 0, what
        return
    cos, ratio = float(got @ want) / (n_got * n_want), float(n_got / n_want)
    assert 1 - cos < DIRECTION_TOL and abs(1 - ratio) < DIRECTION_TOL, (what, cos, ratio)


def _same_updates(got, want, init):
    """Each top-level subtree's change from `init` (flax trees)."""
    for key in init:
        flat = [np.concatenate([a.ravel() for _, a in _leaves({key: t[key]})])
                for t in (got, want, init)]
        _same_direction(flat[0] - flat[2], flat[1] - flat[2], key)


def _same_gradients(got, want):
    """Each top-level module's gradient ({parameter name: gradient})."""
    assert got.keys() == want.keys()
    for top in sorted({k.split(".")[0] for k in want}):
        names = [k for k in sorted(want) if k.split(".")[0] == top]
        _same_direction(*(np.concatenate([g[k].ravel() for k in names]) for g in (got, want)),
                        top)


@pytest.mark.parametrize("name", ["ralf_0.1", "maskgit"])
def test_world2_fit_matches_the_single_process_with_dropout_on(runs, name):
    want = runs["single"][name]
    init_params, init_stats = runs["init_" + name.split("_")[0]]
    for r, rank in enumerate(runs["world2"]):
        params, stats, losses, records, first, _, grads = rank[name]
        assert len(losses) == 3
        np.testing.assert_allclose(losses, want[2], rtol=LOSS_RTOL, err_msg=f"rank {r}")
        _same_gradients(grads, want[6])
        _same_trees(first[0], want[4][0], STATS_ATOL)
        _same_updates(params, want[0], init_params)
        _same_updates(stats, want[1], init_stats)
    records = runs["world2"][0][name][3]  # rank 0 writes metrics.jsonl
    assert len(records) == len(want[3]) == 1
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(records[0][key], want[3][0][key], rtol=LOSS_RTOL)


def test_dropout_draws_matter(runs):
    """The fit with dropout 0 takes other steps: the comparison above has teeth."""
    on, off = runs["world2"][0]["ralf_0.1"][2], runs["world2"][0]["ralf_0.0"][2]
    assert on[0] != off[0]


def test_world2_fit_matches_jax_on_its_mesh(runs):
    t = runs["world2"][0]["ralf_0.0"][:5]
    assert_same_training(runs["jax_ralf"], t, runs["init"], 3)


def test_world2_gan_step_matches_the_single_process(runs):
    want = runs["single"]["cglgan"]
    for rank in runs["world2"]:
        got = rank["cglgan"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for g, w in zip(got["grads"], want["grads"]):
            _same_gradients(g, w)
        for net in ("gen", "disc"):
            _same_updates(got[net][0], want[net][0], runs["init_cglgan"][net])
            _same_trees(got[net][1], want[net][1], STATS_ATOL)


def test_batchnorm_takes_the_global_batch_statistics_and_gradients(runs):
    want = runs["single"]["bn"]
    world = runs["world2"]
    for rank in world:
        for k in ("mean", "var"):
            np.testing.assert_allclose(rank["bn"][k], want[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["bn"]["x_grad"] for r in world]),
                               want["x_grad"], rtol=1e-5, atol=1e-6)
    for k in ("w_grad", "b_grad"):  # the trainer averages these; their sum is the batch's
        np.testing.assert_allclose(sum(r["bn"][k] for r in world), want[k], rtol=1e-5, atol=1e-5)
    # the local batch's statistics (no row shard) would fail the comparison
    local = world[0]["bn_local"]
    assert np.abs(local["mean"] - want["mean"]).max() > 0.1
    assert np.abs(np.concatenate([r["bn_local"]["x_grad"] for r in world])
                  - want["x_grad"]).max() > 1e-3


def test_every_step_issues_all_reduces_only(runs):
    for rank in runs["world2"]:
        for name in ("ralf_0.1", "ralf_0.0", "maskgit"):
            for counts in rank[name][5]:
                assert_dp_train_hlo(counts)
    for counts in runs["single"]["ralf_0.1"][5]:
        assert counts == {}
        assert_dp_train_hlo(counts, expect_sync=False)
    with pytest.raises(AssertionError, match="other than all-reduce"):
        assert_dp_train_hlo({"all_reduce": 3, "all_gather": 1})
    with pytest.raises(AssertionError, match="never sync"):
        assert_dp_train_hlo({})


def test_hybrid_mesh_step_loss_equals_the_flat_mesh(runs):
    for r, rank in enumerate(runs["world4"]):
        assert rank["hybrid_mesh"] == ({"dcn": 2, "data": 2, "gallery": 1}, r, 4)
        assert rank["flat_mesh"] == ({"data": 4, "gallery": 1}, r, 4)
        assert rank["hybrid"][2] == rank["flat"][2]
        assert_dp_train_hlo(rank["hybrid"][5][0])


def test_gallery_shards_2_trains_the_single_process_checkpoint(runs):
    root = runs["root"]
    got, want = (load_params_npz(str(root / d / "ckpt_final.npz")) for d in ("cli_gs2",
                                                                              "cli_gs1"))
    for g, w in zip(got, want):  # data axis 1: the same sums in the same order
        _same_trees(g, w, 0.0)
    with open(root / "cli_gs2" / "metrics.jsonl") as f, \
            open(root / "cli_gs1" / "metrics.jsonl") as g:
        a, b = json.loads(f.readline()), json.loads(g.readline())
    np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=LOSS_RTOL)
    with open(root / "cli_gs2" / "config.json") as f:
        assert json.load(f)["train"]["gallery_shards"] == 2
    assert jax.device_count() == 8  # JAX's side ran on its 8 CPU devices
