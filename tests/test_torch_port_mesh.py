"""The port's batch-sharded samplers (`ralf_tpu_torch/parallel/`) on the CPU
over gloo, against a single process and against JAX's mesh samplers.

The ranks run in spawned processes (`tests/torch_port_ranks.py`: a gloo
group through a FileStore under tmp_path) while this process runs the JAX
side and the port's single-process path.  Tiny presets (d_model 32 or 40,
1+1 layers, resnet18, 64x48 canvases) on JAX's initial variables, batches
of 8 test canvases:

  * world 2, `top_p` (MaskGIT also with its re-masking noise): the tokens
    equal the single process's bit for bit (the row-invariant draws and
    the sample program's batch mean, `parallel/rows.py`), for autoreg
    uncond, RALF c, the relation decode with retries, MaskGIT and LayoutDM
    (c, and relation: its relation update's gradient);
  * world 2, deterministic sampling: the tokens equal the single process's
    and JAX's `build_mesh_sampler` on its 8 CPU devices, for autoreg uncond
    and c, the relation decode, MaskGIT, LayoutDM, CGL-GAN and ICVT (labels
    and masks exactly, boxes within 1e-5 as JAX's own test_mesh_zoo holds
    them; ICVT from JAX's z) and the retriever (exactly); RALF through
    `cli.inference --mesh on` against JAX's CLI at --mesh auto;
  * world 4: B=6 on 4 shards pads to 8 and strips, the tokens equal the
    single process's at the padded batch and JAX's on 4 devices;
  * every request: no collective inside the program, exactly one all-gather;
  * `build_mesh_sampler`'s two refusals.
"""

import csv
import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_port_ranks as ranks
from test_torch_port_diffusion import _kmeans_cache, _relation_inputs
from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.core import sampling as jsamp
from ralf_tpu.data import dataset as jdata
from ralf_tpu.parallel.decode import make_decode_mesh as j_decode_mesh
from ralf_tpu.parallel.zoo import build_mesh_sampler as j_build_mesh_sampler
from ralf_tpu.train.trainer import Trainer as JTrainer
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.parallel.decode import assert_clean_decode_hlo
from ralf_tpu_torch.parallel.zoo import build_mesh_sampler

torch.set_num_threads(2)
HW, B, TOP_K = (64, 48), 8, 4
BASE = ["model.nhead=4", "model.num_encoder_layers=1", "model.num_decoder_layers=1",
        "model.backbone=resnet18", f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}",
        "debug=true", "synthetic_data=true"]
OVERRIDES = {
    "autoreg": BASE + ["model.d_model=32", "model.dim_feedforward=64"],
    "ralf": BASE + ["model.d_model=32", "model.dim_feedforward=64", f"generator_kwargs.top_k={TOP_K}"],
    "maskgit": BASE + ["model.d_model=32", "model.dim_feedforward=64"],
    "layoutdm": BASE + ["model.d_model=32", "model.dim_feedforward=64",
                        "generator_kwargs.num_timesteps=12"],
    "cglgan": BASE + ["model.d_model=32", "model.dim_feedforward=64"],
    "icvt": BASE + ["model.d_model=40"],
    "retriever": BASE,
}
TOP_P = dict(name="top_p", top_p=0.9)
GREEDY = dict(name="deterministic", temperature=0.0)
BOX_ATOL = 1e-5  # GAN and ICVT boxes: JAX's test_mesh_zoo allowance across partitionings
# name: (preset, task or None, sampling, seed, mesh-sampler kwargs)
CASES = {
    "autoreg_uncond_top_p": ("autoreg", "uncond", TOP_P, 1, {}),
    "ralf_c_top_p": ("ralf", "c", TOP_P, 2, {}),
    "autoreg_relation_top_p": ("autoreg", "relation", TOP_P, 3, {"max_retries": 2}),
    "maskgit_c_top_p": ("maskgit", "c", dict(TOP_P, temperature=1.0), 4, {}),
    "layoutdm_c_top_p": ("layoutdm", "c", TOP_P, 5, {}),
    # the relation update's cost is a batch mean: a rank divides by the whole batch's count
    "layoutdm_relation_top_p": ("layoutdm", "relation", TOP_P, 16, {}),
    "autoreg_uncond_greedy": ("autoreg", "uncond", GREEDY, 6, {}),
    "autoreg_c_greedy": ("autoreg", "c", GREEDY, 7, {}),
    "autoreg_relation_greedy": ("autoreg", "relation", GREEDY, 8, {"max_retries": 2}),
    "maskgit_c_greedy": ("maskgit", "c", GREEDY, 9, {}),
    "layoutdm_c_greedy": ("layoutdm", "c", GREEDY, 10, {}),
    "cglgan": ("cglgan", None, GREEDY, 11, {}),
    "icvt": ("icvt", None, GREEDY, 12, {}),
    "retriever": ("retriever", None, GREEDY, 13, {}),
}
PADDED = {"autoreg_b6_top_p": ("autoreg", "uncond", TOP_P, 14, {}),
          "autoreg_b6_greedy": ("autoreg", "c", GREEDY, 15, {})}
SAMPLERS = {"autoreg": "MeshSampler", "ralf": "MeshSampler", "maskgit": "MaskGITMeshSampler",
            "layoutdm": "DiffusionMeshSampler", "cglgan": "GANMeshSampler",
            "icvt": "ICVTMeshSampler", "retriever": "RetrieverMeshSampler"}


def _flat_npz(path, variables):
    flat = {f"{name}/{k}": np.asarray(v) for name, tree in variables.items()
            for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}
    np.savez(path, **flat)


def _batches(preset, n, over):
    """The first n test canvases of the preset's synthetic splits, as each
    package's loader gives them; RALF's with the same random neighbours."""
    jcfg, tcfg = jconfig.build_config(preset, over[preset]), tconfig.build_config(preset,
                                                                                  over[preset])
    jtrain, _, jtest = jconfig.build_datasets(jcfg)
    ttrain, _, ttest = tconfig.build_datasets(tcfg)
    kw = dict(shuffle=False, transforms=(), use_native=False)
    jb = next(iter(jdata.BatchLoader(jtest, n, prefetch=0, **kw)))
    tb = next(iter(tdata.BatchLoader(ttest, n, **kw)))
    if preset == "ralf":
        idx = np.random.default_rng(1).integers(0, len(ttrain), size=(n, TOP_K))
        jl, tl = jtrain.get_layouts(idx.reshape(-1)), ttrain.get_layouts(idx.reshape(-1))
        jb["retrieved"] = {k: a.reshape(n, TOP_K, -1) for k, a in jl.items()}
        tb["retrieved"] = {k: a.reshape(n, TOP_K, -1) for k, a in tl.items()}
    return jb, tb


def _jax_generator(preset, over):
    cfg = jconfig.build_config(preset, over[preset])
    return jconfig.build_generator(cfg, jconfig.build_tokenizer(cfg))


def _make_cases(table, n, jgens, tgens, shards, over):
    """(the port's cases for the ranks and the single process, JAX's results
    of the greedy cases on `shards` CPU devices)."""
    cases, jax_out = {}, {}
    mesh = j_decode_mesh(jax.devices()[:shards])
    for name, (preset, task, sampling, seed, extra) in table.items():
        jg, (tg, jv) = jgens[preset], tgens[preset]
        jb, tb = _batches(preset, n, over)
        case = {"preset": preset, "sampling": sampling, "seed": seed, "extra": extra,
                "task": task or "uncond"}
        js = None if jg.tokenizer is None else jsamp.SamplingConfig(**sampling)
        jms = j_build_mesh_sampler(jg, mesh, js, task=task or "uncond", **extra)
        if task is not None:  # token families: the condition from one numpy seed
            case["kind"] = "tokens"
            case["cond"], _ = tg.build_condition(tb, np.random.default_rng(seed), task=task)
            if sampling["name"] == "deterministic":
                jc, _ = jg.build_condition(jb, np.random.default_rng(seed), task=task)
                jax_out[name] = np.asarray(jms.sample(jv, jc, jax.random.PRNGKey(seed),
                                                      return_tokens=True)[1])
        else:
            case["kind"], case["batch"] = "layout", tb
            key = jax.random.PRNGKey(seed)
            if preset == "icvt":  # JAX's z: drawn in the sampler at the padded batch
                rows = -(-n // jms.num_shards) * jms.num_shards
                z = jax.random.normal(jax.random.split(key)[1], (rows, 1, jg.cfg.d_model))
                case["z"] = np.asarray(z)[:n]
                want = jms.sample(jv, jb, np.random.default_rng(seed), key=key)
            elif preset == "retriever":
                want = jms.sample({"params": {}}, jb)
            else:
                want = jms.sample(jv, jb, np.random.default_rng(seed))
            jax_out[name] = {k: np.asarray(getattr(want, k)) for k in
                             ("label", "center_x", "center_y", "width", "height", "mask")}
        cases[name] = case
    return cases, jax_out


def _make_ralf_job(root, over):
    """A tiny ralf job dir (deterministic sampling): JAX's orbax checkpoint
    and the same tree as ckpt_final.npz."""
    job = str(root / "job_ralf")
    cfg = jconfig.build_config("ralf", over["ralf"] + ["sampling.name=deterministic",
                                                       f"train.job_dir={job}"])
    cfg.save(job)
    trainer = JTrainer(jconfig.build_generator(cfg, jconfig.build_tokenizer(cfg)), cfg.train)
    state = trainer.init_state(jax.random.PRNGKey(0))
    trainer.save(state, "final")
    _flat_npz(os.path.join(job, "ckpt_final.npz"),
              {"params": state.params, "batch_stats": state.batch_stats})
    return job


def _run_jax_cli(argv):
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        jinf.main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 and world-4 ranks' results beside the single process's and
    JAX's, and the three cli.inference output dirs; removed at the end."""
    root = tmp_path_factory.mktemp("mesh")
    _kmeans_cache(str(root / "cache"))  # LayoutDM's vocabulary
    over = {p: o + [f"cache_dir={root / 'cache'}"] for p, o in OVERRIDES.items()}
    jgens, tgens, params = {}, {}, {}
    for preset in over:
        jgens[preset] = _jax_generator(preset, over)
        jv = {"params": {}}
        if preset != "retriever":
            jv = jax.tree.map(np.asarray, jgens[preset].init(jax.random.PRNGKey(0)))
            params[preset] = str(root / f"{preset}.npz")
            _flat_npz(params[preset], jv)
        tgens[preset] = (ranks.port_generator(preset, over[preset], params.get(preset)), jv)
    cases, jax_out = _make_cases(CASES, B, jgens, tgens, 8, over)
    padded, jax_padded = _make_cases(PADDED, 6, jgens, tgens, 4, over)
    job = _make_ralf_job(root, over)
    args = ["--job-dir", job, "--cond", "c", "--num-seeds", "1", "--batch-size", "16"]
    # first, so that the gallery's cache is written before anyone else reads it
    tinf.main(args + ["--mesh", "off", "--device", "cpu", "--out-dir", f"{job}/mesh_off"])
    world = {2: root / "world2", 4: root / "world4"}
    for w, (table, cli) in {2: (cases, args + ["--mesh", "on", "--device", "cpu", "--out-dir",
                                                f"{job}/mesh_on"]),
                            4: (padded, None)}.items():
        world[w].mkdir()
        with open(world[w] / "cases.pkl", "wb") as f:
            pickle.dump({"cases": table, "overrides": over, "params": params, "cli": cli}, f)
    procs = {w: ranks.start(ranks.mesh_samples, w, str(world[w])) for w in world}
    # meanwhile: the single process, then JAX's CLI and the port's --mesh off
    single = {name: ranks.run_case(case, tgens[case["preset"]][0])
              for name, case in {**cases, **padded}.items()}
    padded_single = {}
    for name, case in padded.items():  # the single process at the padded batch of 8
        idx = np.minimum(np.arange(8), 5)
        full = dict(case, cond=_take(case["cond"], idx))
        padded_single[name] = ranks.run_case(full, tgens[case["preset"]][0])
    _run_jax_cli(args + ["--mesh", "auto", "--out-dir", f"{job}/jax_auto"])
    results = {w: ranks.finish(procs[w], str(world[w])) for w in world}
    yield {"single": single, "padded_single": padded_single, "jax": {**jax_out, **jax_padded},
           "world2": results[2], "world4": results[4], "job": job}
    shutil.rmtree(root, ignore_errors=True)


def _take(cond, idx):
    from ralf_tpu_torch.parallel.mesh import take_rows

    return take_rows(cond, idx, np.asarray(cond.image).shape[0])


def _same_layout(got, want, what):
    for k in ("label", "mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    for k in ("center_x", "center_y", "width", "height"):
        np.testing.assert_allclose(got[k], want[k], atol=BOX_ATOL, rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("top_p")])
def test_world2_top_p_tokens_equal_the_single_process_bit_for_bit(runs, name):
    preset, task = CASES[name][:2]
    for r, out in enumerate(runs["world2"]):
        kind, toks = out["out"][name]
        ar_relation = task == "relation" and preset in ("autoreg", "ralf")
        assert kind == ("RelationMeshSampler" if ar_relation else SAMPLERS[preset])
        assert toks.shape[0] == B
        np.testing.assert_array_equal(toks, runs["single"][name], err_msg=f"rank {r}")


@pytest.mark.parametrize("name", [n for n in CASES if not n.endswith("top_p")])
def test_world2_greedy_results_equal_the_single_process_and_jax(runs, name):
    got = runs["world2"][0]["out"][name][1]
    assert runs["world2"][1]["out"][name][0] == runs["world2"][0]["out"][name][0]
    if isinstance(got, dict):
        _same_layout(got, runs["single"][name], "single process")
        _same_layout(got, runs["jax"][name], "JAX")
        if CASES[name][0] == "retriever":  # exactly
            for k in got:
                np.testing.assert_array_equal(got[k], runs["jax"][name][k])
        assert got["mask"].any()
    else:
        np.testing.assert_array_equal(got, runs["single"][name])
        np.testing.assert_array_equal(got, runs["jax"][name])


@pytest.mark.parametrize("name", list(PADDED))
def test_b6_on_4_shards_pads_and_strips(runs, name):
    for r, out in enumerate(runs["world4"]):
        toks = out["out"][name][1]
        assert toks.shape[0] == 6
        np.testing.assert_array_equal(toks, runs["padded_single"][name][:6], err_msg=f"rank {r}")
    if name.endswith("greedy"):
        np.testing.assert_array_equal(toks, runs["jax"][name])


def test_a_request_issues_one_all_gather_and_the_program_none(runs):
    for world in ("world2", "world4"):
        for out in runs[world]:
            for name, (program, request) in out["counts"].items():
                assert_clean_decode_hlo(program, request)
                assert dict(request) == {"all_gather": 1}, (world, name)
    with pytest.raises(AssertionError, match="collectives"):
        assert_clean_decode_hlo({"all_reduce": 1})
    with pytest.raises(AssertionError, match="one all-gather"):
        assert_clean_decode_hlo({}, {"all_gather": 2})


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_cli_mesh_on_writes_the_pickles_of_mesh_off_and_of_jax(runs):
    job = runs["job"]
    got = _pickle(f"{job}/mesh_on/test_0.pkl")
    assert len(got["results"]) == 16
    assert got == _pickle(f"{job}/mesh_off/test_0.pkl")
    assert got == _pickle(f"{job}/jax_auto/test_0.pkl")
    for other in ("mesh_off", "jax_auto"):
        assert _csv(f"{job}/mesh_on/test_0_violation.csv") == \
            _csv(f"{job}/{other}/test_0_violation.csv")


def test_build_mesh_sampler_refuses_unknown_generators_and_int8_caches_off_the_ar_family():
    with pytest.raises(TypeError, match="no mesh sampler"):
        build_mesh_sampler(object(), None, None)
    cfg = tconfig.build_config("maskgit", OVERRIDES["maskgit"])  # no kmeans vocabulary
    gen = tconfig.build_generator(cfg, tconfig.build_tokenizer(cfg), device="cpu")
    for kw in ({"kv_quant": True}, {"self_quant": True}):
        with pytest.raises(ValueError, match="int8 cache"):
            build_mesh_sampler(gen, None, None, **kw)


def test_a_rank_takes_its_rows_of_the_relation_update():
    """The diffusion's relation update steps down a batch-mean cost: a rank
    of a sharded sample program divides by the padded batch's count
    (`parallel.rows.batch_mean`), so its rows are the single process's; the
    rank's own mean would step twice as far."""
    from ralf_tpu_torch.ops import relation_costs as trc
    from ralf_tpu_torch.parallel.rows import row_shard

    tok = tconfig.build_tokenizer(tconfig.build_config("maskgit", OVERRIDES["maskgit"]))
    lp, ei, ea = (torch.from_numpy(a) for a in _relation_inputs(
        np.random.default_rng(4), 4, tok.max_seq_length, 9, tok.N_total))
    t = torch.tensor([12, 11, 10, 30])
    full = trc.update_logits_for_relation(lp, t, ei, ea, tok)
    with row_shard(4, 2, 4):
        part = trc.update_logits_for_relation(lp[2:], t[2:], ei[2:], ea[2:], tok)
    np.testing.assert_array_equal(part.numpy(), full[2:].numpy())
    alone = trc.update_logits_for_relation(lp[2:], t[2:], ei[2:], ea[2:], tok)
    assert np.abs(alone.numpy() - full[2:].numpy()).max() > 1e-4
