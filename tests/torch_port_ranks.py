"""Rank programs of the port's multi-GPU CPU tests (tests/test_torch_port_mesh.py,
test_torch_port_sharded_retrieval.py, test_torch_port_dp_train.py).

`start` spawns `world` processes (`torch.multiprocessing`, spawn) that join
one gloo group through a FileStore in a fresh work dir (no port is bound),
each running `fn(rank, world, workdir, *args)` and pickling its return value
to `workdir/rank{r}.pkl`; `finish` waits for them (the test runs the JAX
side meanwhile) and returns the values in rank order.  This module imports
neither JAX nor the JAX package, so a rank starts in about two seconds.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_THREADS = 2  # torch threads of a rank: the tests run six workers side by side


def start(fn, world: int, workdir: str, *args):
    os.makedirs(workdir, exist_ok=True)
    return mp.start_processes(_rank_main, args=(fn, world, workdir, args), nprocs=world,
                              join=False, start_method="spawn")


def _rank_main(rank: int, fn, world: int, workdir: str, args: tuple) -> None:
    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, world, workdir, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def finish(ctx, workdir: str, timeout: float = 600.0) -> list:
    """Each rank's return value; a rank that raised raises here, and ranks
    still running after `timeout` seconds are terminated."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(len(ctx.processes)):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def port_generator(preset: str, overrides: list, params: str = None):
    """The port's generator of a preset on the CPU, with the flat .npz of
    JAX's variables at `params` loaded (none for the retriever)."""
    from ralf_tpu_torch import config as tconfig
    from ralf_tpu_torch.utils.weights import load_jax_params, load_params_npz

    cfg = tconfig.build_config(preset, overrides)
    gen = tconfig.build_generator(cfg, tconfig.build_tokenizer(cfg), device="cpu")
    if params is not None:
        load_jax_params(gen.core, *load_params_npz(params))
    return gen


def run_case(case: dict, gen, sampler=None):
    """One sampling case of tests/test_torch_port_mesh.py: through `sampler`
    (a mesh sampler) or, without one, the generator's single-process path;
    tokens [B, L] for the token families, else the layout's arrays."""
    from ralf_tpu_torch.core.sampling import SamplingConfig

    sampling = SamplingConfig(**case["sampling"])
    if case["kind"] == "tokens":
        g = torch.Generator().manual_seed(case["seed"])
        with torch.inference_mode():
            if sampler is not None:
                _, toks = sampler.sample(case["cond"], g, return_tokens=True)
            else:
                _, toks = gen.sample(case["cond"], sampling, g, return_tokens=True,
                                     **case.get("extra", {}))
        return toks.numpy()
    rng = np.random.default_rng(case["seed"])
    kw = {} if case.get("z") is None else {"z": torch.from_numpy(np.array(case["z"]))}
    layout = (sampler or gen).sample(case["batch"], rng, **kw)
    return layout.numpy()


def mesh_samples(rank: int, world: int, workdir: str) -> dict:
    """Every case of workdir/cases.pkl through `build_mesh_sampler` on the
    decode mesh: {'out': {case: result}, 'counts': {case: (program, request)}};
    then, given its argv in cases.pkl, cli.inference --mesh on."""
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.parallel.zoo import build_mesh_sampler, make_decode_mesh

    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        spec = pickle.load(f)
    mesh = make_decode_mesh()
    gens, out, counts = {}, {}, {}
    for name, case in spec["cases"].items():
        key = case["preset"]
        if key not in gens:
            gens[key] = port_generator(key, spec["overrides"][key], spec["params"].get(key))
        sampler = build_mesh_sampler(gens[key], mesh, SamplingConfig(**case["sampling"]),
                                     task=case.get("task", "uncond"),
                                     **case.get("extra", {}))
        out[name] = (type(sampler).__name__, run_case(case, gens[key], sampler))
        counts[name] = sampler.counts
    cli = spec.get("cli")
    if cli is not None:
        from ralf_tpu_torch.cli import inference as tinf

        tinf.main(cli)
    return {"out": out, "counts": counts}


def sharded_retrieval(rank: int, world: int, workdir: str) -> dict:
    """tests/test_torch_port_sharded_retrieval.py's runs with the gallery's
    rows over a `gallery` axis of `world` ranks: `sharded_topk` on each case
    of workdir/inputs.pkl, then a Retriever's table and a loader's batches."""
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.parallel.mesh import GALLERY_AXIS, counting, make_mesh
    from ralf_tpu_torch.retrieval.retriever import Retriever, sharded_topk
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh((1, world))
    out = {"topk": {}, "counts": {}}
    for name, (q, g, k, qid) in inputs["cases"].items():
        pad = (-g.shape[0]) % world
        gp = np.concatenate([g, np.zeros((pad, g.shape[1]), g.dtype)])
        per = gp.shape[0] // world
        local = torch.from_numpy(gp[rank * per:(rank + 1) * per])
        with counting() as counts:
            idx = sharded_topk(mesh, GALLERY_AXIS, torch.from_numpy(q), local, k,
                               exclude_self=qid is not None,
                               query_ids=None if qid is None else torch.from_numpy(qid),
                               n_valid=g.shape[0])
        out["topk"][name], out["counts"][name] = idx.numpy(), dict(counts)
    hw = (64, 48)
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=21, seed=3, image_hw=hw)
    out["table"] = Retriever.build(ds, device="cpu").shard_gallery(mesh).precompute_table(
        ds, k=4, is_train_split=True)
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=12, seed=1, image_hw=hw)
    loader = RetrievalAugmentedLoader(BatchLoader(ds, 4, shuffle=False, seed=0, use_native=False),
                                      Retriever.build(ds, device="cpu").shard_gallery(mesh),
                                      top_k=3, is_train_split=True)
    out["batches"] = list(loader)
    return out


# ---- data-parallel training (tests/test_torch_port_dp_train.py) ---------------------------

# tests/test_torch_port_train.py's tiny RALF and autoreg, data and batch
TRAIN_TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
                  dim_feedforward=64, backbone="resnet18", dropout=0.0)
HW, TOP_K, BATCH, N_TRAIN, N_VAL = (64, 48), 4, 8, 32, 16


def train_generator(name: str, params: str, dropout: float = 0.0):
    """test_torch_port_train.py's port generator `name` (ralf or autoreg) on
    the flat .npz of JAX's variables, its Dropout modules at `dropout`."""
    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
    from ralf_tpu_torch.models.autoreg import AutoregGenerator
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.dropout import Dropout
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.utils.weights import load_jax_params, load_params_npz

    tok = LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=10, num_bin=16))
    kw = {"top_k": TOP_K} if name == "ralf" else {}
    cls = RALFGenerator if name == "ralf" else AutoregGenerator
    gen = cls(tok, GeneratorConfig(**TRAIN_TINY), "uncond", image_hw=HW, device="cpu", **kw)
    load_jax_params(gen.core, *load_params_npz(params))
    for m in gen.core.modules():
        if isinstance(m, Dropout):
            m.p = dropout
    return gen


def train_loaders(name: str):
    """(train, val) loaders of test_torch_port_train.py, seeded alike."""
    from ralf_tpu_torch.data import dataset as tdata
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    cfg = tdata.DatasetConfig(name="synthetic")
    train = tdata.SyntheticPosterDataset(cfg, N_TRAIN, 0, HW)
    val = tdata.SyntheticPosterDataset(cfg, N_VAL, 1, HW)
    kw = dict(use_native=False, prefetch=0)
    tl = tdata.BatchLoader(train, BATCH, seed=0, **kw)
    vl = tdata.BatchLoader(val, BATCH, shuffle=False, seed=0, **kw)
    if name == "ralf":
        retriever = Retriever.build(train, device="cpu")
        tl = RetrievalAugmentedLoader(tl, retriever, TOP_K, is_train_split=True)
        vl = RetrievalAugmentedLoader(vl, retriever, TOP_K)
    return tl, vl


def _grads(module) -> dict:
    return {n: p.grad.numpy().copy() for n, p in module.named_parameters() if p.grad is not None}


def fit(gen, loaders, job_dir: str, mesh=None, cap: int = 3) -> tuple:
    """Trainer.fit (one epoch, `cap` steps): (params, BatchNorm statistics,
    per-step losses, metrics.jsonl records, statistics after the first step,
    each step's counted collectives, the first step's gradients as the update
    took them) -- test_torch_port_train.py's run_port tuple, the counts and
    the gradients."""
    import json

    from ralf_tpu_torch.parallel.mesh import counting
    from ralf_tpu_torch.train.trainer import TrainConfig, Trainer
    from ralf_tpu_torch.utils.weights import export_params

    tr = Trainer(gen, TrainConfig(job_dir=job_dir, batch_size=BATCH, epochs=1), mesh)
    losses, first, counts, grads = [], [], [], []
    step = tr.train_step

    def recorded(*args):
        with counting() as c:
            metrics = step(*args)
        counts.append(dict(c))
        losses.append(float(metrics["loss"]))
        first.extend([] if first else [export_params(gen.core)[1]])
        grads.extend([] if grads else [_grads(gen.core)])
        return metrics

    tr.train_step = recorded
    tr.fit(*loaders, num_steps_cap=cap)
    params, stats = export_params(gen.core)
    with open(os.path.join(job_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return params, stats, losses, records, first, counts, grads[0]


def gan_step(gen, loader, job_dir: str, mesh=None) -> dict:
    """One GANTrainer step (generator, then discriminator; adversarial weight
    1): both nets' parameters, both losses and both steps' gradients."""
    from ralf_tpu_torch.train.gan_trainer import GANTrainer
    from ralf_tpu_torch.train.trainer import TrainConfig
    from ralf_tpu_torch.utils.weights import export_params

    tr = GANTrainer(gen, TrainConfig(job_dir=job_dir, batch_size=BATCH, epochs=1), mesh,
                    warmup_dis_epoch=0)
    losses, grads = [], []
    g_step, d_step = tr.gen_step, tr.dis_step

    def gen_step(state, *args):
        losses.append(g_step(state, *args))
        grads.append(_grads(state.module))
        return losses[-1]

    def dis_step(dis_state, *args):
        losses.append(d_step(dis_state, *args))
        grads.append(_grads(dis_state.module))
        return losses[-1]

    tr.gen_step, tr.dis_step = gen_step, dis_step
    state, dis_state = tr.fit_gan(loader, num_steps_cap=1)
    return {"gen": export_params(state.module), "disc": export_params(dis_state.module),
            "losses": [float(losses[0]["loss"]), float(losses[1]["loss_d"])],
            "grads": grads}


def batchnorm_pass(x: np.ndarray, w: np.ndarray, rows: tuple = None, group=None,
                   size: int = 1) -> dict:
    """A flax-style BatchNorm in train mode on x [B, C, H, W] (rows [lo, hi)
    of it under a train row shard with `group`), the loss sum(y * w) and its
    backward: the running statistics and the gradients."""
    from ralf_tpu_torch.models.resnet import BatchNorm
    from ralf_tpu_torch.parallel.rows import row_shard

    torch.manual_seed(0)
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    lo, hi = rows or (0, x.shape[0])
    xt = torch.from_numpy(x[lo:hi]).requires_grad_(True)
    bn.train()
    shard = row_shard(x.shape[0], lo, hi, group, size) if group is not None else None
    with shard if shard is not None else torch.enable_grad():
        y = bn(xt)
    (y * torch.from_numpy(w[lo:hi])).sum().backward()
    return {"mean": bn.running_mean.numpy().copy(), "var": bn.running_var.numpy().copy(),
            "x_grad": xt.grad.numpy(), "w_grad": bn.weight.grad.numpy().copy(),
            "b_grad": bn.bias.grad.numpy().copy()}


def dp_train(rank: int, world: int, workdir: str) -> dict:
    """The data-parallel runs of tests/test_torch_port_dp_train.py on a
    (data world) mesh: the ralf fits with dropout 0.1 and 0, the maskgit fit
    with dropout 0.1, one cglgan GAN step, the BatchNorm pass and, given
    its argv in spec.pkl, cli.train with train.gallery_shards=2."""
    from ralf_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(workdir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    mesh = make_mesh()
    job = os.path.join(workdir, "jobs")
    out = {}
    for dropout in (0.1, 0.0):
        gen = train_generator("ralf", spec["params"]["ralf"], dropout)
        out[f"ralf_{dropout}"] = fit(gen, train_loaders("ralf"), f"{job}/ralf_{dropout}", mesh)
    gen = port_generator("maskgit", spec["overrides"]["maskgit"])
    out["maskgit"] = fit(gen, train_loaders("maskgit"), f"{job}/maskgit", mesh)
    gen = port_generator("cglgan", spec["overrides"]["cglgan"])
    out["cglgan"] = gan_step(gen, train_loaders("cglgan")[0], f"{job}/cglgan", mesh)
    B = spec["bn_x"].shape[0]
    per = B // world
    out["bn"] = batchnorm_pass(spec["bn_x"], spec["bn_w"], (rank * per, (rank + 1) * per),
                               mesh.batch_group, mesh.num_shards)
    out["bn_local"] = batchnorm_pass(spec["bn_x"][rank * per:(rank + 1) * per],
                                     spec["bn_w"][rank * per:(rank + 1) * per])
    if spec.get("cli") is not None:
        from ralf_tpu_torch.cli import train as cli_train

        cli_train.main(spec["cli"])
    return out


def hybrid_step(rank: int, world: int, workdir: str) -> dict:
    """One autoreg train step (dropout 0.1) on the hybrid (dcn 2, data 2)
    mesh and on the flat (data 4) mesh, from the same weights and batch:
    both steps' losses and counted collectives."""
    from ralf_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    with open(os.path.join(workdir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    out = {}
    for name, mesh in (("hybrid", make_hybrid_mesh((2, 1), num_slices=2)),
                       ("flat", make_mesh((4, 1)))):
        gen = train_generator("autoreg", spec["params"]["autoreg"], 0.1)
        out[name] = fit(gen, train_loaders("autoreg"), os.path.join(workdir, name), mesh, cap=1)
        out[name + "_mesh"] = (mesh.shape, mesh.batch_index, mesh.num_shards)
    return out
