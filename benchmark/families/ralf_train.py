"""RALF trained through the port's `Trainer.train_step` (train/trainer.py)
as `cli/train.py` trains the `ralf` preset: batches from the port's
`BatchLoader` (the AR presets' sorting transforms, uint8 canvases) wrapped
in its `RetrievalAugmentedLoader` over a precomputed top-k table of the
split itself, each batch through `RALFGenerator.preprocess` and one step
(forward with dropout and BatchNorm in training, smoothed cross entropy,
backward, the clip, AdamW).

Set-up, all from the run's seed: the generator in the configuration's
training dtype with the seeded weights (`lib/weights.py`), the split's
layouts (CGL's train split: 48,543 rows), its top-k table (`lib/data.py::
split_neighbours`, never a row itself), a pool of canvases, the loader
and the trainer.  The first `checked_steps` steps run in set-up through
the window's own call and feed, on rows that all differ; each dropout
module's keep mask is recorded as the step applies it, the optimizer's
first moment after step 1 gives the first clipped gradient (m / (1 - b1)),
and the parameters' change after the last checked step is read before the
next step moves them.

`correct`: after the window, with the program freed, the plain reference
(`references/ralf_train.py`, float32, TF32 off) follows the checked steps
from the benchmark's initial weights, the same rows and the recorded masks.
Compared, each against the reference: the first step's loss (`loss1_gap`,
its relative gap: the later steps carry the round-off by which the two
sides' parameters part), every step's loss (`loss_gap`, the largest
relative gap), the first gradient's norm leaf by leaf (`grad_gap`)
and the change's norm leaf by leaf (`change_gap`), each leaf's gap
|program - reference| over the larger of the reference's norm of that leaf
and of the median leaf; the change leaves out leaves whose reference
gradient is under a thousandth of the median leaf's (a key's bias under
softmax), which AdamW moves by round-off alone."""

from __future__ import annotations

import contextlib
import dataclasses
import statistics

import numpy as np

from benchmark.costs import flops
from benchmark.lib import data, env, manifest, serve
from benchmark.lib import weights as wmod
from benchmark.lib.weights import subseed
from benchmark.references import ralf as ref
from benchmark.references import ralf_train as train_ref

TRANSFORMS = ("sort_label", "sort_lexicographic")  # the AR presets' (`config.py`)
FEATURE_WIDTH = 16  # the retriever's gallery features: unread with a table given


@dataclasses.dataclass
class Program:
    config: dict
    traffic: dict
    device: object
    gen: object
    trainer: object
    state: object
    batches: object  # the loader's batches, epoch after epoch
    rng: np.random.Generator  # preprocess's
    weights: dict
    split: dict
    canvases: np.ndarray
    table: np.ndarray
    metrics: dict | None = None  # the last step's, on the device


def set_tf32(torch, on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def build(torch, config: dict, traffic: dict, seed: int, device) -> Program:
    from ralf_tpu_torch.data.dataset import BatchLoader
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
    from ralf_tpu_torch.train.trainer import TrainConfig, Trainer

    d, tc, K = config["dataset"], config["train"], config["retrieval"]["top_k"]
    set_tf32(torch, tc["tf32"])
    tok = serve.tokenizer(config)
    gcfg = GeneratorConfig(**config["model"], dtype=tc["dtype"])
    with torch.device(device):  # the program's own initialisation, overwritten below, on the card
        gen = RALFGenerator(tok, gcfg, traffic["task"], (d["image_h"], d["image_w"]), top_k=K,
                            device=device)
    weights = wmod.seeded_weights(torch, gen.core, seed, device)
    wmod.load(torch, gen.core, weights)

    rng = np.random.default_rng(subseed(seed, "data"))
    G = d["gallery_size"]
    split = data.layouts(G, d["max_seq_length"], d["num_labels"], rng)
    table = data.split_neighbours(G, K, rng)
    features = rng.standard_normal((G, FEATURE_WIDTH), dtype=np.float32)
    canvases = data.canvases(torch, traffic["canvases"], d["image_h"], d["image_w"], seed,
                             device)
    loader = BatchLoader(data.Split(split, canvases), traffic["batch"], transforms=TRANSFORMS,
                         seed=subseed(seed, "loader"), image_dtype=np.uint8)
    retriever = Retriever(features, split, device=device)
    batches = epochs(RetrievalAugmentedLoader(loader, retriever, K, is_train_split=True,
                                              table=table))
    job = manifest.BENCH_DIR.parent / env.CACHE_DIR / "train_job"
    trainer = Trainer(gen, TrainConfig(batch_size=traffic["batch"], lr=tc["lr"],
                                       weight_decay=tc["weight_decay"],
                                       clip_max_norm=tc["clip_max_norm"],
                                       seed=subseed(seed, "dropout"), job_dir=str(job)))
    return Program(config, traffic, device, gen, trainer, trainer.init_state(), batches,
                   np.random.default_rng(subseed(seed, "preprocess")), weights, split,
                   canvases, table)


def epochs(loader):
    """The loader's batches, epoch after epoch, as `Trainer.fit` takes them."""
    while True:
        yield from loader


def step(prog: Program, spans) -> np.ndarray:
    """One step of the window, as `Trainer.fit` takes it; returns its rows."""
    with spans.span("loader"):
        batch = next(prog.batches)
    with spans.span("preprocess"):
        inputs, targets = prog.gen.preprocess(batch, prog.rng)
    with spans.span("step"):
        prog.metrics = prog.trainer.train_step(prog.state, inputs, targets)
    return np.asarray(batch["indices"])


@contextlib.contextmanager
def recording(torch, prog: Program):
    """While open: each train-mode dropout module's keep mask, recorded on
    the host as the module applies it ({module path: bool mask} a step in
    the yielded list; `next_step` opens the next)."""
    from ralf_tpu_torch.models.dropout import Dropout

    steps: list = [{}]

    def hook(name):
        def keep(module, inputs, out):
            if module.training and module.p > 0.0:
                if name in steps[-1]:
                    raise RuntimeError(f"dropout {name} applied twice in a step")
                steps[-1][name] = (out != 0).cpu()
        return keep

    handles = [m.register_forward_hook(hook(n)) for n, m in prog.state.module.named_modules()
               if isinstance(m, Dropout)]
    try:
        yield steps
    finally:
        for h in handles:
            h.remove()


def next_step(steps: list) -> None:
    steps.append({})


def first_gradient(torch, prog: Program) -> dict:
    """{leaf: norm} of the first step's clipped gradient, from AdamW's first
    moment (m = (1 - b1) g after one step); 0 for a leaf with no state."""
    opt = prog.state.optimizer.opt
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for name, p in prog.state.module.named_parameters():
        st = opt.state.get(p, {})
        out[name] = float(st["exp_avg"].norm()) / (1.0 - b1) if "exp_avg" in st else 0.0
    return out


def change(torch, prog: Program) -> dict:
    """{leaf: norm of its change from the initial weights}."""
    with torch.no_grad():
        return {name: float((p.detach().float() - prog.weights[name].float()).norm())
                for name, p in prog.state.module.named_parameters()}


def flops_per_sample(config: dict) -> float:
    v = ref.Vocab(config["dataset"]["num_labels"], config["tokenizer"]["num_bin"],
                  config["dataset"]["max_seq_length"])
    return flops.ralf_train_sample({**config, "const_len": len(v.uncond_constraint()),
                                    "vocab_size": v.V})


def leaf_gap(prog: dict, want: dict, names: list) -> float:
    """The worst leaf's |program - reference| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    floor = statistics.median(want[n] for n in names)
    return max(abs(prog.get(n, 0.0) - want[n]) / max(want[n], floor) for n in names)


def compare(program: dict, want: dict, limits: dict) -> tuple[dict, dict]:
    """(figures printed, the numbers compared) of the program's readings
    ({'loss', 'grad', 'change'}) against the reference's."""
    losses = [abs(a - b) / abs(b) for a, b in zip(program["loss"], want["loss"])]
    grads = want["grad"]
    floor = statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= 1e-3 * floor]
    figures = {"loss1_gap": losses[0], "loss_gap": max(losses),
               "grad_gap": leaf_gap(program["grad"], grads, list(grads)),
               "change_gap": leaf_gap(program["change"], want["change"], moved)}
    info = {"losses": program["loss"], "reference_losses": want["loss"],
            "leaves_changed_compared": len(moved), "leaves": len(grads)}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in figures.items()}
    checks["steps_missing"] = {"value": len(want["loss"]) - len(program["loss"]), "limit": 0}
    return info, checks


def reference(torch, prog: Program, rows: list, masks: list, low: str | None = None) -> dict:
    """The reference's readings over the checked steps' rows and masks."""
    v = ref.Vocab(prog.config["dataset"]["num_labels"], prog.config["tokenizer"]["num_bin"],
                  prog.config["dataset"]["max_seq_length"])
    steps = [train_ref.step_inputs(prog.config, prog.split, prog.canvases, prog.table, r, v)
             for r in rows]
    return train_ref.follow(prog.config, prog.weights, steps, masks, prog.device, low)


def release(torch, prog: Program) -> None:
    """Free the program's state before the reference runs, and keep the
    reference's float32 products out of TF32."""
    prog.gen = prog.trainer = prog.state = prog.batches = None
    if prog.device.type == "cuda":
        torch.cuda.empty_cache()
    set_tf32(torch, False)


def check(torch, prog: Program, readings: dict, rows: list, masks: list) -> tuple[dict, dict]:
    """(figures printed beside the comparison, the numbers compared)."""
    release(torch, prog)
    want = reference(torch, prog, rows, masks)
    return compare(readings, want, prog.config["train"]["limits"])
