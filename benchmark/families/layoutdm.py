"""LayoutDM served through the port's `LayoutDMGenerator` (models/diffusion.py;
the `layoutdm` preset: constrained mask-and-replace transitions, the learned
element and attribute position encoding, the k-means tokenizer, no
retrieval), as `cli/inference.py` serves it.

Set-up, all from the run's seed: the gallery's layouts (the train split),
the k-means centres of each geometry attribute fitted on them
(`references/layoutdm.py::fit_kmeans_1d`, handed to the port's tokenizer
and to the reference alike), the generator in the configuration's dtype
with the seeded weights, the pool's canvases and their own layouts.

`correct`: a greedy request keeps the state x_t after each of its T
denoising steps (`capture`: one argmax of a step's output a step, read
after the request).  After the window, with the program freed, the plain
reference (float32, TF32 off) follows a sample of its rows step by step
from the program's own states, as the rows' chains can only be followed
from the program's states: at each step it works out log p(x_{t-1} | x_t)
from the program's x_t (encoder, decoder logits, posterior) and reads how
far below its best the program's chosen x_{t-1} lies.  A position's gap is
the widest along its chain of steps (a mean over steps would dilute a
wrong token by the T - 1 steps that only keep a state); the figure
compared is `row_gap`, the mean over the sampled rows of each row's widest
gap (`lib/serve.py`).  The start (x_T, all
MASK) is the reference's own.  Besides, every served token of every request
must lie in its position's sub-vocabulary (`illegal_tokens`), and each
sampled layout must equal the reference's decoding (`layout_mismatch`)."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from benchmark.costs import flops
from benchmark.lib import data, launches, serve
from benchmark.lib import weights as wmod
from benchmark.lib.weights import subseed
from benchmark.references import layoutdm as ref
from benchmark.references.blocks import Weights

CHECK_BLOCK = 16  # reference rows a pass


@dataclasses.dataclass
class Program:
    config: dict
    traffic: dict
    device: object
    gen: object
    tok: object
    task: str
    sampling: object
    greedy: object
    sample_kwargs: dict
    batches: list
    weights: dict
    centers: dict
    images: np.ndarray

    @contextlib.contextmanager
    def capture(self, greedy: bool):
        """During a greedy request: the tokens [B, L] after each denoising
        step, in step order (a list of device tensors)."""
        if not greedy:
            yield None
            return
        from ralf_tpu_torch.models.diffusion import log_onehot_to_index

        diffusion, states = self.gen.diffusion, []
        inner = diffusion.sample_single_step

        def step(*args, **kwargs):
            out = inner(*args, **kwargs)
            states.append(log_onehot_to_index(out))
            return out

        diffusion.sample_single_step = step
        try:
            yield states
        finally:
            del diffusion.sample_single_step


def vocab(config: dict) -> ref.Vocab:
    d = config["dataset"]
    return ref.Vocab(d["num_labels"], config["tokenizer"]["num_bin"], d["max_seq_length"])


def build(torch, config: dict, traffic: dict, seed: int, device) -> Program:
    from ralf_tpu_torch.core.layout import Layout
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.diffusion import LayoutDMGenerator

    d = config["dataset"]
    S, G, n = d["max_seq_length"], d["gallery_size"], traffic["pool"]
    rng = np.random.default_rng(subseed(seed, "data"))
    gallery = data.layouts(G, S, d["num_labels"], rng)
    centers = {k: ref.fit_kmeans_1d(gallery[k][gallery["mask"]], config["tokenizer"]["num_bin"])
               for k in ref.GEO_KEYS}
    tok = serve.tokenizer(config, centers)
    gcfg = GeneratorConfig(**config["model"], dtype=config["dtype"])
    with torch.device(device):  # the program's own initialisation, overwritten below, on the card
        gen = LayoutDMGenerator(tok, gcfg, num_timesteps=config["num_timesteps"],
                                q_type="constrained", pos_emb="elem_attr",
                                image_hw=(d["image_h"], d["image_w"]), device=device)
    weights = wmod.seeded_weights(torch, gen.core, seed, device)
    wmod.load(torch, gen.core, weights)
    own = data.layouts(n, S, d["num_labels"], rng)
    images = data.canvases(torch, n, d["image_h"], d["image_w"], seed, device)
    B = traffic["batch"]
    batches = [{"layout": Layout.fromdict(data.take(own, np.arange(s, s + B))),
                "image": images[s : s + B], "id": np.arange(s, s + B)}
               for s in range(0, n - B + 1, B)]
    return Program(config, traffic, device, gen, tok, traffic["task"],
                   SamplingConfig(**config["sampling"]), SamplingConfig(name="deterministic"), {},
                   batches, weights, centers, images)


def timed_methods(prog: Program) -> list:
    return [(prog.gen.core, "encode_memory", "encode"), (prog.gen, "sample", "sample")]


def recorded_launches(prog: Program):
    return launches.recorded(("K1",))


def flops_per_layout(config: dict) -> dict:
    return flops.layoutdm_layout({**config, "vocab_size": vocab(config).V})


def step_gaps(torch, prog: Program, chosen: list, low: str | None = None,
              picks: bool = False):
    """[rows, T, L]: at each step, how far below the reference's best
    log-probability the program's next state lies; with `low`, the gap of
    the token that the reference in that precision puts first instead
    (with `picks`, also those tokens [rows, T, L])."""
    config = prog.config
    v, T, B = vocab(config), config["num_timesteps"], prog.traffic["batch"]
    exact, rounded = Weights(prog.weights), Weights(prog.weights, low=low)
    tb = ref.Tables(v, T, prog.device)
    out = []
    for s in range(0, len(chosen), CHECK_BLOCK):
        block = chosen[s : s + CHECK_BLOCK]
        idx = np.array([r.batch * B + i for r, i in block])
        states = torch.as_tensor(np.stack([r.states[:, i] for r, i in block], 1),
                                 device=prog.device)  # [T, rows, L]
        x = torch.full_like(states[0], v.mask)
        gaps, picked = [], []
        with torch.no_grad():
            mem = ref.memory(exact, config, prog.images[idx], prog.device)
            mem_low = ref.memory(rounded, config, prog.images[idx], prog.device) if low else None
            for k, t in enumerate(range(T - 1, -1, -1)):
                lp = ref.step_log_prob(exact, config, tb, mem, x, t, v.V)
                pick = states[k]
                if low:
                    pick = ref.step_log_prob(rounded, config, tb, mem_low, x, t, v.V).argmax(-1)
                gaps.append(lp.amax(-1) - lp.gather(-1, pick[..., None])[..., 0])
                picked.append(pick)
                x = states[k]
        out.append((torch.stack(gaps, 1).cpu(), torch.stack(picked, 1).cpu()))
    gaps = torch.cat([g for g, _ in out])
    return (gaps, torch.cat([p for _, p in out])) if picks else gaps


def check(torch, prog: Program, records: list, seed: int) -> tuple[dict, dict]:
    """(figures printed beside the comparison, the numbers compared, each
    {'value', 'limit'}: correct when every value is at most its limit)."""
    serve.release(torch, prog)
    config, rows = prog.config, prog.traffic["check_rows"]
    v = vocab(config)
    allowed = ref.Tables(v, config["num_timesteps"], "cpu").ind.numpy() == 0.0
    illegal = serve.illegal_tokens(records, allowed)
    chosen = serve.sample_rows(records, rows, seed)
    gaps, mismatch = None, 0
    if chosen:
        gaps = step_gaps(torch, prog, chosen).amax(1)
        decoded = [v.decode(r.tokens[i : i + 1], prog.centers) for r, i in chosen]
        mismatch = serve.layout_mismatches(chosen, decoded)
    return serve.gap_checks(gaps, config["limits"], illegal, mismatch,
                            rows - len(chosen))


def control_check(torch, prog: Program, records: list, seed: int,
                  low: str) -> tuple[dict, dict]:
    """`check` with the reference in `low` precision put in the program's
    place: at each step of the sampled rows' chains (the program's own
    states x_t) it picks the state that it puts first, and the cell's own
    comparison judges each position's widest gap along its chain against
    the float32 reference.  Its layouts are the reference's own decoding of
    its last picks, so `layout_mismatch` reads 0 by construction;
    `illegal_tokens` counts its last picks against the sub-vocabularies."""
    config, rows = prog.config, prog.traffic["check_rows"]
    v = vocab(config)
    chosen = serve.sample_rows(records, rows, seed)
    gaps, picks = step_gaps(torch, prog, chosen, low, picks=True)
    allowed = ref.Tables(v, config["num_timesteps"], "cpu").ind.numpy() == 0.0
    illegal = serve.illegal_in(picks[:, -1].numpy(), allowed)
    return serve.gap_checks(gaps.amax(1), config["limits"], illegal, 0, rows - len(chosen))
