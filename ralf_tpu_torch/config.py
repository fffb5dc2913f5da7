"""Framework configuration, the counterpart of `ralf_tpu/config.py`: the
dataclass tree of a job, the 12 experiment presets, dotted `key=value`
overrides, and the factories of the tokenizer, the datasets and the
generator.

A job's config serializes to `job_dir/config.json` in the JAX package's
format, so each package loads what the other saved.  `build_generator`
builds every preset (on `device`, the card by default).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Optional

from ralf_tpu_torch.core.sampling import SamplingConfig
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
from ralf_tpu_torch.data.dataset import DatasetConfig
from ralf_tpu_torch.models.base import GeneratorConfig
from ralf_tpu_torch.train.trainer import TrainConfig

# tokenizer defaults per model family (`config/experiment/*.yaml`)
AR_TOKENIZER = dict(special_tokens=("pad", "bos", "eos"), geo_quantization="linear")
DIFFUSION_TOKENIZER = dict(special_tokens=("pad", "mask"), geo_quantization="kmeans")
MASKGIT_TOKENIZER = dict(special_tokens=("pad", "mask"), geo_quantization="linear")

# experiment presets: generator name, its kwargs, tokenizer style, transforms
EXPERIMENTS: dict[str, dict] = {
    "autoreg": dict(generator="autoreg", tokenizer=AR_TOKENIZER,
                    transforms=("sort_label", "sort_lexicographic")),
    "ralf": dict(generator="ralf", tokenizer=AR_TOKENIZER,
                 transforms=("sort_label", "sort_lexicographic"),
                 generator_kwargs=dict(top_k=16)),
    "cglgan": dict(generator="cglgan", tokenizer=None, transforms=("shuffle",)),
    "cglgan_ra": dict(generator="cglgan", tokenizer=None, transforms=("shuffle",),
                      generator_kwargs=dict(with_retrieval=True, top_k=16)),
    "dsgan": dict(generator="dsgan", tokenizer=None, transforms=("shuffle",),
                  train=dict(epochs=300, scheduler="dsgan")),
    "dsgan_ra": dict(generator="dsgan", tokenizer=None, transforms=("shuffle",),
                     generator_kwargs=dict(with_retrieval=True, top_k=16),
                     train=dict(epochs=300, scheduler="dsgan")),
    "icvt": dict(generator="icvt", tokenizer=None, transforms=("shuffle",),
                 model=dict(d_model=200),
                 generator_kwargs=dict(ga_type="concat")),
    "layoutdm": dict(generator="layoutdm", tokenizer=DIFFUSION_TOKENIZER,
                     transforms=("shuffle",),
                     generator_kwargs=dict(q_type="constrained",
                                           pos_emb="elem_attr")),
    "layoutdm_ra": dict(generator="layoutdm", tokenizer=DIFFUSION_TOKENIZER,
                        transforms=("shuffle",),
                        generator_kwargs=dict(q_type="constrained",
                                              pos_emb="elem_attr",
                                              with_retrieval=True, top_k=16)),
    "vqdiffusion": dict(generator="layoutdm", tokenizer=MASKGIT_TOKENIZER,
                        transforms=("shuffle",),
                        generator_kwargs=dict(q_type="default",
                                              pos_emb="layout")),
    "maskgit": dict(generator="maskgit", tokenizer=MASKGIT_TOKENIZER,
                    transforms=("shuffle",)),
    "retriever": dict(generator="retriever", tokenizer=None, transforms=()),
}


@dataclasses.dataclass
class FrameworkConfig:
    experiment: str = "ralf"
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    tokenizer: Optional[dict] = None  # TokenizerConfig kwargs or None (GANs)
    model: dict = dataclasses.field(default_factory=dict)  # GeneratorConfig kwargs
    generator_kwargs: dict = dataclasses.field(default_factory=dict)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    transforms: tuple = ("sort_label", "sort_lexicographic")
    auxiliary_task: str = "uncond"
    debug: bool = False
    synthetic_data: bool = False  # hermetic runs when parquet dumps absent
    num_seeds: int = 3  # eval protocol (`config/__init__.py:62`)
    # offline-artifact directory (retrieval tables, gallery features,
    # kmeans vocabularies — the reference's `cache/` conventions)
    cache_dir: str = "cache"
    # kmeans tokenizer presets (layoutdm) REQUIRE fitted centers in the
    # cache; set True to permit the linear-vocabulary downgrade instead of
    # erroring (the config would otherwise lie about what it ran)
    allow_linear_fallback: bool = False

    # ---- serialization contract ------------------------------------------

    def save(self, job_dir: str) -> None:
        os.makedirs(job_dir, exist_ok=True)
        with open(os.path.join(job_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)

    @classmethod
    def load(cls, job_dir: str) -> "FrameworkConfig":
        with open(os.path.join(job_dir, "config.json")) as f:
            raw = json.load(f)
        return from_dict(raw)


def from_dict(raw: dict) -> FrameworkConfig:
    cfg = FrameworkConfig(
        experiment=raw.get("experiment", "ralf"),
        dataset=DatasetConfig(**raw.get("dataset", {})),
        tokenizer=raw.get("tokenizer"),
        model=raw.get("model", {}),
        generator_kwargs=raw.get("generator_kwargs", {}),
        train=TrainConfig(**raw.get("train", {})),
        sampling=SamplingConfig(**raw.get("sampling", {})),
        transforms=tuple(raw.get("transforms", ())),
        auxiliary_task=raw.get("auxiliary_task", "uncond"),
        debug=raw.get("debug", False),
        synthetic_data=raw.get("synthetic_data", False),
        num_seeds=raw.get("num_seeds", 3),
        cache_dir=raw.get("cache_dir", "cache"),
        allow_linear_fallback=raw.get("allow_linear_fallback", False),
    )
    return cfg


def build_config(experiment: str, overrides: Optional[list[str]] = None,
                 **kwargs) -> FrameworkConfig:
    """Assemble a config from a preset + dotted key=value overrides
    (the `++generator.auxilary_task=uncond` role of the reference's task files)."""
    preset = EXPERIMENTS[experiment]
    cfg = FrameworkConfig(experiment=experiment, **kwargs)
    # a copy: a `tokenizer.*` override must not edit the preset (JAX's
    # build_config shares the preset's dict, so there it does, process-wide)
    cfg.tokenizer = None if preset.get("tokenizer") is None else dict(preset["tokenizer"])
    cfg.transforms = tuple(preset.get("transforms", ()))
    cfg.model = dict(preset.get("model", {}))
    cfg.generator_kwargs = dict(preset.get("generator_kwargs", {}))
    for k, v in preset.get("train", {}).items():
        setattr(cfg.train, k, v)
    for ov in overrides or []:
        apply_override(cfg, ov)
    return cfg


def apply_override(cfg: FrameworkConfig, override: str) -> None:
    """`a.b.c=value` with json-ish value parsing.  Frozen dataclasses
    (SamplingConfig, DatasetConfig) are rebuilt via dataclasses.replace."""
    key, _, value = override.lstrip("+").partition("=")
    try:
        value = json.loads(value)
    except json.JSONDecodeError:
        pass
    parts = key.split(".")
    parent: Any = None
    parent_attr: Optional[str] = None
    obj: Any = cfg
    for p in parts[:-1]:
        parent, parent_attr = obj, p
        obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
    last = parts[-1]
    if isinstance(obj, dict):
        obj[last] = value
    elif dataclasses.is_dataclass(obj) and getattr(
        type(obj), "__dataclass_params__"
    ).frozen:
        new_obj = dataclasses.replace(obj, **{last: value})
        if isinstance(parent, dict):
            parent[parent_attr] = new_obj
        else:
            setattr(parent, parent_attr, new_obj)
    else:
        setattr(obj, last, value)


# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------


def build_tokenizer(cfg: FrameworkConfig) -> Optional[LayoutSequenceTokenizer]:
    if cfg.tokenizer is None:
        return None
    tk = dict(cfg.tokenizer)
    tk.setdefault("num_labels", cfg.dataset.num_labels)
    tk.setdefault("max_seq_length", cfg.dataset.max_seq_length)
    tk.setdefault("num_bin", 128)
    if tk.get("geo_quantization") == "kmeans" and "kmeans_centers" not in tk:
        # adaptive vocabulary fitted on the train split (the cache's
        # `{ds}_kmeans_train_clusters.pkl`)
        from ralf_tpu_torch import cache as cache_mod

        centers = cache_mod.load_kmeans_centers(
            cfg.cache_dir, cfg.dataset.name, tk["num_bin"]
        )
        if centers is not None:
            tk["kmeans_centers"] = centers
        elif cfg.allow_linear_fallback:
            logging.getLogger(__name__).warning(
                "kmeans centers missing from %s for %s — DOWNGRADING the "
                "tokenizer to the linear vocabulary (allow_linear_fallback)",
                cfg.cache_dir, cfg.dataset.name,
            )
            tk["geo_quantization"] = "linear"
        else:
            raise FileNotFoundError(
                f"tokenizer preset requires kmeans centers but "
                f"{cache_mod.kmeans_clusters_path(cfg.cache_dir, cfg.dataset.name)} "
                f"is missing. Build it first (the JAX package's `cli.build_caches "
                f"--what clusters --dataset {cfg.dataset.name} --cache-dir "
                f"{cfg.cache_dir}` writes the file both packages read), or pass "
                f"allow_linear_fallback=true to use the linear vocabulary instead."
            )
    tk["special_tokens"] = tuple(tk.get("special_tokens", ("pad", "bos", "eos")))
    return LayoutSequenceTokenizer(TokenizerConfig(**tk))


def build_generator(cfg: FrameworkConfig, tokenizer=None, device="cuda"):
    """The generator of the experiment preset, with random weights from
    `cfg.train.seed` until `utils.weights.load_jax_params` fills its core."""
    name = EXPERIMENTS[cfg.experiment]["generator"]
    gcfg = GeneratorConfig(**cfg.model)
    hw = (cfg.dataset.image_h, cfg.dataset.image_w)
    kw = dict(cfg.generator_kwargs)
    common = dict(device=device, seed=cfg.train.seed)
    if name == "autoreg":
        from ralf_tpu_torch.models.autoreg import AutoregGenerator

        return AutoregGenerator(tokenizer, gcfg, cfg.auxiliary_task, hw, **common, **kw)
    if name == "ralf":
        from ralf_tpu_torch.models.ralf import RALFGenerator

        return RALFGenerator(tokenizer, gcfg, cfg.auxiliary_task, hw, **common, **kw)
    if name == "maskgit":
        from ralf_tpu_torch.models.maskgit import MaskGITGenerator

        return MaskGITGenerator(tokenizer, gcfg, image_hw=hw, **common, **kw)
    if name == "layoutdm":
        from ralf_tpu_torch.models.diffusion import LayoutDMGenerator

        return LayoutDMGenerator(tokenizer, gcfg, image_hw=hw, **common, **kw)
    S = cfg.dataset.max_seq_length
    if name == "cglgan":
        from ralf_tpu_torch.models.cgl_gan import CGLGANGenerator

        return CGLGANGenerator(cfg.dataset.num_labels, gcfg, cfg.auxiliary_task, S, hw,
                               **common, **kw)
    if name == "dsgan":
        from ralf_tpu_torch.models.dsgan import DSGANGenerator

        return DSGANGenerator(cfg.dataset.num_labels, gcfg, cfg.auxiliary_task, S, hw,
                              **common, **kw)
    if name == "icvt":
        from ralf_tpu_torch.models.icvt import ICVTGenerator

        return ICVTGenerator(cfg.dataset.num_labels, gcfg, max_seq_length=S, image_hw=hw,
                             **common, **kw)
    if name == "retriever":
        from ralf_tpu_torch.models.retriever_baseline import RetrieverGenerator

        return RetrieverGenerator.build(build_datasets(cfg)[0], device=device, **kw)
    raise ValueError(f"unknown generator: {name}")


def build_datasets(cfg: FrameworkConfig):
    """(train, val, test) datasets: the parquet dumps under
    `cfg.dataset.data_dir`, or the synthetic set (64/16/16 canvases with
    `debug`, else 512/64/64; seeds 0, 1, 2)."""
    from ralf_tpu_torch.data.dataset import HFParquetDataset, SyntheticPosterDataset

    if cfg.synthetic_data or not cfg.dataset.data_dir:
        sizes = (64, 16, 16) if cfg.debug else (512, 64, 64)
        return tuple(
            SyntheticPosterDataset(cfg.dataset, size=s, seed=i)
            for i, s in enumerate(sizes)
        )
    return tuple(
        HFParquetDataset(cfg.dataset, split) for split in ("train", "val", "test")
    )
