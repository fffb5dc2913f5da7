"""Batch-sharded sampling for the whole model zoo, the counterpart of
`ralf_tpu/parallel/zoo.py`.

`parallel.decode.MeshSampler` covers the AR family's decode; this module
gives the same treatment (each rank samples its rows of the padded batch
under the row shard, no collective inside the program, one all-gather a
request) to every other family the CLI serves:

  * RelationMeshSampler  the AR relation task: the decode with retries
    (`ops.relation_decode.relation_aware_decode`), per row throughout;
  * MaskGITMeshSampler   the T-step confidence-driven unmasking;
  * DiffusionMeshSampler LayoutDM, VQDiffusion and their RA variants: the
    host-side `prepare_sample` on the whole batch, then each rank's rows of
    its tensors through the denoising loop (`sample_prepared`);
  * GANMeshSampler       CGL-GAN and DS-GAN: `preprocess` on the whole batch
    (every numpy draw: the initial layouts, the task's conditioning), then
    one generator forward of the rank's rows; logits and boxes come back in
    one all-gather;
  * ICVTMeshSampler      the S argmax steps from the latent z, which each
    rank draws as its rows of the padded batch's draw (JAX draws z at the
    padded batch too);
  * RetrieverMeshSampler the top-1 copy baseline: the rank's queries against
    the gallery's features, which every rank holds whole, as JAX replicates
    them (a gallery shard's reduce would need a collective in the program);
    the layouts are gathered on the host from the indices.

`build_mesh_sampler` is the one dispatch point of `cli.inference --mesh`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ralf_tpu_torch.core.conditioning import Condition, build_forced_tokens, normalize_task
from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.core.sampling import SamplingConfig
from ralf_tpu_torch.parallel.decode import MeshProgram, MeshSampler, make_decode_mesh
from ralf_tpu_torch.parallel.mesh import Mesh, take_rows

__all__ = [
    "RelationMeshSampler",
    "MaskGITMeshSampler",
    "DiffusionMeshSampler",
    "GANMeshSampler",
    "ICVTMeshSampler",
    "RetrieverMeshSampler",
    "build_mesh_sampler",
    "make_decode_mesh",
]


class RelationMeshSampler(MeshSampler):
    """The AR relation task: encode, then the decode with retries."""

    def __init__(self, gen, mesh: Mesh, sampling: SamplingConfig, *,
                 kv_quant: bool = False, self_quant: bool = False,
                 max_retries: int = 8) -> None:
        super().__init__(gen, mesh, sampling, kv_quant=kv_quant, self_quant=self_quant)
        self.max_retries = max_retries

    def _program(self, cond: Condition, generator) -> torch.Tensor:
        from ralf_tpu_torch.ops.relation_decode import (
            build_relation_tensors,
            relation_aware_decode,
        )

        gen = self.gen
        forced = torch.as_tensor(build_forced_tokens(cond, gen.tokenizer), device=gen.device)
        return relation_aware_decode(
            gen.core.decoder, gen.encode_memory(cond), gen.tokenizer, forced,
            build_relation_tensors(cond, gen.tokenizer.max_seq_length), self.sampling,
            generator, max_retries=self.max_retries, kv_quant=self.kv_quant,
            self_quant=self.self_quant)


class MaskGITMeshSampler(MeshProgram):
    """MaskGIT's unmasking loop over the generator's `num_timesteps` steps
    (JAX's per-call count is a setting no caller sets)."""

    def __init__(self, gen, mesh: Mesh, sampling: SamplingConfig) -> None:
        super().__init__(mesh)
        self.gen = gen
        self.sampling = sampling

    def sample(self, cond: Condition, generator: Optional[torch.Generator] = None,
               return_tokens: bool = False):
        gen = self.gen
        B = np.asarray(cond.image).shape[0]
        element_num_known = normalize_task(cond.task) in ("c", "cwh", "refinement")

        def program(index):
            local = take_rows(cond, index, B)
            return gen.unmask(gen.encode_memory(local), *gen.user_tokens(local), self.sampling,
                              generator, gen.num_timesteps, element_num_known)

        seq = self._sharded(B, program)
        layout = gen.tokenizer.decode(seq)
        return (layout, seq) if return_tokens else layout


class DiffusionMeshSampler(MeshProgram):
    """LayoutDM / VQDiffusion (and the RA variants): `prepare_sample` on the
    whole batch, then the denoising loop on each rank's rows."""

    def __init__(self, gen, mesh: Mesh, sampling: SamplingConfig) -> None:
        super().__init__(mesh)
        self.gen = gen
        self.sampling = sampling

    def sample(self, cond: Condition, generator: Optional[torch.Generator] = None,
               return_tokens: bool = False):
        gen = self.gen
        B = np.asarray(cond.image).shape[0]
        prepared = gen.prepare_sample(cond, generator)
        seq = self._sharded(B, lambda index: gen.sample_prepared(
            take_rows(prepared, index, B), self.sampling, generator))
        layout = gen.tokenizer.decode(seq)
        return (layout, seq) if return_tokens else layout


class GANMeshSampler(MeshProgram):
    """CGL-GAN / DS-GAN: the host side on the whole batch, one generator
    forward on each rank's rows."""

    def __init__(self, gen, mesh: Mesh) -> None:
        super().__init__(mesh)
        self.gen = gen

    def sample(self, batch: dict, rng: np.random.Generator) -> Layout:
        from ralf_tpu_torch.models.gan_common import unpack_outputs

        gen = self.gen
        inputs, _ = gen.preprocess(batch, rng)
        B = np.asarray(inputs["image"]).shape[0]

        def program(index):
            logits, boxes = gen._forward(take_rows(inputs, index, B))
            return torch.cat([logits.float(), boxes.float()], dim=-1)

        out = self._sharded(B, program)
        return unpack_outputs(out[..., :gen.K], out[..., gen.K:], gen.K)


class ICVTMeshSampler(MeshProgram):
    """ICVT's argmax loop; the latent z's seed is drawn from `rng` as the
    single-process `sample` draws it, and each rank draws its rows of z at
    the padded batch (or takes them from a given z [B, 1, d])."""

    def __init__(self, gen, mesh: Mesh) -> None:
        super().__init__(mesh)
        self.gen = gen

    def sample(self, batch: dict, rng: np.random.Generator,
               z: Optional[torch.Tensor] = None) -> Layout:
        from ralf_tpu_torch.models.icvt import ATTRS

        gen = self.gen
        seed = int(rng.integers(2**31))
        image = np.asarray(batch["image"])
        B = image.shape[0]

        def program(index):
            zl = None if z is None else torch.as_tensor(z, device=gen.device)[:B][
                torch.as_tensor(index, device=gen.device)]
            ids = gen.sample_ids(image[index], seed, zl)
            return torch.stack([ids[k] for k in ATTRS], dim=-1)

        out = self._sharded(B, program)
        return gen.icvt_tokenizer.decode({k: out[..., i] for i, k in enumerate(ATTRS)})


class RetrieverMeshSampler(MeshProgram):
    """The top-1 copy baseline: each rank's queries against the whole
    gallery's features (`exact_topk`, as `Retriever.predict_top1`)."""

    def __init__(self, gen, mesh: Mesh) -> None:
        super().__init__(mesh)
        self.gen = gen

    def sample(self, batch: dict, rng: Optional[np.random.Generator] = None) -> Layout:
        from ralf_tpu_torch.retrieval.retriever import exact_topk

        r = self.gen.retriever
        image = np.asarray(batch["image"])
        B = image.shape[0]
        idx = self._sharded(B, lambda index: exact_topk(r.embed(image[index]), r.features,
                                                        1)[:, 0]).cpu().numpy()
        return Layout.fromdict({k: v[idx] for k, v in r.layouts.items()}, device=r.device)


def build_mesh_sampler(gen, mesh: Mesh, sampling: Optional[SamplingConfig], *,
                       task: str = "uncond", kv_quant: bool = False, self_quant: bool = False,
                       use_backtrack: bool = True, max_retries: int = 8) -> MeshProgram:
    """The family's mesh sampler for any preset's generator; raises for a
    generator type it does not know, and for --kv-quant/--self-quant on a
    family without int8 caches (nothing falls back quietly)."""
    from ralf_tpu_torch.models.autoreg import AutoregGenerator
    from ralf_tpu_torch.models.cgl_gan import CGLGANGenerator
    from ralf_tpu_torch.models.diffusion import LayoutDMGenerator
    from ralf_tpu_torch.models.icvt import ICVTGenerator
    from ralf_tpu_torch.models.maskgit import MaskGITGenerator
    from ralf_tpu_torch.models.retriever_baseline import RetrieverGenerator

    if (kv_quant or self_quant) and not isinstance(gen, AutoregGenerator):
        raise ValueError(f"--kv-quant/--self-quant require an AR-family generator with int8 "
                         f"cache support; {type(gen).__name__} has none")
    if isinstance(gen, AutoregGenerator):
        if task == "relation" and use_backtrack:
            return RelationMeshSampler(gen, mesh, sampling, kv_quant=kv_quant,
                                       self_quant=self_quant, max_retries=max_retries)
        return MeshSampler(gen, mesh, sampling, kv_quant=kv_quant, self_quant=self_quant)
    if isinstance(gen, MaskGITGenerator):
        return MaskGITMeshSampler(gen, mesh, sampling)
    if isinstance(gen, LayoutDMGenerator):
        return DiffusionMeshSampler(gen, mesh, sampling)
    if isinstance(gen, CGLGANGenerator):  # DS-GAN subclasses CGL-GAN
        return GANMeshSampler(gen, mesh)
    if isinstance(gen, ICVTGenerator):
        return ICVTMeshSampler(gen, mesh)
    if isinstance(gen, RetrieverGenerator):
        return RetrieverMeshSampler(gen, mesh)
    raise TypeError(f"no mesh sampler for generator type {type(gen).__name__}")
