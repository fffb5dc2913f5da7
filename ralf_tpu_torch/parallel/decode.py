"""Batch-sharded sampling, the counterpart of `ralf_tpu/parallel/decode.py`.

JAX jits the sample program (encode, then the KV-cached constrained decode)
once over a mesh, batch rows sharded over its batch axes and parameters
replicated, and asserts that the compiled program holds no collective.
The port runs the same program in every rank on its own rows: each rank
holds the whole parameters, takes its rows of the (host-side, whole-batch)
condition, pads the batch to a multiple of the shards by repeating the last
row as JAX's `_pad` does, and samples them under `parallel.rows.row_shard`,
so that every draw is its rows of the whole padded batch's draw: the tokens
equal a single process's at the same padded batch.  No collective runs in
the program; one all-gather over the batch group returns the tokens, and
the padding rows are stripped.

`assert_clean_decode_hlo` keeps JAX's name as an assertion over the counted
collectives (`parallel.mesh.counting`) of the program and of the request;
each sampler keeps the counts of its last request in `counts`, and its
`compile_and_verify` runs one request and asserts them (the port compiles
nothing ahead of the call).
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ralf_tpu_torch.core.conditioning import Condition, build_forced_tokens
from ralf_tpu_torch.core.sampling import SamplingConfig
from ralf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather,
    batch_rows,
    counting,
    make_mesh,
    take_rows,
)
from ralf_tpu_torch.parallel.rows import row_shard


def assert_clean_decode_hlo(program: collections.Counter,
                            request: Optional[collections.Counter] = None) -> None:
    """Assert that a sample program issued no collective and, given the
    request's counts, that the request issued exactly one all-gather (its
    tokens): the two ways a sharded decode could serialize."""
    if sum(program.values()):
        raise AssertionError(f"sharded sample program issued collectives {dict(program)}: "
                             "the per-rank scaling claim is void")
    if request is not None and {k: n for k, n in request.items() if n} != {"all_gather": 1}:
        raise AssertionError(f"a sharded request issued {dict(request)}, not one all-gather")


class MeshProgram:
    """What every batch-sharded sampler shares: the shard count, the padded
    rows and one request's run (`_sharded`)."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.num_shards = mesh.num_shards
        self.counts: tuple = ()  # (program, request) collectives of the last request

    def _rows(self, B: int) -> int:
        return -(-B // self.num_shards) * self.num_shards

    def _sharded(self, B: int, program: Callable[[np.ndarray], torch.Tensor]) -> torch.Tensor:
        """One request of B rows: `program(index)` samples this rank's rows of
        the batch padded to `_rows(B)` (`index`: their rows among the B given,
        the last repeated as JAX's `_pad` does) under the row shard; one
        all-gather returns every rank's, stripped to B.  The padding changes
        the batch shape and with it the draws: results are reproducible per
        (seed, padded shape), as in JAX."""
        rows = self._rows(B)
        lo, hi = batch_rows(self.mesh, rows)
        index = np.minimum(np.arange(lo, hi), B - 1)
        with counting() as request:
            with counting() as in_program, row_shard(rows, lo, hi):
                local = program(index)
            out = all_gather(local, self.mesh.batch_group)[:B]
        self.counts = (in_program, request)
        return out

    def compile_and_verify(self, *args, **kwargs):
        """One request (`sample` with these arguments), then
        `assert_clean_decode_hlo` over its counts; returns its result."""
        out = self.sample(*args, **kwargs)
        assert_clean_decode_hlo(*self.counts)
        return out


class MeshSampler(MeshProgram):
    """The AR family (Autoreg, RALF and its fusion modes) batch-sharded:
    encode, then the KV-cached constrained decode (`gen.decode`).  The
    relation task with backtracking rides `zoo.RelationMeshSampler`."""

    def __init__(self, gen, mesh: Mesh, sampling: SamplingConfig, *,
                 kv_quant: bool = False, self_quant: bool = False) -> None:
        super().__init__(mesh)
        self.gen = gen
        self.sampling = sampling
        self.kv_quant = kv_quant
        self.self_quant = self_quant

    def _program(self, cond: Condition, generator) -> torch.Tensor:
        memory = self.gen.encode_memory(cond)
        return self.gen.decode(memory, build_forced_tokens(cond, self.gen.tokenizer),
                               self.sampling, generator, self.kv_quant, self.self_quant)

    def sample_tokens(self, cond: Condition,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Condition -> sampled token ids [B, L] on every rank."""
        B = np.asarray(cond.image).shape[0]
        return self._sharded(B, lambda index: self._program(take_rows(cond, index, B), generator))

    def sample(self, cond: Condition, generator: Optional[torch.Generator] = None,
               return_tokens: bool = False):
        toks = self.sample_tokens(cond, generator)
        layout = self.gen.tokenizer.decode(toks)
        return (layout, toks) if return_tokens else layout


def make_decode_mesh() -> Mesh:
    """Every rank on one flat `data` axis: decode has no gallery axis, batch
    parallelism is the whole story."""
    return make_mesh((dist.get_world_size(),), (DATA_AXIS,))
