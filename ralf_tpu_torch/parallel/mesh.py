"""The device mesh and its collectives, the counterpart of
`ralf_tpu/parallel/mesh.py` over `torch.distributed`.

JAX builds one SPMD program over a `jax.sharding.Mesh`; the port runs one
process per rank (`torchrun`, or `torch.multiprocessing` in the tests) and
represents the mesh with a `DeviceMesh` (`init_device_mesh`) whose axes
keep JAX's names:

  * `data`    batch data parallelism: batch rows are split over it,
    parameters replicated, gradients averaged with an all-reduce;
  * `gallery` the retrieval gallery's rows are split over it
    (`retrieval.retriever.sharded_topk`); batches are replicated over it;
  * `dcn`     the outer axis across nodes of `make_hybrid_mesh`: batch rows
    are split over (dcn, data) jointly.  On one node the hybrid mesh is a
    reshape, as JAX's is on one slice.

`batch_rows` is JAX's `batch_sharding`: the rows a rank holds.  The
backend is NCCL on the card and gloo on the CPU; `init_distributed` sets the
default group up from torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), or as a world of one without
it, and a rank's device is `cuda:{LOCAL_RANK % device_count}`.

Every collective the port issues goes through this module and is counted
by kind in `COLLECTIVES` (`counting` reads what a block issued).  The
counts stand in for JAX's HLO asserts, which have no torch counterpart:
`assert_dp_train_hlo` (here) and `parallel.decode.assert_clean_decode_hlo`
are assertions over them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
GALLERY_AXIS = "gallery"
DCN_AXIS = "dcn"
BUCKET_BYTES = 64 << 20  # the flat buffers of a gradient all-reduce or a broadcast

COLLECTIVES: collections.Counter = collections.Counter()  # issued so far, by kind


@contextlib.contextmanager
def counting():
    """Yields a Counter that holds, after the block, the collectives issued
    inside it by kind."""
    start = COLLECTIVES.copy()
    seen: collections.Counter = collections.Counter()
    try:
        yield seen
    finally:
        seen.update(COLLECTIVES - start)


# ---- the counted collectives ------------------------------------------------


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over `group` in place."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' `t` concatenated along axis 0, in the group's rank order."""
    COLLECTIVES["all_gather"] += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, 0)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`t` of global rank `src` on every rank of `group`, in place."""
    COLLECTIVES["broadcast"] += 1
    dist.broadcast(t, src, group=group)
    return t


def barrier(group=None) -> None:
    COLLECTIVES["barrier"] += 1
    dist.barrier(group=group)


@contextlib.contextmanager
def rank0_first():
    """Run the block on rank 0, then on the other ranks (which then read
    what rank 0 wrote, a cache file say); a plain block without a group."""
    later = dist.is_initialized() and dist.get_rank() != 0
    if later:
        barrier()
    yield
    if dist.is_initialized() and not later:
        barrier()


class _AllReduceSum(torch.autograd.Function):
    """A sum over a group whose gradient is the sum of the ranks' gradients
    (every rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


def all_reduce_sum_autograd(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    """The tensors in order, cut into runs of one dtype and device of at most
    bucket_bytes (a larger tensor is a run of its own)."""
    run, size = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + n > bucket_bytes):
            yield run
            run, size = [], 0
        run.append(t)
        size += n
    if run:
        yield run


def all_reduce_mean(tensors: Sequence[torch.Tensor], group, size: int,
                    bucket_bytes: int = BUCKET_BYTES) -> None:
    """Average every tensor over `group` (`size` ranks) in place, through one
    flat buffer a bucket: one all-reduce for a model that fits one bucket."""
    for run in _buckets(list(tensors), bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in run])
        all_reduce(flat, group).div_(size)
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0, group=None,
                      bucket_bytes: int = BUCKET_BYTES) -> None:
    """Every tensor of rank `src` on every rank, in place, a flat buffer a bucket."""
    for run in _buckets(list(tensors), bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in run])
        broadcast(flat, src, group)
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))


# ---- the process group --------------------------------------------------------


def init_distributed(device="cuda") -> tuple[torch.device, bool]:
    """(this rank's device, whether this call set the default group up).

    Under torchrun (WORLD_SIZE set) the default group comes from its
    environment, a world of one otherwise; NCCL for a CUDA device, gloo for
    the CPU.  A default group that is already set up is kept."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this machine; pass device='cpu' "
                               "for the gloo backend on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev, True


# ---- the mesh ---------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    """A DeviceMesh over the default group, with JAX's axis names, and the
    groups the port's programs use."""

    device_mesh: object
    axis_names: tuple
    shape: dict  # axis name -> size
    coords: dict  # axis name -> this rank's index on it
    batch_axes: tuple  # (dcn, data) or (data,): the axes batch rows are split over
    num_shards: int  # batch shards: the product of the batch axes' sizes
    batch_index: int  # this rank's shard
    batch_group: object  # the ranks that hold the other shards of this rank's rows

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


def _build_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call init_distributed() first")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the world "
                         f"has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=axis_names)
    sizes = dict(zip(axis_names, shape))
    coords = dict(zip(axis_names, dm.get_coordinate()))
    batch_axes = tuple(a for a in (DCN_AXIS, DATA_AXIS) if a in sizes)
    batch_shape = [sizes[a] for a in batch_axes]
    index = (int(np.ravel_multi_index([coords[a] for a in batch_axes], batch_shape))
             if batch_axes else 0)
    if len(batch_axes) == 1:
        group = dm.get_group(batch_axes[0])
    else:  # the ranks that share every other coordinate, made on every rank in one order
        ranks = dm.mesh.cpu().numpy()
        axes = [axis_names.index(a) for a in batch_axes]
        others = [i for i in range(len(shape)) if i not in axes]
        cols = ranks.transpose(axes + others).reshape(math.prod(batch_shape), -1)
        me = dist.get_rank()
        group = None
        for j in range(cols.shape[1]):
            g = dist.new_group(cols[:, j].tolist())
            if me in cols[:, j]:
                group = g
    return Mesh(dm, axis_names, sizes, coords, batch_axes, math.prod(batch_shape), index, group)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, GALLERY_AXIS)) -> Mesh:
    """Default: every rank on the data axis, the other axes of size 1."""
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return _build_mesh(shape, axis_names)


def make_hybrid_mesh(ici_shape: Sequence[int], num_slices: Optional[int] = None,
                     axis_names: Sequence[str] = (DCN_AXIS, DATA_AXIS, GALLERY_AXIS)) -> Mesh:
    """The outer `dcn` axis of `num_slices` nodes (default: the world over the
    product of ici_shape), `ici_shape` inside each; ranks are laid out node
    by node, as torchrun numbers them."""
    ici = math.prod(ici_shape)
    if num_slices is None:
        if dist.get_world_size() % ici:
            raise ValueError(f"the world of {dist.get_world_size()} is no multiple of {ici_shape}")
        num_slices = dist.get_world_size() // ici
    return _build_mesh((num_slices, *ici_shape), axis_names)


def batch_rows(mesh: Mesh, rows: int) -> tuple[int, int]:
    """The rows [lo, hi) of a batch of `rows` (a multiple of the batch
    shards) that this rank holds: JAX's `batch_sharding`."""
    if rows % mesh.num_shards:
        raise ValueError(f"a batch of {rows} rows does not split over {mesh.num_shards} "
                         "batch shards; pad it first")
    per = rows // mesh.num_shards
    return mesh.batch_index * per, (mesh.batch_index + 1) * per


def take_rows(tree, index: np.ndarray, batch: int):
    """The rows `index` of every leaf of `tree` whose leading axis has length
    `batch` (tensors, arrays, lists, Layouts, dataclasses such as Condition,
    nested dicts); other leaves (scalars, strings) as they are."""
    if isinstance(tree, dict):
        return {k: take_rows(v, index, batch) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: take_rows(getattr(tree, f.name), index, batch)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, torch.Tensor):
        if tree.dim() and tree.shape[0] == batch:
            return tree[torch.as_tensor(index, device=tree.device)]
        return tree
    if isinstance(tree, np.ndarray):
        return tree[index] if tree.ndim and tree.shape[0] == batch else tree
    if isinstance(tree, (list, tuple)) and len(tree) == batch:
        return type(tree)(tree[i] for i in index)
    return tree


def leading_size(tree) -> int:
    """The leading axis of the first tensor or array of `tree` (depth first)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim:
        return int(tree.shape[0])
    children = (tree.values() if isinstance(tree, dict) else
                [getattr(tree, f.name) for f in dataclasses.fields(tree)]
                if dataclasses.is_dataclass(tree) else ())
    for child in children:
        n = leading_size(child)
        if n:
            return n
    return 0


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every leaf with a batch axis; rank-0 leaves (a
    seed, ICVT's KL beta) stay whole, as JAX replicates them."""
    rows = leading_size(batch)
    lo, hi = batch_rows(mesh, rows)
    return take_rows(batch, np.arange(lo, hi), rows)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (once, outside the steps),
    so that a seeding mistake fails a test rather than drifting."""
    broadcast_tensors([t.data for t in (*module.parameters(), *module.buffers())])
    return module


def assert_dp_train_hlo(counts: collections.Counter, expect_sync: bool = True) -> None:
    """Assert that a data-parallel train step's collectives (`counting`)
    meet the DDP contract: all-reduces only (gradients, BatchNorm's
    statistics, loss counts, metrics), and at least one with `expect_sync`
    (batch axes over more than one rank), else the replicas never sync."""
    others = {k: n for k, n in counts.items() if k != "all_reduce" and n}
    if others:
        raise AssertionError(f"dp train step issued collectives other than all-reduce: {others}")
    if expect_sync and not counts.get("all_reduce"):
        raise AssertionError("dp train step over a multi-rank mesh issued no all-reduce: "
                             "the replicas never sync")
