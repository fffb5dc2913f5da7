"""The rows of a batch that one rank holds, and what draws, means and counts
make of them: the row-shard context of the port's multi-GPU programs.

JAX's threefry is counter-based, so a program sharded over the batch draws
for each row what the unsharded program draws (`ralf_tpu/parallel/
decode.py:68-70`).  A `torch.Generator` draws over the shape it is given:
a rank holding rows 64-127 of a batch would draw the stream of rows 0-63.
Inside `row_shard(rows, lo, hi)` every draw site of the port (`draw`)
draws for the whole padded batch of `rows` from its generator, which every
rank seeds alike, and keeps rows [lo, hi): each rank draws what a single
process draws for the same rows, and the generator moves on by the same
amount on every rank.  Outside the context nothing changes.

Two more things depend on the whole batch:
  * a sample program's batch mean (`batch_mean`, the diffusion's relation
    cost) divides by the padded batch's count, with no collective;
  * a train step's statistics and count-normalised losses are global in
    JAX's data-parallel step.  The trainers open the context with the
    batch group: `global_sum` then sums over it with an all-reduce that
    carries autograd (BatchNorm's statistics), and `mean_denominator` turns
    a local count into the denominator of the global mean, given that the
    trainer averages the ranks' gradients.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class RowShard:
    rows: int  # the padded batch of the whole program
    lo: int  # this rank's rows are [lo, hi)
    hi: int
    group: Any = None  # the batch group of a train step (a ProcessGroup), else None
    size: int = 1  # ranks in that group


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("row_shard", default=None)


@contextlib.contextmanager
def row_shard(rows: int, lo: int, hi: int, group=None, size: int = 1):
    """Run the block as rows [lo, hi) of a batch of `rows` (see the module
    docstring); `group` and `size` only for a train step."""
    if not 0 <= lo < hi <= rows:
        raise ValueError(f"rows [{lo}, {hi}) do not lie in a batch of {rows}")
    token = _ACTIVE.set(RowShard(rows, lo, hi, group, size))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def draw(fn: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """`fn(shape)`, a draw whose leading axis is the batch; under a row shard
    the draw of the whole padded batch, cut to this rank's rows."""
    shape = tuple(shape)
    s = _ACTIVE.get()
    if s is None:
        return fn(shape)
    if not shape or shape[0] != s.hi - s.lo:
        raise ValueError(f"a draw of shape {shape} under a row shard of {s.hi - s.lo} rows: "
                         "every draw site's leading axis must be the batch")
    return fn((s.rows, *shape[1:]))[s.lo:s.hi]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() of a tensor whose leading axis is the batch; in a sample
    program's row shard, the sum over the rank's rows divided by the padded
    batch's count, as JAX's sharded program divides."""
    s = _ACTIVE.get()
    if s is None:
        return x.mean()
    if s.group is not None:
        raise RuntimeError("batch_mean is a sample program's mean; a train step averages "
                           "the ranks' gradients")
    return x.sum() / (x.numel() // x.shape[0] * s.rows)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the train step's batch group, differentiably (its
    gradient is the sum of the ranks' gradients); x itself outside a train
    shard."""
    s = _ACTIVE.get()
    if s is None or s.group is None:
        return x
    from ralf_tpu_torch.parallel.mesh import all_reduce_sum_autograd

    return all_reduce_sum_autograd(x, s.group)


def group_size() -> int:
    """The ranks of the train step's batch group (1 outside a train shard)."""
    s = _ACTIVE.get()
    return 1 if s is None or s.group is None else s.size


def mean_denominator(count: torch.Tensor, least: float) -> torch.Tensor:
    """max(count, least) of a loss's data-dependent count.  In a train shard
    the count is summed over the batch group first, and the result divided by
    the group's size: the trainer averages the ranks' gradients, so each
    rank's sum over its rows divided by this is its share of the global mean."""
    s = _ACTIVE.get()
    if s is None or s.group is None:
        return torch.clamp(count, min=least)
    from ralf_tpu_torch.parallel.mesh import all_reduce

    total = count.detach().clone()
    all_reduce(total, s.group)
    return torch.clamp(total, min=least) / s.size
