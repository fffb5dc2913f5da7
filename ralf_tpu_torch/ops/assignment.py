"""The exact linear-sum assignment of each batch row, the counterpart of
`ralf_tpu/ops/assignment.py::batched_lsa` (the Jonker-Volgenant shortest
augmenting paths with potentials, which JAX runs as lax while-loops: an XLA
computation, no Pallas kernel).

`batched_lsa(cost)` takes [B, n, n] fp32 costs and returns [B, n] int32,
the column assigned to each row, exact: the permutation of least total
cost, ties broken as JAX breaks them.  On a CUDA tensor it launches the
kernel of `csrc/assignment.cu` (one warp a row, n <= 32; larger n raises),
on a CPU tensor it runs `batched_lsa_plain`.

The plain version follows JAX's `_lsa_one` step by step, for all rows at
once: the 1-based frame padded with a virtual column and row 0, `_INF =
1e30`, each Dijkstra step's first-index argmin over the masked `minv` and
the potentials update (u += delta on the used columns' rows, v -= delta on
the used columns, minv -= delta on the others), in JAX's fp32 order.  A row
whose search has ended stands still while the others step, so it takes as
many steps as its slowest row, each a few tensor ops: about 25 launches a
step on a card, the reason for the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ralf_tpu_torch.ops import _build

INF = 1e30  # ralf_tpu/ops/assignment.py _INF, as float32
MAX_N = 32  # one lane a column

_SIGNATURES = {
    "ralf_batched_lsa": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p],
}


def batched_lsa_plain(cost: torch.Tensor, return_steps: bool = False):
    """Plain PyTorch version of the kernel: [B, n, n] -> [B, n] int32 (and,
    with return_steps, the Dijkstra steps the rows took, summed)."""
    B, n = cost.shape[:2]
    dev = cost.device
    a = F.pad(cost.float(), (1, 0, 1, 0))  # a[b, i, j], i, j in 1..n
    rows = torch.arange(B, device=dev)
    cols = torch.arange(n + 1, device=dev)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    u = torch.zeros(B, n + 1, device=dev)
    v = torch.zeros(B, n + 1, device=dev)
    p = torch.zeros(B, n + 1, dtype=torch.long, device=dev)  # p[b, j]: row matched to column j
    steps = 0
    for i in range(1, n + 1):
        p[:, 0] = i
        minv = torch.full((B, n + 1), INF, device=dev)
        used = torch.zeros(B, n + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(B, n + 1, dtype=torch.long, device=dev)
        j0 = torch.zeros(B, dtype=torch.long, device=dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)
        while True:  # p[0] = i != 0: each row steps at least once
            act = active[:, None]
            used = used | (act & (cols == j0[:, None]))
            i0 = p.gather(1, j0[:, None])  # [B, 1]
            cur = a[rows, i0[:, 0]] - u.gather(1, i0) - v
            live = ~used & (cols > 0)
            better = act & live & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            masked = torch.where(live, minv, inf)
            j1 = masked.argmin(dim=1)  # the first index of the least
            delta = masked.gather(1, j1[:, None])
            # every used column shifts its matched row's u (distinct rows) and its
            # own v by delta; the unused ones shrink minv
            u = u.scatter_add(1, p, torch.where(act & used, delta, zero))
            v = v - torch.where(act & used, delta, zero)
            minv = torch.where(act & ~used, minv - delta, minv)
            j0 = torch.where(active, j1, j0)
            steps += int(active.sum()) if return_steps else 0
            active = active & (p.gather(1, j0[:, None])[:, 0] != 0)
            if not bool(active.any()):
                break
        walking = j0 != 0  # walk back along way[], shifting each column's row
        while bool(walking.any()):
            j1 = way.gather(1, j0[:, None])
            shift = walking[:, None] & (cols == j0[:, None])
            p = torch.where(shift, p.gather(1, j1), p)
            j0 = torch.where(walking, j1[:, 0], j0)
            walking = j0 != 0
    col = torch.zeros(B, n, dtype=torch.int32, device=dev)
    col.scatter_(1, p[:, 1:] - 1, cols[:n].to(torch.int32).expand(B, n).contiguous())
    return (col, steps) if return_steps else col


def batched_lsa(cost: torch.Tensor) -> torch.Tensor:
    """[B, n, n] fp32 costs -> [B, n] int32, the column assigned to each row.
    Costs must be finite and far below 1e30 (the callers clamp theirs to
    1e5, as JAX's do)."""
    if cost.device.type == "cpu":
        return batched_lsa_plain(cost)
    what = "batched_lsa"
    _build.require_cuda(what, cost)
    if cost.dtype != torch.float32:
        raise TypeError(f"{what}: cost must be float32, got {cost.dtype}")
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2] or cost.shape[0] < 1:
        raise ValueError(f"{what}: cost must be [B, n, n] with B >= 1, got {list(cost.shape)}")
    n = cost.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{what}: the kernel takes 1 <= n <= {MAX_N} (one lane a column), "
                         f"got n = {n}")
    lib = _build.library("assignment", _SIGNATURES)
    out = torch.zeros(cost.shape[:2], dtype=torch.int32, device=cost.device)
    with torch.cuda.device(cost.device):
        rc = lib.ralf_batched_lsa(cost.data_ptr(), out.data_ptr(), cost.shape[0], n,
                                  _build.stream_handle())
    _build.check_launch(rc, what)
    batched_lsa.launches += 1
    return out


batched_lsa.launches = 0
