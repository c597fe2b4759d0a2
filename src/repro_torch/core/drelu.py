"""Dynamic ReLU (D-ReLU) -- row-wise top-k thresholding activation.

Eqs. (2)-(3) of the paper::

    th_i = min(top_k(X_i, k))
    f(X_id) = X_id  if X_id >= th_i  else 0

Ties at the threshold are all kept.  The backward is straight-through on
the survivors (dX = dY where kept, 0 elsewhere); the threshold's
dependence on X is ignored like the kink of ReLU.

The K profiler of Sec. 4.3 (:func:`profile_optimal_k`) picks K per node
type from degree statistics before training.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


class _DReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int) -> torch.Tensor:
        th = torch.topk(x, k, dim=-1).values[..., -1:]
        keep = x >= th
        ctx.save_for_backward(keep)
        return torch.where(keep, x, torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (keep,) = ctx.saved_tensors
        return torch.where(keep, g, torch.zeros_like(g)), None


def drelu(x: torch.Tensor, k: int) -> torch.Tensor:
    """Dense D-ReLU: keep the top-``k`` entries of each row, zero the rest."""
    if k >= x.shape[-1]:
        return x
    return _DReLU.apply(x, k)


def drelu_grouped(x: torch.Tensor, k: int, groups: int) -> torch.Tensor:
    """Split the row into ``groups`` contiguous blocks and keep the
    top-(k/groups) of each (the reference's shard-local D-ReLU of a
    tensor-sharded FFN hidden).  With ``groups = 1``, or a split that does
    not divide, it is :func:`drelu`."""
    f = x.shape[-1]
    if k >= f:
        return x
    if groups <= 1 or f % groups or k % groups:
        return drelu(x, k)
    lead = x.shape[:-1]
    return drelu(x.reshape(*lead, groups, f // groups),
                 k // groups).reshape(*lead, f)


# ---------------------------------------------------------------------------
# K profiling (Sec. 4.3): the candidate K's are the powers of two up to the
# embedding width, and a one-time profiler picks one per node type by a
# byte-count cost model of one DR-SpMM call, the reference's model as it is
# (it holds no time, so it gives the reference's K on any device).
# ---------------------------------------------------------------------------

def candidate_ks(dim: int) -> Tuple[int, ...]:
    """Powers of two from 2 up to ``dim``."""
    ks = []
    k = 2
    while k <= dim:
        ks.append(k)
        k *= 2
    return tuple(ks)


def kernel_cost_model(n_rows: int, nnz: int, k: int, dim: int,
                      max_degree: int, mean_degree: float) -> float:
    """Bytes of one DR-SpMM call (lower is better): the gathers (nnz CBSR
    rows of k values and k indices), the output written once, and a tail
    term for degree imbalance that grows with k."""
    gather = float(nnz) * k * (4 + 4)
    out = float(n_rows) * dim * 4
    imbalance = max(max_degree / max(mean_degree, 1.0) - 1.0, 0.0)
    tail = imbalance * k * n_rows * 4.0 / 32.0
    return gather + out + tail


def profile_optimal_k(degrees, dim: int, quality_floor: int = 2) -> int:
    """The cost-minimal candidate K for one subgraph, given the degrees of
    its destination rows, and at least ``quality_floor``."""
    deg = np.asarray(degrees)
    nnz = int(deg.sum())
    n = int(deg.size)
    maxd = int(deg.max()) if n else 1
    meand = float(deg.mean()) if n else 1.0
    best_k, best_c = quality_floor, float("inf")
    for k in candidate_ks(dim):
        c = kernel_cost_model(n, nnz, k, dim, maxd, meand)
        if c < best_c:
            best_c, best_k = c, k
    return max(best_k, quality_floor)


def hetero_k_values(graph_stats: Dict[str, Dict],
                    dim_by_ntype: Dict[str, int]) -> Dict[str, int]:
    """Per-edge-type K from per-subgraph degree statistics:
    ``graph_stats[etype] = {"degrees": array, "src_type": str}``."""
    return {et: profile_optimal_k(st["degrees"],
                                  dim_by_ntype[st["src_type"]])
            for et, st in graph_stats.items()}
