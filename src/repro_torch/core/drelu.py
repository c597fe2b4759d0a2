"""Dynamic ReLU (D-ReLU) -- row-wise top-k thresholding activation.

Eqs. (2)-(3) of the paper::

    th_i = min(top_k(X_i, k))
    f(X_id) = X_id  if X_id >= th_i  else 0

Ties at the threshold are all kept.  The backward is straight-through on
the survivors (dX = dY where kept, 0 elsewhere); the threshold's
dependence on X is ignored like the kink of ReLU.
"""

from __future__ import annotations

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
