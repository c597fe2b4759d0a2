"""AdamW as the reference writes it (``repro/optim/adamw.py``), over a
model's parameter list or parameter tree.

b1 0.9, b2 0.95, eps 1e-8; the decay is decoupled and scaled by the
learning rate: ``delta = m̂/(√v̂ + eps) + wd·p``, ``p ← p − lr·delta``.
An optional clip scales the gradients to a global L2 norm first.  Moments
are fp32, live beside the parameters on their device, and mirror the
parameters' structure: a list for a list, nested dicts for a tree (the
LM's ``lm.params()``), leaf for leaf as the reference's pytree state.

Unlike the reference's pure pytree update, :func:`adamw_update` updates
the parameters and the state in place (no second copy of either).  A
caller that skips a step (non-finite gradients) simply does not call it:
parameters, moments and the step counter then all stay as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts / lists / tuples, dict keys in sorted
    order (``jax.tree_util``'s order, so sums over leaves add up in the
    reference's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf, the structure kept (lists stay lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


@dataclasses.dataclass
class AdamWState:
    step: int                       # updates applied so far
    m: Any                          # first moments, shaped like the params
    v: Any                          # second moments


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def global_norm(grads) -> torch.Tensor:
    """The L2 norm of every gradient together, in fp32."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 grad_clip: float = 0.0) -> AdamWState:
    """One AdamW step, in place on ``params`` and ``state``.  ``params``,
    ``grads`` and the moments share one structure."""
    grads = [g.float() for g in tree_leaves(grads)]
    if grad_clip > 0.0:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = [g * scale for g in grads]
    state.step += 1
    # bias corrections in fp32, as the reference computes them
    step = torch.tensor(float(state.step), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step)
    for p, g, m, v in zip(tree_leaves(params), grads, tree_leaves(state.m),
                          tree_leaves(state.v)):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return state
