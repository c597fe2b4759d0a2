"""AdamW as the reference writes it (``repro/optim/adamw.py``), over a
model's parameter list.

b1 0.9, b2 0.95, eps 1e-8; the decay is decoupled and scaled by the
learning rate: ``delta = m̂/(√v̂ + eps) + wd·p``, ``p ← p − lr·delta``.
An optional clip scales the gradients to a global L2 norm first.  Moments
are fp32 and live beside the parameters on their device.

Unlike the reference's pure pytree update, :func:`adamw_update` updates
the parameters and the state in place (no second copy of either).  A
caller that skips a step (non-finite gradients) simply does not call it:
parameters, moments and the step counter then all stay as they were.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch


@dataclasses.dataclass
class AdamWState:
    step: int                       # updates applied so far
    m: List[torch.Tensor]           # first moments, one per parameter
    v: List[torch.Tensor]           # second moments


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=0, m=[zeros(p) for p in params],
                      v=[zeros(p) for p in params])


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: AdamWState,
                 lr: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float = 0.0) -> AdamWState:
    """One AdamW step, in place on ``params`` and ``state``."""
    grads = [g.float() for g in grads]
    if grad_clip > 0.0:
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = [g * scale for g in grads]
    state.step += 1
    # bias corrections in fp32, as the reference computes them
    step = torch.tensor(float(state.step), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step)
    for p, g, m, v in zip(params, grads, state.m, state.v):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return state
