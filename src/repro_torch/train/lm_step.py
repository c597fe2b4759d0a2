"""Train and serve steps for the LM substrate, one device.

Port of ``repro/train/lm_step.py``.  ``make_train_step`` returns a
(state, batch) -> (state, metrics) closure: ``grad_accum`` microbatches
(the batch's leading dimension) accumulated in fp32 in order and divided
once, then AdamW under the schedule (cosine, or WSD for minicpm) at the
pre-update step.  ``grad_norm`` is the pre-clip global norm, as the
reference reports it.  The step updates the parameters and the optimizer
state in place and returns the same state; the metrics are 0-d tensors on
the parameters' device (``lr`` a float), so a caller reads them back only
when it wants them.

The int8-compressed cross-pod gradient all-reduce (``compress_pod_grads``)
and the mesh shardings (``train_state_shardings``) are multi-device and
raise (ROADMAP.md §1 item 6, multi-device LM training).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import serve
from repro_torch.models.lm.common import _map_template
from repro_torch.models.lm.model import LM
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm, tree_leaves)
from repro_torch.optim.schedules import cosine, wsd


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def make_schedule(cfg: ArchConfig, lr: float, total_steps: int):
    if cfg.lr_schedule == "wsd":
        return wsd(lr, total_steps)
    return cosine(lr, total_steps, warmup=max(total_steps // 100, 1))


def make_train_step(lm: LM, *, lr: float = 3e-4, total_steps: int = 10_000,
                    weight_decay: float = 0.1, grad_clip: float = 1.0,
                    grad_accum: int = 1,
                    compress_pod_grads: bool = False) -> Callable:
    if compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads: the int8 cross-pod gradient all-reduce is "
            "multi-device LM training (ROADMAP.md §1 item 6)")
    sched = make_schedule(lm.cfg, lr, total_steps)

    def value_and_grads(params, batch) -> Tuple[torch.Tensor, list]:
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = lm.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def accumulated(params, batch):
        if grad_accum <= 1:
            return value_and_grads(params, batch)
        # batch leading dim = grad_accum microbatches
        leaves = tree_leaves(params)
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(grad_accum):
            l, g = value_and_grads(params, {k: v[i] for k, v in
                                            batch.items()})
            loss = loss + l
            acc = [a + gi for a, gi in zip(acc, g)]
        return loss / grad_accum, [a / grad_accum for a in acc]

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        loss, grads = accumulated(state.params, batch)
        lr_now = sched(state.opt.step)
        # grads are in tree_leaves(params)'s order
        adamw_update(state.params, grads, state.opt, lr_now,
                     weight_decay=weight_decay, grad_clip=grad_clip)
        gnorm = global_norm(grads)      # before the clip
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr_now}

    return train_step


def init_train_state(lm: LM, generator: torch.Generator) -> TrainState:
    """Fresh weights drawn from ``generator`` (on the model's device) into
    the model, and zero moments."""
    params = lm.init(generator)
    return TrainState(params=params, opt=adamw_init(params))


def abstract_train_state(lm: LM) -> TrainState:
    """The state's shapes and dtypes on the meta device (no allocation):
    fp32 parameters and moments, step 0."""
    meta = lambda _, spec: torch.empty(spec.shape, dtype=torch.float32,
                                       device="meta")
    return TrainState(
        params=_map_template(lm.template, meta),
        opt=AdamWState(step=0, m=_map_template(lm.template, meta),
                       v=_map_template(lm.template, meta)))


def train_state_shardings(lm: LM, mesh) -> TrainState:
    raise NotImplementedError(
        "train_state_shardings: mesh shardings are multi-device LM training "
        "(ROADMAP.md §1 item 6)")


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_serve_steps(lm: LM):
    def prefill_fn(params, tokens, extra=None):
        return serve.prefill(lm, params, tokens, extra)

    def decode_fn(params, cache, token, pos):
        return serve.decode_step(lm, params, cache, token, pos)

    return prefill_fn, decode_fn
