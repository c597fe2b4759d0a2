"""DR-CircuitGNN (paper Fig. 1): per-type input projection -> N x HeteroConv
-> per-cell linear head (congestion regression in [0, 1]).

Every layer runs its whole message passing over the graph's
:class:`RelationPlan` (``core/hetero_mp.py``); the inter-layer activation
is D-ReLU in its dense form, as in the paper.  Weights keep the
reference's ``(in, out)`` layout, so :meth:`DRCircuitGNN.from_jax_params`
copies a reference parameter tree over as it is.  ``loss_fn`` and
``batched_loss_fn`` are the training objectives.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.drelu import drelu
from repro_torch.core.hetero_mp import HeteroLayer, HeteroMPConfig, hetero_conv
from repro_torch.graphs.circuit import CircuitGraph, relation_plan_of
from repro_torch.graphs.ell import RelationPlan
from repro_torch.models.backbone import BackboneSpec, apply_stack, spec_for

_LAYER_FIELDS = ("w_near", "w_near_self", "w_pinned", "w_pinned_self",
                 "w_pin", "b_cell", "b_net")


def _uniform(shape, bound: float, generator, device) -> nn.Parameter:
    w = torch.rand(shape, generator=generator) * 2 * bound - bound
    return nn.Parameter(w.to(device))


def _device_plan(graph: CircuitGraph, device: torch.device,
                 dense_threshold: Optional[int]) -> RelationPlan:
    """The graph's plan with its tables on ``device``: a collated batch
    brings it there already; a plain graph gets its memoised host plan
    copied over."""
    plan = graph.plan if graph.plan is not None \
        else relation_plan_of(graph, dense_threshold)
    if isinstance(plan.fwd.nbr, np.ndarray) or plan.fwd.nbr.device != device:
        plan = plan.to(device)
    return plan


class DRCircuitGNN(nn.Module):
    """Weights are drawn on the host from ``generator`` (seed 0 when
    omitted) and placed on ``device``; without a card, ``device="cpu"``
    must be asked for explicitly."""

    def __init__(self, f_cell: int, f_net: int, hidden: int = 64,
                 n_layers: int = 2, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.hidden = hidden
        self.in_cell = _uniform((f_cell, hidden), 1.0 / math.sqrt(f_cell),
                                g, dev)
        self.in_net = _uniform((f_net, hidden), 1.0 / math.sqrt(f_net), g, dev)
        self.layers = nn.ModuleList(
            HeteroLayer(hidden, device=dev, generator=g)
            for _ in range(n_layers))
        self.head_w = _uniform((hidden, 1), 1.0 / math.sqrt(hidden), g, dev)
        self.head_b = nn.Parameter(torch.zeros(1, device=dev))

    @property
    def device(self) -> torch.device:
        return self.in_cell.device

    def forward(self, graph: CircuitGraph, cfg: HeteroMPConfig,
                spec: Optional[BackboneSpec] = None) -> torch.Tensor:
        """Per-cell congestion prediction (n_cell,).  ``graph`` must live
        on the model's device; ``spec`` selects the backbone wiring."""
        dev = self.device
        if graph.x_cell.device != dev:
            raise ValueError(f"graph on {graph.x_cell.device}, model on "
                             f"{dev}; move it with graph.to(device)")
        if cfg.hidden != self.hidden:
            raise ValueError(f"cfg.hidden={cfg.hidden} but the model has "
                             f"hidden={self.hidden}")
        if spec is None:
            spec = spec_for(self.layers, self.hidden)
        plan = _device_plan(graph, dev, cfg.dense_threshold)
        h = (graph.x_cell @ self.in_cell, graph.x_net @ self.in_net)

        def body(layer, state, plan):
            h_cell, h_net = hetero_conv(layer, plan, *state, cfg)
            return drelu(h_cell, cfg.k_cell), drelu(h_net, cfg.k_net)

        h_cell, _ = apply_stack(self.layers, h, body, spec, plan)
        return torch.sigmoid(h_cell @ self.head_w + self.head_b)[:, 0]

    @classmethod
    def from_jax_params(cls, p, *, device="cuda") -> "DRCircuitGNN":
        """A model holding the reference's ``DRCircuitGNNParams`` ``p``
        (any tree with the same attribute names whose leaves convert with
        ``np.asarray``)."""
        f_cell, hidden = np.shape(p.in_cell)
        f_net = np.shape(p.in_net)[0]
        model = cls(f_cell, f_net, hidden, len(p.layers), device=device)
        t = lambda a: torch.from_numpy(np.array(a, np.float32))
        state = {"in_cell": t(p.in_cell), "in_net": t(p.in_net),
                 "head_w": t(p.head_w), "head_b": t(p.head_b)}
        for i, lp in enumerate(p.layers):
            for f in _LAYER_FIELDS:
                state[f"layers.{i}.{f}"] = t(getattr(lp, f))
        model.load_state_dict(state)
        return model


def loss_fn(model: DRCircuitGNN, graph: CircuitGraph, cfg: HeteroMPConfig,
            spec: Optional[BackboneSpec] = None) -> torch.Tensor:
    """Mean squared error of the per-cell prediction."""
    pred = model(graph, cfg, spec)
    return torch.mean((pred - graph.y_cell) ** 2)


def batched_loss_fn(model: DRCircuitGNN, graph: CircuitGraph,
                    cell_weight: torch.Tensor, cfg: HeteroMPConfig,
                    spec: Optional[BackboneSpec] = None) -> torch.Tensor:
    """Loss over a block-diagonal collated batch (``graphs/collate.py``).
    ``cell_weight`` is 1/(n_real·n_cell_i) on member i's cells and 0 on
    filler, so this is the mean of the real members' ``loss_fn`` values
    and its gradient that of the per-graph loop."""
    pred = model(graph, cfg, spec)
    return torch.sum(cell_weight * (pred - graph.y_cell) ** 2)
