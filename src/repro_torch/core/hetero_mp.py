"""Heterogeneous message passing with D-ReLU + DR-SpMM (the paper's core).

One HeteroConv layer (paper Fig. 1 / Fig. 5) = three edge-type modules::

    near   : SageConv   cell -> cell
    pinned : SageConv   net  -> cell
    pin    : GraphConv  cell -> net

with the cell-side merge Y_cell = max(near_out, pinned_out) (Eq. 8) and
Y_net = pin_out (Eq. 9).  Each node type is sparsified once per layer
(D-ReLU -> CBSR) and shared by every relation consuming it; a type whose
k is at least the width, or every type with D-ReLU off, stays dense.

* **plan path** (:func:`plan_applicable`: ``use_plan``, D-ReLU on,
  ``backend="fused"`` and k < width on both types): the whole message
  passing runs over the graph's :class:`RelationPlan` in one
  ``drspmm_multi`` call, one arena-kernel launch plus at most one
  dense-tier launch; over a :class:`ShardedRelationPlan`
  (``n_shards > 1``) one ``drspmm_multi_sharded`` call, one arena-kernel
  launch per shard.
* **serial path** (every other config): the reference's per-relation loop
  over ``graph.edges``, one ``ops.drspmm`` per CBSR-sourced relation and
  one ``ops.spmm`` per dense-sourced one, each with ``cfg.backend``, then
  the same merge.  A collated batch's edges are fused arenas, which run
  the fused kernels under either backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core.cbsr import CBSR, cbsr_from_dense
from repro_torch.core.drelu import drelu
from repro_torch.graphs.circuit import CircuitGraph
from repro_torch.graphs.ell import RelationPlan
from repro_torch.kernels import ops
from repro_torch.kernels.drelu_topk import drelu_bisect
from repro_torch.sharding.plan_shard import ShardedRelationPlan

DRELU_BACKENDS = ("topk", "bisect")


@dataclasses.dataclass(frozen=True)
class HeteroMPConfig:
    hidden: int = 64
    k_cell: int = 16          # D-ReLU K for cell-sourced embeddings
    k_net: int = 16           # D-ReLU K for net-sourced embeddings
    # "topk": sort-based threshold; "bisect": the paper's row-wise binary
    # search as a CUDA kernel (the reference calls it "pallas")
    drelu_backend: str = "topk"
    # dense-tier nnz crossover for plans the model builds itself (None: the
    # DENSE_TIER_NNZ constant); collated plans were tiered at pack time
    dense_threshold: Optional[int] = None
    # False: the dense baseline (plain SpMM per relation, ReLU activation)
    use_drelu: bool = True
    # executor family of the serial path's single-relation ops: "fused"
    # (the reference's pallas_fused / xla_fused) or "bucket" (its pallas /
    # xla: one launch per degree bucket); the plan path needs "fused"
    backend: str = "fused"
    # False pins the serial per-relation path
    use_plan: bool = True
    # > 1: the model partitions a plain graph's plan over that many shards
    # (``sharding/plan_shard.py``, placed by ``shard_devices``) and the
    # layer runs ``ops.drspmm_multi_sharded``; a graph that carries a plan
    # (a collated batch, a sharded plan) runs the plan it carries
    n_shards: int = 0

    def __post_init__(self):
        if self.drelu_backend not in DRELU_BACKENDS:
            raise ValueError(f"unknown drelu_backend {self.drelu_backend!r}; "
                             f"expected one of {DRELU_BACKENDS}")
        ops.check_backend(self.backend)


class HeteroLayer(nn.Module):
    """Per-edge-type weights (Eq. 4's W^ψ) + SAGE self paths, in the
    reference's ``(in, out)`` layout so that ``x @ W`` matches."""

    def __init__(self, hidden: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s = 1.0 / math.sqrt(hidden)

        def mk():
            w = torch.rand((hidden, hidden), generator=generator) * 2 * s - s
            return nn.Parameter(w.to(device))

        self.w_near = mk()
        self.w_near_self = mk()
        self.w_pinned = mk()
        self.w_pinned_self = mk()
        self.w_pin = mk()
        self.b_cell = nn.Parameter(torch.zeros(hidden, device=device))
        self.b_net = nn.Parameter(torch.zeros(hidden, device=device))


def _sparsify(x_src: torch.Tensor, k: int, cfg: HeteroMPConfig) -> CBSR:
    """D-ReLU -> CBSR.  Under ``bisect`` the kernel's output carries the
    straight-through gradient of the survivors, as in the reference."""
    if cfg.drelu_backend == "bisect":
        xs = drelu_bisect(x_src.detach().contiguous(), k)
        xs = xs + (x_src - x_src.detach()) * (xs != 0)
    else:
        xs = drelu(x_src, k)
    return cbsr_from_dense(xs, k)


def _sparsify_types(x_cell: torch.Tensor, x_net: torch.Tensor,
                    cfg: HeteroMPConfig
                    ) -> Tuple[Optional[CBSR], Optional[CBSR]]:
    """Per-type CBSR, computed once per layer and shared by every relation
    consuming the type (``near`` and ``pin`` both read the cell slab);
    None where the type stays dense (k >= width, or D-ReLU off)."""
    c_cell = _sparsify(x_cell, cfg.k_cell, cfg) \
        if cfg.use_drelu and cfg.k_cell < x_cell.shape[-1] else None
    c_net = _sparsify(x_net, cfg.k_net, cfg) \
        if cfg.use_drelu and cfg.k_net < x_net.shape[-1] else None
    return c_cell, c_net


def plan_applicable(cfg: HeteroMPConfig, hidden: int) -> bool:
    """True iff the plan path serves this config: ``use_plan``, the fused
    backend and CBSR aggregation on both node types.  The one gate shared
    by the model and the trainer's plan attachment."""
    return (cfg.use_plan and cfg.use_drelu and cfg.backend == "fused"
            and cfg.k_cell < hidden and cfg.k_net < hidden)


def _aggregate(graph: CircuitGraph, etype: str, x_src: torch.Tensor,
               c: Optional[CBSR], cfg: HeteroMPConfig) -> torch.Tensor:
    """A^ψ · D-ReLU(x_src) for one edge type: DR-SpMM over the source
    type's shared CBSR ``c``, or the dense SpMM where ``c`` is None."""
    es = graph.edges[etype]
    if c is not None:
        return ops.drspmm(es.adj, es.adj_t, c.values, c.idx,
                          x_src.shape[-1], backend=cfg.backend)
    return ops.spmm(es.adj, es.adj_t, x_src, backend=cfg.backend)


def _merge(layer: HeteroLayer, x_cell: torch.Tensor, agg_near: torch.Tensor,
           agg_pinned: torch.Tensor, agg_pin: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    near_out = agg_near @ layer.w_near + x_cell @ layer.w_near_self
    pinned_out = agg_pinned @ layer.w_pinned + x_cell @ layer.w_pinned_self
    pin_out = agg_pin @ layer.w_pin
    y_cell = torch.maximum(near_out, pinned_out) + layer.b_cell
    y_net = pin_out + layer.b_net
    return y_cell, y_net


def hetero_conv(layer: HeteroLayer,
                over: Union[RelationPlan, ShardedRelationPlan, CircuitGraph],
                x_cell: torch.Tensor, x_net: torch.Tensor,
                cfg: HeteroMPConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One HeteroConv layer.  Returns (y_cell, y_net).

    ``over`` is the layer's :class:`RelationPlan` (tables on the features'
    device) or placed :class:`ShardedRelationPlan` on the plan path, or the
    :class:`CircuitGraph` whose edge packings the serial loop runs (their
    device tables are memoised per adjacency)."""
    c_cell, c_net = _sparsify_types(x_cell, x_net, cfg)
    if isinstance(over, (RelationPlan, ShardedRelationPlan)):
        cbsr = {"cell": (c_cell.values, c_cell.idx),
                "net": (c_net.values, c_net.idx)}
        aggs = ops.drspmm_multi_sharded(
            over, cbsr, x_cell.shape[-1], backend=cfg.backend) \
            if isinstance(over, ShardedRelationPlan) \
            else ops.drspmm_multi(over, cbsr, x_cell.shape[-1])
        return _merge(layer, x_cell, aggs["near"], aggs["pinned"],
                      aggs["pin"])
    agg_near = _aggregate(over, "near", x_cell, c_cell, cfg)    # cell->cell
    agg_pinned = _aggregate(over, "pinned", x_net, c_net, cfg)  # net->cell
    agg_pin = _aggregate(over, "pin", x_cell, c_cell, cfg)      # cell->net
    return _merge(layer, x_cell, agg_near, agg_pinned, agg_pin)
