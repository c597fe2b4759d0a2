"""Heterogeneous message passing with D-ReLU + DR-SpMM (the paper's core).

One HeteroConv layer (paper Fig. 1 / Fig. 5) = three edge-type modules::

    near   : SageConv   cell -> cell
    pinned : SageConv   net  -> cell
    pin    : GraphConv  cell -> net

with the cell-side merge Y_cell = max(near_out, pinned_out) (Eq. 8) and
Y_net = pin_out (Eq. 9).

* With D-ReLU on, each node type is sparsified once per layer (D-ReLU ->
  CBSR) and the whole message passing runs over the graph's
  :class:`RelationPlan` in one ``drspmm_multi`` call: one arena-kernel
  launch plus at most one dense-tier launch.
* With D-ReLU off (``use_drelu=False``, the paper's dense-SpMM baseline),
  the layer runs the reference's serial per-relation loop: one
  ``ops.spmm`` per edge type over ``graph.edges``, then the same merge.
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

    def __post_init__(self):
        if self.drelu_backend not in DRELU_BACKENDS:
            raise ValueError(f"unknown drelu_backend {self.drelu_backend!r}; "
                             f"expected one of {DRELU_BACKENDS}")
        if self.use_drelu and not (0 < self.k_cell < self.hidden
                                   and 0 < self.k_net < self.hidden):
            raise ValueError("the plan path needs 0 < k < hidden for both "
                             "node types")


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
                    cfg: HeteroMPConfig) -> Tuple[CBSR, CBSR]:
    """Per-type CBSR, computed once per layer and shared by every relation
    consuming the type (``near`` and ``pin`` both read the cell slab)."""
    return _sparsify(x_cell, cfg.k_cell, cfg), _sparsify(x_net, cfg.k_net, cfg)


def _merge(layer: HeteroLayer, x_cell: torch.Tensor, agg_near: torch.Tensor,
           agg_pinned: torch.Tensor, agg_pin: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    near_out = agg_near @ layer.w_near + x_cell @ layer.w_near_self
    pinned_out = agg_pinned @ layer.w_pinned + x_cell @ layer.w_pinned_self
    pin_out = agg_pin @ layer.w_pin
    y_cell = torch.maximum(near_out, pinned_out) + layer.b_cell
    y_net = pin_out + layer.b_net
    return y_cell, y_net


def hetero_conv(layer: HeteroLayer, over: Union[RelationPlan, CircuitGraph],
                x_cell: torch.Tensor, x_net: torch.Tensor,
                cfg: HeteroMPConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One HeteroConv layer.  Returns (y_cell, y_net).

    With D-ReLU on, ``over`` is the layer's :class:`RelationPlan` (tables
    on the features' device).  With it off, ``over`` is the
    :class:`CircuitGraph` whose edge packings the serial loop runs: three
    ``ops.spmm`` calls (their arenas are memoised on the features'
    device)."""
    if not cfg.use_drelu:
        es = over.edges
        agg_near = ops.spmm(es["near"].adj, es["near"].adj_t, x_cell)
        agg_pinned = ops.spmm(es["pinned"].adj, es["pinned"].adj_t, x_net)
        agg_pin = ops.spmm(es["pin"].adj, es["pin"].adj_t, x_cell)
        return _merge(layer, x_cell, agg_near, agg_pinned, agg_pin)
    plan = over
    c_cell, c_net = _sparsify_types(x_cell, x_net, cfg)
    aggs = ops.drspmm_multi(plan, {"cell": (c_cell.values, c_cell.idx),
                                   "net": (c_net.values, c_net.idx)},
                            x_cell.shape[-1])
    return _merge(layer, x_cell, aggs["near"], aggs["pinned"], aggs["pin"])
