"""Block-diagonal collation: N CircuitGraphs -> one CircuitGraph per batch.

Member graphs share one node space per node type::

    cell ids of member i live in [cell_off_i, cell_off_i + n_cell_i)
    net  ids of member i live in [net_off_i,  net_off_i  + n_net_i)

Edges never cross members, so the batched forward is the direct sum of the
members' forwards (up to fp32 summation order).  Member edges are recovered
from their ELL packings, offset, packed once per direction, and the batch
gets one :class:`RelationPlan` over the merged relations.

Collation here is exact-size: PyTorch runs eagerly and keeps no compile
cache whose signatures padding would have to keep stable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graphs.circuit import (CircuitGraph, EDGE_SCHEMA, EDGE_TYPES,
                                        EdgeSet)
from repro_torch.graphs.ell import (DEFAULT_BOUNDS, RelationPlan, _round_up,
                                    _to_tensor, build_relation_plan,
                                    ell_to_coo, pack_ell)

# Default bucket-grid resolution (mantissa bits of the geometric grid).
NODE_GRID_BITS = 2


def quantize_up(n: int, mantissa_bits: int = NODE_GRID_BITS,
                minimum: int = 8) -> int:
    """Round ``n`` up to the next point of a geometric grid with
    ``2**mantissa_bits`` points per octave (max relative padding
    ``2**-mantissa_bits``)."""
    n = max(int(n), minimum)
    if n <= minimum:
        return minimum
    e = n.bit_length() - 1 - mantissa_bits
    if e <= 0:
        return n
    return _round_up(n, 1 << e)


@dataclasses.dataclass(frozen=True)
class MemberSlice:
    """Where one member graph lives inside the collated node spaces."""
    cell_off: int
    n_cell: int
    net_off: int
    n_net: int


@dataclasses.dataclass
class CollatedBatch:
    """One collated dispatch unit: the block-diagonal graph (its plan
    attached), where each member lives in it, and the training loss
    weights.  ``cell_weight`` holds 1/(n_real·n_cell_i) on member i's cells
    for the first ``n_real`` members and 0 on filler members, so
    ``Σ cell_weight·(pred − y)²`` is the mean of the real members' MSE
    losses."""

    graph: CircuitGraph
    members: Tuple[MemberSlice, ...]
    cell_weight: torch.Tensor       # (n_cell,) fp32, on the batch's device
    n_real: int                     # members that carry real graphs

    @property
    def plan(self) -> Optional[RelationPlan]:
        return self.graph.plan


def collate_graphs(graphs: Sequence[CircuitGraph], *,
                   bounds: Sequence[int] = DEFAULT_BOUNDS,
                   n_real: Optional[int] = None,
                   with_plan: bool = True,
                   device="cuda") -> CollatedBatch:
    """Merge member graphs into one block-diagonal :class:`CircuitGraph`
    with its :class:`RelationPlan` attached, on ``device``.  The first
    ``n_real`` members (all by default) carry the loss weight; trailing
    members are filler with weight 0.  ``with_plan=False`` builds and
    copies no plan (the D-ReLU-off path reads only the edge packings)."""
    device = resolve_device(device)
    if not graphs:
        raise ValueError("collate_graphs needs at least one member")
    n_real = len(graphs) if n_real is None else int(n_real)
    if not 0 < n_real <= len(graphs):
        raise ValueError(f"n_real={n_real} outside 1..{len(graphs)}")
    f_cell = graphs[0].x_cell.shape[1]
    f_net = graphs[0].x_net.shape[1]
    if not all(g.x_cell.shape[1] == f_cell and g.x_net.shape[1] == f_net
               for g in graphs):
        raise ValueError("members must share feature widths")

    members, cell_off, net_off = [], 0, 0
    for g in graphs:
        members.append(MemberSlice(cell_off=cell_off, n_cell=g.n_cell,
                                   net_off=net_off, n_net=g.n_net))
        cell_off += g.n_cell
        net_off += g.n_net
    sizes = {"cell": cell_off, "net": net_off}

    x_cell = np.zeros((cell_off, f_cell), np.float32)
    x_net = np.zeros((net_off, f_net), np.float32)
    y_cell = np.zeros(cell_off, np.float32)
    w_cell = np.zeros(cell_off, np.float32)
    for i, (g, m) in enumerate(zip(graphs, members)):
        x_cell[m.cell_off:m.cell_off + m.n_cell] = g.x_cell.cpu().numpy()
        x_net[m.net_off:m.net_off + m.n_net] = g.x_net.cpu().numpy()
        y_cell[m.cell_off:m.cell_off + m.n_cell] = g.y_cell.cpu().numpy()
        if i < n_real:
            w_cell[m.cell_off:m.cell_off + m.n_cell] = \
                1.0 / (n_real * m.n_cell)

    off_of = {"cell": [m.cell_off for m in members],
              "net": [m.net_off for m in members]}
    edges: Dict[str, EdgeSet] = {}
    relations = []
    for et in EDGE_TYPES:
        s_t, d_t = EDGE_SCHEMA[et]
        ds, ss, ws = [], [], []
        for i, g in enumerate(graphs):
            dst, src, w = ell_to_coo(g.edges[et].adj)
            ds.append(dst + off_of[d_t][i])
            ss.append(src + off_of[s_t][i])
            ws.append(w)
        dst, src, w = np.concatenate(ds), np.concatenate(ss), np.concatenate(ws)
        n_dst, n_src = sizes[d_t], sizes[s_t]
        # one degree-bucketed pack per direction, shared by the graph's
        # edge sets and the relation plan
        edges[et] = EdgeSet(adj=pack_ell(dst, src, w, n_dst, n_src, bounds),
                            adj_t=pack_ell(src, dst, w, n_src, n_dst, bounds))
        relations.append((et, s_t, d_t, dst, src, w))

    plan = build_relation_plan(
        relations, sizes, bounds=bounds,
        packed={et: (e.adj, e.adj_t) for et, e in edges.items()}) \
        if with_plan else None
    graph = CircuitGraph(n_cell=cell_off, n_net=net_off, edges=edges,
                         x_cell=torch.from_numpy(x_cell),
                         x_net=torch.from_numpy(x_net),
                         y_cell=torch.from_numpy(y_cell), plan=plan)
    return CollatedBatch(graph=graph.to(device), members=tuple(members),
                         cell_weight=_to_tensor(w_cell, device),
                         n_real=n_real)
