"""Heterogeneous circuit graph container (CircuitNet schema).

Two node types (``cell``, ``net``), three edge types::

    near   : cell -> cell   (geometric)
    pin    : cell -> net    (topological)
    pinned : net  -> cell   (= pinᵀ)

Each edge type carries a forward and a transposed packing: degree-bucketed
ELL (host numpy) for a member graph, or the fused arenas a collated batch
is packed into (``graphs/collate.py``).  Features and labels are tensors,
and the relation plan of a collated batch (or the sharded plan of a large
graph, :func:`with_sharded_plan`) rides along.  :meth:`CircuitGraph.to`
moves the tensors, the fused arenas and the plan to a device (a sharded
plan's shards to :func:`~repro_torch.sharding.specs.shard_devices` of it);
bucketed packings stay on the host, where plans are built.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.graphs.ell import (BucketedELL, FusedELL, RelationPlan,
                                    _to_tensor, build_relation_plan,
                                    ell_to_coo, pack_ell_pair)
from repro_torch.sharding.plan_shard import (ShardedRelationPlan,
                                             shard_relation_plan)

EDGE_TYPES = ("near", "pin", "pinned")
# (source node type, destination node type) per edge type.
EDGE_SCHEMA = {"near": ("cell", "cell"), "pin": ("cell", "net"),
               "pinned": ("net", "cell")}


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    adj: Union[BucketedELL, FusedELL]      # A   (n_dst x n_src)
    adj_t: Union[BucketedELL, FusedELL]    # Aᵀ  (n_src x n_dst)

    def to(self, device) -> "EdgeSet":
        """Fused arenas on ``device``; bucketed packings stay as they are."""
        if not isinstance(self.adj, FusedELL):
            return self
        return EdgeSet(adj=self.adj.to(device), adj_t=self.adj_t.to(device))


@dataclasses.dataclass(frozen=True)
class CircuitGraph:
    n_cell: int
    n_net: int
    edges: Dict[str, EdgeSet]
    x_cell: torch.Tensor            # (n_cell, f_cell) input features
    x_net: torch.Tensor             # (n_net, f_net)
    y_cell: torch.Tensor            # (n_cell,) congestion label
    # relation plan attached by the collator (or a sharded plan,
    # ``with_sharded_plan``); None means the model builds (and memoises)
    # one from ``edges`` on the host
    plan: Optional[Union[RelationPlan, ShardedRelationPlan]] = None

    def to(self, device) -> "CircuitGraph":
        device = torch.device(device)
        return dataclasses.replace(
            self, edges={et: es.to(device) for et, es in self.edges.items()},
            x_cell=_to_tensor(self.x_cell, device),
            x_net=_to_tensor(self.x_net, device),
            y_cell=_to_tensor(self.y_cell, device),
            plan=None if self.plan is None else self.plan.to(device))


# id-keyed memo with weakref guards: plan packing is one-time host work per
# graph.
_PLAN_CACHE: Dict[tuple, tuple] = {}


def relation_plan_of(graph: CircuitGraph,
                     dense_threshold: Optional[int] = None) -> RelationPlan:
    """Memoised host :class:`RelationPlan` covering every edge type of
    ``graph``.  ``dense_threshold`` overrides the dense-tier crossover;
    distinct thresholds memoise separately."""
    if isinstance(graph.plan, RelationPlan) and dense_threshold is None:
        return graph.plan
    key = (id(graph), dense_threshold)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0]() is graph:
        return hit[1]
    rels = []
    for et in EDGE_TYPES:
        if et not in graph.edges:
            continue
        s_t, d_t = EDGE_SCHEMA[et]
        dst, src, w = ell_to_coo(graph.edges[et].adj)
        rels.append((et, s_t, d_t, dst, src, w))
    plan = build_relation_plan(
        rels, {"cell": graph.n_cell, "net": graph.n_net},
        dense_threshold=dense_threshold)
    _PLAN_CACHE[key] = (
        weakref.ref(graph, lambda _: _PLAN_CACHE.pop(key, None)), plan)
    return plan


# (id(graph), n_shards)-keyed memo, weakref-guarded like _PLAN_CACHE: the
# partition is host-side numpy work done once per (graph, shard count)
_SHARDED_PLAN_CACHE: Dict[tuple, tuple] = {}


def sharded_plan_of(graph: CircuitGraph, n_shards: int,
                    registry=None) -> ShardedRelationPlan:
    """Memoised host partition of ``graph``'s relation plan over
    ``n_shards`` shards: each owns one destination slab of the super-arena
    and the halo tables of the source rows it reads from other shards
    (``sharding/plan_shard.py``).  Consumed, placed, by
    ``ops.drspmm_multi_sharded``."""
    key = (id(graph), int(n_shards))
    hit = _SHARDED_PLAN_CACHE.get(key)
    if hit is not None and hit[0]() is graph:
        return hit[1]
    splan = shard_relation_plan(relation_plan_of(graph), n_shards,
                                registry=registry)
    _SHARDED_PLAN_CACHE[key] = (
        weakref.ref(graph, lambda _: _SHARDED_PLAN_CACHE.pop(key, None)),
        splan)
    return splan


def with_sharded_plan(graph: CircuitGraph, n_shards: int) -> CircuitGraph:
    """``graph`` with its ``n_shards``-way host sharded plan attached in
    place of any plan it carries."""
    if isinstance(graph.plan, ShardedRelationPlan) \
            and graph.plan.n_shards == n_shards:
        return graph
    base = dataclasses.replace(graph, plan=None) \
        if graph.plan is not None else graph
    return dataclasses.replace(base, plan=sharded_plan_of(graph, n_shards))


def mean_weights(dst: np.ndarray, n_dst: int) -> np.ndarray:
    """Row-normalised edge weights 1/deg(dst) (SAGE mean aggregator)."""
    deg = np.bincount(dst, minlength=n_dst).astype(np.float32)
    return 1.0 / np.maximum(deg[dst], 1.0)


def build_circuit_graph(coo: Dict[str, Tuple[np.ndarray, np.ndarray]],
                        n_cell: int, n_net: int,
                        x_cell, x_net, y_cell,
                        normalize: str = "mean") -> CircuitGraph:
    """Pack COO edge dicts ``{etype: (dst, src)}`` into a host-side
    :class:`CircuitGraph`.  ``normalize="mean"`` row-normalises edge
    weights; ``"none"`` keeps unit weights."""
    sizes = {"cell": n_cell, "net": n_net}
    edges = {}
    for et, (dst, src) in coo.items():
        s_t, d_t = EDGE_SCHEMA[et]
        n_dst, n_src = sizes[d_t], sizes[s_t]
        w = mean_weights(dst, n_dst) if normalize == "mean" \
            else np.ones(len(dst), np.float32)
        adj, adj_t = pack_ell_pair(dst, src, w, n_dst, n_src)
        edges[et] = EdgeSet(adj=adj, adj_t=adj_t)
    return CircuitGraph(n_cell=n_cell, n_net=n_net, edges=edges,
                        x_cell=torch.as_tensor(np.asarray(x_cell, np.float32)),
                        x_net=torch.as_tensor(np.asarray(x_net, np.float32)),
                        y_cell=torch.as_tensor(np.asarray(y_cell, np.float32)))
