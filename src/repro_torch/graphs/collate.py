"""Block-diagonal collation: N CircuitGraphs -> one CircuitGraph per batch.

Member graphs share one node space per node type::

    cell ids of member i live in [cell_off_i, cell_off_i + n_cell_i)
    net  ids of member i live in [net_off_i,  net_off_i  + n_net_i)

Edges never cross members, so the batched forward is the direct sum of the
members' forwards (up to fp32 summation order).  Member edges are recovered
from their ELL packings, offset, and packed once per direction.  With
``fused=True`` (the default) every edge type's two directions are fused
arenas and the batch gets one :class:`RelationPlan`, so ``backend="bucket"``
and ``use_plan=False`` run the fused kernels over a batch, as in the
reference.

**Shape quantization.**  With ``quantize=True`` (the default) member node
slabs are padded up a geometric grid and every arena's chunk and row counts
are padded too (:func:`~repro_torch.graphs.ell.pad_fused_arena`), so the
batches of one shape bucket share a :func:`graph_signature`.  The reference
compiles once per signature; the serve engine captures one CUDA graph per
signature (``serve/circuit_engine.py``).  A :class:`BucketLayout` pins each
bucket's chunk widths and relation tiers to its first batch and floors its
chunk counts at the bucket's running maximum, so the signatures of a bucket
converge.  Padding is inert: padded node rows carry zero features and no
edges, padded chunks zero weights in rows that no gather reads.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graphs.circuit import (CircuitGraph, EDGE_SCHEMA, EDGE_TYPES,
                                        EdgeSet)
from repro_torch.graphs.ell import (DEFAULT_BOUNDS, DENSE_TIER_AREA,
                                    DENSE_TIER_NNZ, FusedELL, RelationPlan,
                                    _round_up, _to_tensor,
                                    build_relation_plan, ell_to_coo,
                                    fuse_bucketed, pack_ell, pack_ell_pair,
                                    pack_fused_eid_pair, pad_fused_arena,
                                    arena_stats)
from repro_torch.obs.metrics import DEFAULT_REGISTRY as _METRICS

# Bucket-grid resolutions (mantissa bits of the geometric grid): node slabs
# pay padding in features and gathers, so they get the finer grid; arena
# chunk counts pay only zero-weight chunks, which the walks skip.
NODE_GRID_BITS = 2     # grid {m·2^e : m ∈ [4, 8)}: at most ~25 % padding
ARENA_GRID_BITS = 1    # grid {m·2^e : m ∈ [2, 4)}: at most ~50 % padding
# Chunk-count headroom when a bucket's layout is first recorded: later
# batches within this factor of the first keep its signature.
ARENA_HEADROOM = 1.15


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


@dataclasses.dataclass
class BucketLayout:
    """The arena layout of one shape bucket.  Its first batch pins the
    chunk width of every edge-type direction and of the plan, and each
    relation's tier; chunk counts (and the learnable-edge nnz) only grow,
    to grid points, so the signatures of a bucket converge."""

    chunk: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)        # (etype, "fwd"|"bwd") -> Ec
    min_chunks: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)        # (etype, "fwd"|"bwd") -> padded C
    plan_chunk: Dict[str, int] = dataclasses.field(
        default_factory=dict)        # "fwd"|"bwd" -> Ec
    plan_min_chunks: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)        # (etype, "fwd"|"bwd") -> padded C
    min_nnz: Dict[str, int] = dataclasses.field(
        default_factory=dict)        # etype -> quantized edge-id nnz
    # a tier flip changes the plan's dense-table shapes, so the first
    # batch's tiers hold for the bucket
    plan_tier: Dict[str, str] = dataclasses.field(
        default_factory=dict)        # etype -> "dense"|"arena"


class LayoutTable:
    """LRU table of per-shape-bucket :class:`BucketLayout` records.

    ``get(key)`` creates or touches a bucket; past ``max_live`` buckets the
    least recently used one is evicted and ``on_evict(key, layout)`` fires,
    so that the owner can drop what it derived for the bucket (the serve
    engine's captured graphs).  A bucket that returns starts from a fresh
    layout.  ``max_live=None`` never evicts.  Callers serialise access.

    ``metrics`` (a :class:`~repro_torch.obs.metrics.MetricsRegistry`)
    counts ``layout.creates`` and ``layout.evictions``; ``recorder`` marks
    each create and eviction as an instant on the ``layout`` trace track.
    Neither is touched when unset."""

    def __init__(self, max_live: Optional[int] = None,
                 on_evict: Optional[Callable[[tuple, BucketLayout],
                                             None]] = None,
                 metrics=None, recorder=None):
        if max_live is not None and max_live < 1:
            raise ValueError(f"max_live must be >= 1, got {max_live}")
        self.max_live = max_live
        self.on_evict = on_evict
        self.evictions = 0
        self.metrics = metrics
        self.recorder = recorder
        self._table: "OrderedDict[tuple, BucketLayout]" = OrderedDict()

    def get(self, key: tuple) -> BucketLayout:
        """Layout for ``key`` (created on first use), made the most
        recently used; may evict the least recently used bucket (never
        ``key``)."""
        layout = self._table.get(key)
        if layout is None:
            layout = self._table[key] = BucketLayout()
            if self.metrics is not None:
                self.metrics.inc("layout.creates")
            if self.recorder is not None and self.recorder.enabled:
                self.recorder.instant("layout", "bucket_create",
                                      bucket=str(key))
        self._table.move_to_end(key)
        while self.max_live is not None and len(self._table) > self.max_live:
            k, v = self._table.popitem(last=False)
            self.evictions += 1
            if self.metrics is not None:
                self.metrics.inc("layout.evictions")
            if self.recorder is not None and self.recorder.enabled:
                self.recorder.instant("layout", "bucket_evict",
                                      bucket=str(k))
            if self.on_evict is not None:
                self.on_evict(k, v)
        return layout

    def __len__(self) -> int:
        return len(self._table)

    def __contains__(self, key: tuple) -> bool:
        return key in self._table

    def keys(self):
        return self._table.keys()


def _arena_row_cap(n_dst: int, bounds: Sequence[int], row_block: int) -> int:
    """Upper bound on a fused arena's row count that depends only on the
    padded node count: one arena row per non-empty destination row, each
    of the ``len(bounds) + 1`` degree buckets rounded up to the row block,
    plus the sentinel block."""
    return _round_up(max(n_dst, 1), row_block) + (len(bounds) + 2) * row_block


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
    for the first ``n_real`` members and 0 on filler members and padding,
    so ``Σ cell_weight·(pred − y)²`` is the mean of the real members' MSE
    losses.

    With ``with_eids`` collation, ``edge_nnz`` is each edge type's
    quantized edge count (the length of the batch's weight vector),
    ``edge_nnz_exact`` its real count and ``edge_eid_offsets`` where each
    member's edges start in the batch's canonical edge order."""

    graph: CircuitGraph
    members: Tuple[MemberSlice, ...]
    cell_weight: torch.Tensor       # (n_cell,) fp32, on the batch's device
    n_real: int                     # members that carry real graphs
    edge_nnz: Dict[str, int] = dataclasses.field(default_factory=dict)
    edge_nnz_exact: Dict[str, int] = dataclasses.field(default_factory=dict)
    edge_eid_offsets: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    @property
    def plan(self) -> Optional[RelationPlan]:
        return self.graph.plan

    def concat_edge_weights(self, etype: str,
                            member_ws: Sequence) -> torch.Tensor:
        """The members' canonical weight vectors (one a member, filler
        included) -> the batch's canonical vector, zero-padded to the
        quantized ``edge_nnz``.  Member i's edges occupy ``[
        edge_eid_offsets[etype][i], + nnz_i)``: member node blocks are
        disjoint and increasing, so the batch's destination-stable order
        concatenates the members' orders.  Padding ids are never gathered,
        so their weights are inert and get zero gradient."""
        if len(member_ws) != len(self.members):
            raise ValueError(f"{len(member_ws)} weight vectors for "
                             f"{len(self.members)} members")
        w = torch.cat([torch.as_tensor(wi) for wi in member_ws])
        exact = self.edge_nnz_exact.get(etype, self.edge_nnz[etype])
        if w.shape[0] != exact:
            raise ValueError(f"{w.shape[0]} weights for {exact} {etype} "
                             f"edges")
        pad = self.edge_nnz[etype] - exact
        if pad:
            w = torch.cat([w, w.new_zeros(pad)])
        return w

    def split_cell(self, y_cell) -> List[torch.Tensor]:
        """Per-real-member views of a per-cell output of the batch."""
        return [y_cell[m.cell_off:m.cell_off + m.n_cell]
                for m in self.members[: self.n_real]]

    def split_net(self, y_net) -> List[torch.Tensor]:
        return [y_net[m.net_off:m.net_off + m.n_net]
                for m in self.members[: self.n_real]]

    @property
    def signature(self) -> tuple:
        return graph_signature(self.graph)


def _is_table(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _dtype_name(t) -> str:
    return t.dtype.name if isinstance(t, np.ndarray) \
        else str(t.dtype).rsplit(".", 1)[-1]


def graph_signature(graph: CircuitGraph) -> tuple:
    """Hashable signature of a graph: its static fields and those of its
    edge packings and plan (counts, chunk widths, ``nnz``, segments), plus
    every table's shape and dtype, never a table's values.  Two batches of
    equal signature run one captured CUDA graph in the serve engine, as
    they share one compiled executable in the reference."""
    def sig(x):
        if _is_table(x):
            return (tuple(x.shape), _dtype_name(x))
        if dataclasses.is_dataclass(x):
            return (type(x).__name__,) + tuple(
                (f.name, sig(getattr(x, f.name)))
                for f in dataclasses.fields(x))
        if isinstance(x, dict):
            return tuple((k, sig(v)) for k, v in sorted(x.items()))
        if isinstance(x, (tuple, list)):
            return tuple(sig(v) for v in x)
        return x
    return sig(graph)


def map_graph_tensors(graph, fn):
    """``graph`` rebuilt with ``fn(t)`` in place of every tensor ``t`` (its
    edge packings' and plan's included), visited in a fixed order."""
    if isinstance(graph, torch.Tensor):
        return fn(graph)
    if dataclasses.is_dataclass(graph):
        return dataclasses.replace(graph, **{
            f.name: map_graph_tensors(getattr(graph, f.name), fn)
            for f in dataclasses.fields(graph)})
    if isinstance(graph, dict):
        return {k: map_graph_tensors(v, fn) for k, v in graph.items()}
    if isinstance(graph, (tuple, list)):
        return type(graph)(map_graph_tensors(v, fn) for v in graph)
    return graph


def graph_tensors(graph) -> List[torch.Tensor]:
    """Every tensor of ``graph``, in :func:`map_graph_tensors`' order."""
    out: List[torch.Tensor] = []

    def keep(t):
        out.append(t)
        return t
    map_graph_tensors(graph, keep)
    return out


def _chunk_for(chunk, etype: str) -> Optional[int]:
    return chunk.get(etype) if isinstance(chunk, dict) else chunk


def collate_graphs(graphs: Sequence[CircuitGraph], *,
                   fused: bool = True,
                   quantize: bool = True,
                   node_bits: int = NODE_GRID_BITS,
                   arena_bits: int = ARENA_GRID_BITS,
                   chunk: Union[None, int, Dict[str, int]] = None,
                   layout: Optional[BucketLayout] = None,
                   n_real: Optional[int] = None,
                   with_eids: bool = False,
                   with_plan: Optional[bool] = None,
                   bounds: Sequence[int] = DEFAULT_BOUNDS,
                   with_edges: bool = True,
                   device="cuda") -> CollatedBatch:
    """Merge member graphs into one block-diagonal :class:`CircuitGraph` on
    ``device``.

    * ``fused``: pack each edge-type direction as a fused arena (the serve
      and train path); ``False`` packs the exact bucketed pairs.
    * ``quantize``: pad member node slabs (``node_bits``) and, with
      ``fused``, arena chunk and row counts (``arena_bits``) up the bucket
      grid; ``False`` gives the exact-size collation.
    * ``chunk``: pin the arenas' chunk width (an int or a per-edge-type
      dict); ``None`` picks it per packing.
    * ``layout``: the shape bucket's :class:`BucketLayout`, which pins chunk
      widths and tiers to the bucket's first batch and floors chunk counts
      at its running maximum.
    * ``n_real``: members that carry real requests (all by default); the
      trailing members are filler with loss weight 0.
    * ``with_eids``: also give every fused direction its batch-canonical
      edge ids (member ids offset by the edges of the members before it),
      so the batch can carry learnable edge weights
      (:meth:`CollatedBatch.concat_edge_weights`); with ``quantize`` the
      per-edge-type nnz is rounded up the arena grid.  Needs ``fused``.
    * ``with_plan``: attach the batch's :class:`RelationPlan` (default:
      ``fused``), its segments padded under the same layout.  Needs
      ``fused``.
    * ``with_edges``: pack the per-edge-type arenas (the serial path's
      operands).  ``False`` leaves ``graph.edges`` empty for a consumer
      that reads only the plan (the serve engine's plan path): no arena
      is packed, copied or counted in the signature.  Needs ``with_plan``
      and no ``with_eids``.
    """
    device = resolve_device(device)
    if not graphs:
        raise ValueError("collate_graphs needs at least one member")
    n_real = len(graphs) if n_real is None else int(n_real)
    if not 0 < n_real <= len(graphs):
        raise ValueError(f"n_real={n_real} outside 1..{len(graphs)}")
    if with_plan is None:
        with_plan = fused
    if (with_eids or with_plan) and not fused:
        raise ValueError("with_eids and with_plan need fused collation")
    if not with_edges and (with_eids or not with_plan):
        raise ValueError("with_edges=False needs with_plan and no with_eids")
    f_cell = graphs[0].x_cell.shape[1]
    f_net = graphs[0].x_net.shape[1]
    if not all(g.x_cell.shape[1] == f_cell and g.x_net.shape[1] == f_net
               for g in graphs):
        raise ValueError("members must share feature widths")

    # member slabs: per-member padding keeps offsets a function of the
    # members' quantized sizes alone
    members, cell_off, net_off = [], 0, 0
    for g in graphs:
        members.append(MemberSlice(cell_off=cell_off, n_cell=g.n_cell,
                                   net_off=net_off, n_net=g.n_net))
        cell_off += quantize_up(g.n_cell, node_bits) if quantize else g.n_cell
        net_off += quantize_up(g.n_net, node_bits) if quantize else g.n_net
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
    coo_of: Dict[str, tuple] = {}
    bucketed_of: Dict[str, tuple] = {}
    edge_nnz: Dict[str, int] = {}
    edge_nnz_exact: Dict[str, int] = {}
    edge_eid_offsets: Dict[str, Tuple[int, ...]] = {}
    for et in EDGE_TYPES:
        s_t, d_t = EDGE_SCHEMA[et]
        ds, ss, ws, m_nnz = [], [], [], []
        for i, g in enumerate(graphs):
            dst, src, w = ell_to_coo(g.edges[et].adj)
            ds.append(dst + off_of[d_t][i])
            ss.append(src + off_of[s_t][i])
            ws.append(w)
            m_nnz.append(int(dst.shape[0]))
        dst, src, w = np.concatenate(ds), np.concatenate(ss), np.concatenate(ws)
        n_dst, n_src = sizes[d_t], sizes[s_t]
        coo_of[et] = (dst, src, w)
        if not fused:
            edges[et] = EdgeSet(*pack_ell_pair(dst, src, w, n_dst, n_src,
                                               bounds))
            continue
        # one degree-bucketed pack per direction, shared by the edge-type
        # arenas and the relation plan
        bucketed = {"fwd": pack_ell(dst, src, w, n_dst, n_src, bounds),
                    "bwd": pack_ell(src, dst, w, n_src, n_dst, bounds)}
        bucketed_of[et] = (bucketed["fwd"], bucketed["bwd"])
        if not with_edges:
            continue
        packed = {}
        for dname in ("fwd", "bwd"):
            ck = layout.chunk.get((et, dname)) if layout else None
            if ck is None:
                ck = _chunk_for(chunk, et)
            a = fuse_bucketed(bucketed[dname], chunk=ck)
            if layout is not None:
                layout.chunk.setdefault((et, dname), a.chunk)
            # pack-time arena gauges, from the arena's static fields and
            # the bucket shapes (no table scan), one series an edge-type
            # direction
            st = arena_stats(a, bucketed[dname])
            for gname in ("fill_ratio", "padded_slots", "slots", "chunk",
                          "slot_saving"):
                _METRICS.set(f"arena.{gname}", st[gname], etype=et,
                             dir=dname)
            if quantize:
                a = _quantize_arena(a, arena_bits, bounds, layout,
                                    (et, dname))
            packed[dname] = a
        if with_eids:
            # the eid packing sorts and chunks exactly like the weight
            # packing (member weights are all non-zero), so its table
            # drops onto the weight arena
            efwd, ebwd, _order, et_nnz = pack_fused_eid_pair(
                dst, src, n_dst, n_src, bounds,
                chunk=(packed["fwd"].chunk, packed["bwd"].chunk))
            for dname, ea in (("fwd", efwd), ("bwd", ebwd)):
                a = packed[dname]
                if quantize:
                    ea = pad_fused_arena(ea, a.n_chunks, a.n_arena_rows)
                if ea.nbr.shape != a.nbr.shape:
                    raise AssertionError(f"{et} {dname}: edge-id arena "
                                         f"{ea.nbr.shape} vs {a.nbr.shape}")
                packed[dname] = dataclasses.replace(
                    a, eid=np.asarray(ea.eid))
            nnz_pad = et_nnz
            if quantize:
                nnz_pad = quantize_up(et_nnz, arena_bits, minimum=8)
                if layout is not None:
                    floor = layout.min_nnz.get(et)
                    if floor is None:      # first batch: with headroom
                        floor = quantize_up(
                            int(np.ceil(et_nnz * ARENA_HEADROOM)),
                            arena_bits, minimum=8)
                    nnz_pad = max(nnz_pad, floor)
                    layout.min_nnz[et] = nnz_pad
            edge_nnz[et] = nnz_pad
            edge_nnz_exact[et] = et_nnz
            edge_eid_offsets[et] = tuple(
                int(o) for o in np.cumsum([0] + m_nnz[:-1]))
        edges[et] = EdgeSet(adj=packed["fwd"], adj_t=packed["bwd"])

    plan = _build_batch_plan(coo_of, bucketed_of, sizes, quantize,
                             arena_bits, layout, bounds) if with_plan \
        else None
    graph = CircuitGraph(n_cell=cell_off, n_net=net_off, edges=edges,
                         x_cell=torch.from_numpy(x_cell),
                         x_net=torch.from_numpy(x_net),
                         y_cell=torch.from_numpy(y_cell), plan=plan)
    return CollatedBatch(graph=graph.to(device), members=tuple(members),
                         cell_weight=_to_tensor(w_cell, device),
                         n_real=n_real, edge_nnz=edge_nnz,
                         edge_nnz_exact=edge_nnz_exact,
                         edge_eid_offsets=edge_eid_offsets)


def _build_batch_plan(coo_of: Dict[str, tuple],
                      bucketed_of: Dict[str, tuple],
                      sizes: Dict[str, int], quantize: bool,
                      arena_bits: int, layout: Optional[BucketLayout],
                      bounds: Sequence[int]) -> RelationPlan:
    """The batch's :class:`RelationPlan`, kept signature-stable in its
    bucket: the super-arena's chunk width per direction is pinned to the
    bucket's first batch, each relation segment's chunk count padded up the
    arena grid and floored at the bucket's running maximum, its rows to
    the cap, and each relation's tier pinned to the first batch's."""
    relations = [(et,) + EDGE_SCHEMA[et] + coo_of[et]
                 for et in EDGE_TYPES if et in coo_of]
    chunk = None
    if layout is not None and layout.plan_chunk:
        chunk = (layout.plan_chunk.get("fwd"), layout.plan_chunk.get("bwd"))

    pad = None
    if quantize:
        def pad(et, dname, arena):
            r_cap = _arena_row_cap(arena.n_dst, bounds, arena.row_block)
            c_pad = quantize_up(arena.n_chunks, arena_bits, minimum=1)
            if layout is not None:
                floor = layout.plan_min_chunks.get((et, dname))
                if floor is None:       # first batch: with headroom
                    floor = quantize_up(
                        int(np.ceil(arena.n_chunks * ARENA_HEADROOM)),
                        arena_bits, minimum=1)
                c_pad = max(c_pad, floor)
                layout.plan_min_chunks[(et, dname)] = c_pad
            return c_pad, r_cap

    # tiers from the exact merged nnz (padded arenas reset nnz) against the
    # padded type sizes, pinned to the bucket's first batch
    tiers = None
    if layout is not None:
        for et, st, dt, dst, _src, _w in relations:
            area = int(sizes[dt]) * int(sizes[st])
            t = ("dense" if (int(dst.shape[0]) <= DENSE_TIER_NNZ
                             and area <= DENSE_TIER_AREA) else "arena")
            layout.plan_tier.setdefault(et, t)
        tiers = dict(layout.plan_tier)

    plan = build_relation_plan(relations, sizes, bounds=bounds, chunk=chunk,
                               pad=pad, packed=bucketed_of or None,
                               tiers=tiers)
    if layout is not None:
        layout.plan_chunk.setdefault("fwd", plan.fwd.chunk)
        layout.plan_chunk.setdefault("bwd", plan.bwd.chunk)
    # the super-arenas' gauges: real slots are the arena-tier relations'
    # edge counts (a padded arena's ``nnz`` is -1, and a scan of the arena
    # a batch would not be cheap); dense-tier relations take no slot
    arena_ets = {s.etype for s in plan.arena_segments}
    real = sum(int(r[3].shape[0]) for r in relations if r[0] in arena_ets)
    for dname, arena in (("fwd", plan.fwd), ("bwd", plan.bwd)):
        c, br, ec = (int(n) for n in arena.nbr.shape)
        slots = c * br * ec
        _METRICS.set("arena.slots", slots, etype="__plan__", dir=dname)
        _METRICS.set("arena.padded_slots", slots - real, etype="__plan__",
                     dir=dname)
        _METRICS.set("arena.fill_ratio", real / slots if slots else 0.0,
                     etype="__plan__", dir=dname)
        _METRICS.set("arena.chunk", ec, etype="__plan__", dir=dname)
    return plan


def _quantize_arena(f: FusedELL, arena_bits: int, bounds: Sequence[int],
                    layout: Optional[BucketLayout],
                    key: Tuple[str, str]) -> FusedELL:
    """Pad an arena to shape-bucket-stable dims: rows to the cap (a
    function of the padded node count alone), chunks up the grid, floored
    at the bucket's running maximum when a layout tracks it."""
    r_cap = _arena_row_cap(f.n_dst, bounds, f.row_block)
    if f.n_arena_rows > r_cap:
        raise AssertionError(f"arena rows {f.n_arena_rows} above the cap "
                             f"{r_cap}")
    c_pad = quantize_up(f.n_chunks, arena_bits, minimum=1)
    if layout is not None:
        floor = layout.min_chunks.get(key)
        if floor is None:       # first batch of the bucket: with headroom
            floor = quantize_up(int(np.ceil(f.n_chunks * ARENA_HEADROOM)),
                                arena_bits, minimum=1)
        c_pad = max(c_pad, floor)
        layout.min_chunks[key] = c_pad
    return pad_fused_arena(f, c_pad, r_cap)
