"""DR-CircuitGNN (paper Fig. 1) and the homogeneous baselines of Table 2.

DR-CircuitGNN: per-type input projection -> N x HeteroConv -> per-cell
linear head (congestion regression in [0, 1]).  Where the plan path
applies (``core/hetero_mp.py::plan_applicable``) every layer runs its whole
message passing over the graph's :class:`RelationPlan`; otherwise
(``use_plan=False``, ``backend="bucket"``, k >= width on a node type, or
D-ReLU off) each layer runs the serial per-relation loop over the graph's
edge packings.  The inter-layer activation is D-ReLU in its dense form
whenever D-ReLU is on, as in the paper (the identity for a type whose k
is at least the width), and ReLU with it off (the dense-SpMM baseline).
``loss_fn`` and ``batched_loss_fn`` are the training objectives.

Baselines: GCN / GraphSAGE / GAT stacks on the homogenized graph
(:func:`homogenize`: one node space, every edge, self-loops,
mean-normalised) -- :class:`HomoGNN` and :func:`homo_forward`.  GCN and
SAGE aggregate through ``ops.spmm``; the two GAT kinds through
``ops.drspmm_learnable`` with the dense hidden state as a CBSR operand
(k = hidden, indices = iota) over fused edge-id arenas, which run the
fused kernels under either ``backend``.

Weights keep the reference's ``(in, out)`` layout, so ``from_jax_params``
copies a reference parameter tree over as it is.
"""

from __future__ import annotations

import math
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.drelu import drelu
from repro_torch.core.hetero_mp import (HeteroLayer, HeteroMPConfig,
                                        hetero_conv, plan_applicable)
from repro_torch.graphs.circuit import CircuitGraph, relation_plan_of
from repro_torch.graphs.ell import (BucketedELL, RelationPlan, ell_to_coo,
                                    pack_ell_pair, pack_fused_eid_pair)
from repro_torch.kernels import ops
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
        h = (graph.x_cell @ self.in_cell, graph.x_net @ self.in_net)
        # the serial path reads the graph's edge packings: no plan is
        # built or read
        over = _device_plan(graph, dev, cfg.dense_threshold) \
            if plan_applicable(cfg, self.hidden) else graph
        if cfg.use_drelu:
            act = lambda hc, hn: (drelu(hc, cfg.k_cell), drelu(hn, cfg.k_net))
        else:                   # the dense baseline
            act = lambda hc, hn: (torch.relu(hc), torch.relu(hn))

        def body(layer, state, over):
            return act(*hetero_conv(layer, over, *state, cfg))

        h_cell, _ = apply_stack(self.layers, h, body, spec, over)
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


# ---------------------------------------------------------------------------
# Homogeneous baselines (GCN / SAGE / GAT) on the homogenized graph
# ---------------------------------------------------------------------------

HOMO_KINDS = ("gcn", "sage", "gat", "gat_edge")


def homogenize(graph: CircuitGraph):
    """Merge node spaces: [cells; nets], every edge of every type plus a
    self-loop per node, mean-normalised (1/in-degree).  Features are
    zero-padded to a common width.  Returns ``(adj, adj_t, x, y, n_cell)``
    with the packings on the host and ``x``/``y`` on the graph's device.

    Each relation's edges are taken in row-major ``(dst, src)`` order with
    duplicates merged, as the reference's ``np.nonzero`` of the dense
    matrix gives them; the canonical edge order of the learnable kinds
    (and so the layout of ``gat_edge``'s logits) follows from it."""
    n_c, n_n = graph.n_cell, graph.n_net
    n = n_c + n_n
    shift = {"near": (0, 0), "pin": (n_c, 0), "pinned": (0, n_c)}
    dsts, srcs = [], []
    for et, es in graph.edges.items():
        d, s, _w = ell_to_coo(es.adj)
        key = np.unique(d * es.adj.n_src + s)
        dsts.append(key // es.adj.n_src + shift[et][0])
        srcs.append(key % es.adj.n_src + shift[et][1])
    loop = np.arange(n)
    dst = np.concatenate(dsts + [loop])
    src = np.concatenate(srcs + [loop])
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    w = 1.0 / np.maximum(deg[dst], 1.0)
    adj, adj_t = pack_ell_pair(dst, src, w, n, n)
    f = max(graph.x_cell.shape[1], graph.x_net.shape[1])
    x = torch.cat([F.pad(graph.x_cell, (0, f - graph.x_cell.shape[1])),
                   F.pad(graph.x_net, (0, f - graph.x_net.shape[1]))])
    return adj, adj_t, x, graph.y_cell, n_c


# id-keyed memo with weakref guards: (id(adj), device) -> the edge-id
# arenas and canonical edge tables on that device
_EDGE_PACK_CACHE: Dict[tuple, tuple] = {}


def learnable_edge_packing(adj: BucketedELL, device="cuda"):
    """``(fwd_arena, bwd_arena, dst_canon, src_canon, w_canon, nnz)`` for
    ``adj``'s edge set, with every table on ``device`` (a card unless
    ``device="cpu"`` is asked for).

    The edge-id arenas feed :func:`repro_torch.kernels.ops.drspmm_learnable`;
    ``dst_canon``/``src_canon`` (nnz,) are the canonical (dst-stable-
    sorted) edge endpoints and ``w_canon`` ``adj``'s fixed weights in that
    order.  A canonical per-edge vector (nnz,) aligns with all of them."""
    device = resolve_device(device)
    key = (id(adj), str(device))
    hit = _EDGE_PACK_CACHE.get(key)
    if hit is not None and hit[0]() is adj:
        return hit[1]
    dst, src, w = ell_to_coo(adj)
    order = np.argsort(dst, kind="stable")
    dst, src, w = dst[order], src[order], w[order]
    fwd, bwd, _order, nnz = pack_fused_eid_pair(dst, src, adj.n_dst,
                                                adj.n_src)
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(device)
    pack = (fwd.to(device), bwd.to(device), t(dst, np.int64),
            t(src, np.int64), t(w, np.float32), nnz)
    _EDGE_PACK_CACHE[key] = (
        weakref.ref(adj, lambda _: _EDGE_PACK_CACHE.pop(key, None)), pack)
    return pack


def _segment_max(v: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max (-inf for an empty segment), no gradient."""
    out = torch.full((n,), float("-inf"), dtype=v.dtype, device=v.device)
    return out.scatter_reduce(0, seg, v.detach(), "amax", include_self=False)


def _segment_sum(v: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,), dtype=v.dtype, device=v.device).index_add(
        0, seg, v)


def _iota_idx(h: torch.Tensor) -> torch.Tensor:
    """The dense ``h`` (N, D) as a CBSR operand's indices: 0..D-1 per row."""
    return torch.arange(h.shape[1], dtype=torch.int32, device=h.device
                        ).expand(h.shape).contiguous()


class HomoLayer(nn.Module):
    """One baseline layer's weights, named as the reference's tuple:
    ``w`` (gcn), ``w``/``w_self`` (sage), ``w``/``a`` (gat: the source and
    destination score vectors stacked, (2H,)), ``w``/``s`` (gat_edge: one
    free logit per canonical edge, zero at init)."""

    def __init__(self, kind: str, hidden: int, nnz: int, g, device):
        super().__init__()
        b = 1.0 / math.sqrt(hidden)
        self.w = _uniform((hidden, hidden), b, g, device)
        if kind == "sage":
            self.w_self = _uniform((hidden, hidden), b, g, device)
        elif kind == "gat":
            self.a = _uniform((2 * hidden,), b, g, device)
        elif kind == "gat_edge":
            self.s = nn.Parameter(torch.zeros(nnz, device=device))


class HomoGNN(nn.Module):
    """A homogeneous baseline stack (``kind`` in gcn | sage | gat |
    gat_edge): input projection, ``n_layers`` aggregation layers with ReLU,
    per-node linear head.  ``gat_edge`` needs the homogenized edge count
    ``nnz`` (``adj.nnz``).  Weights are drawn on the host from
    ``generator`` (seed 0 when omitted) and placed on ``device``."""

    def __init__(self, f_in: int, hidden: int = 64, n_layers: int = 3,
                 kind: str = "gcn", nnz: int = 0, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in HOMO_KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of "
                             f"{HOMO_KINDS}")
        if kind == "gat_edge" and nnz <= 0:
            raise ValueError("gat_edge needs the homogenized edge count nnz")
        dev = resolve_device(device)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.kind, self.hidden = kind, hidden
        self.layers = nn.ModuleList(HomoLayer(kind, hidden, nnz, g, dev)
                                    for _ in range(n_layers))
        self.w_in = _uniform((f_in, hidden), 1.0 / math.sqrt(f_in), g, dev)
        self.head_w = _uniform((hidden, 1), 1.0 / math.sqrt(hidden), g, dev)
        self.head_b = nn.Parameter(torch.zeros(1, device=dev))

    @property
    def device(self) -> torch.device:
        return self.w_in.device

    def forward(self, adj, adj_t, x, n_cell: int,
                spec: Optional[BackboneSpec] = None, *,
                backend: str = "fused") -> torch.Tensor:
        return homo_forward(self, adj, adj_t, x, n_cell, spec,
                            backend=backend)

    @classmethod
    def from_jax_params(cls, p, kind: str, *, device="cuda") -> "HomoGNN":
        """A model holding the reference's ``HomoParams`` ``p`` of ``kind``
        (leaves convert with ``np.asarray``)."""
        f_in, hidden = np.shape(p.w_in)
        nnz = int(np.shape(p.w_layers[0][1])[0]) if kind == "gat_edge" else 0
        model = cls(f_in, hidden, len(p.w_layers), kind, nnz, device=device)
        t = lambda a: torch.from_numpy(np.array(a, np.float32))
        state = {"w_in": t(p.w_in), "head_w": t(p.head_w),
                 "head_b": t(p.head_b)}
        for i, lw in enumerate(p.w_layers):
            names = [n for n, _ in model.layers[i].named_parameters()]
            leaves = (lw,) if kind == "gcn" else tuple(lw)
            for n, leaf in zip(names, leaves):
                state[f"layers.{i}.{n}"] = t(leaf)
        model.load_state_dict(state)
        return model


def _homo_body(kind: str, adj, adj_t, backend: str):
    """One baseline layer (ReLU included) over the host packings
    ``adj``/``adj_t``; their device tables are memoised."""
    def body(layer, state, _const):
        (h,) = state
        if kind == "gcn":
            return (torch.relu(ops.spmm(adj, adj_t, h, backend=backend)
                               @ layer.w),)
        if kind == "sage":
            agg = ops.spmm(adj, adj_t, h, backend=backend)
            return (torch.relu(agg @ layer.w + h @ layer.w_self),)
        fwd_e, bwd_e, dst_c, src_c, w_c, nnz = \
            learnable_edge_packing(adj, h.device)
        n = adj.n_dst
        hw = h @ layer.w
        if kind == "gat":
            # single-head GAT: source-score attention plus an explicit
            # self term, each destination's max incoming logit subtracted
            # before exp (a shift that cancels in num / den); adj's mean
            # weights ride in the attention
            hd = hw.shape[1]
            lr_src = F.leaky_relu(hw @ layer.a[:hd])
            lr_self = F.leaky_relu(hw @ layer.a[:hd] + hw @ layer.a[hd:])
            e_log = lr_src[src_c]
            m = torch.maximum(_segment_max(e_log, dst_c, n),
                              lr_self.detach())
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            att = w_c * torch.exp(e_log - m[dst_c])
            s_self = torch.exp(lr_self - m)
            num = ops.drspmm_learnable(fwd_e, bwd_e, nnz, att, hw,
                                       _iota_idx(hw), hd, backend=backend)
            num = num + s_self[:, None] * hw
            den = _segment_sum(att, dst_c, n) + s_self
        else:
            # gat_edge: a free logit per edge, softmax over each
            # destination's in-edges (self-loops included)
            logit = F.leaky_relu(layer.s)
            m = _segment_max(logit, dst_c, n)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            att = torch.exp(logit - m[dst_c])
            num = ops.drspmm_learnable(fwd_e, bwd_e, nnz, att, hw,
                                       _iota_idx(hw), hw.shape[1],
                                       backend=backend)
            den = _segment_sum(att, dst_c, n)
        return (torch.relu(num / torch.clamp(den, min=1e-6)[:, None]),)
    return body


def homo_forward(model: HomoGNN, adj, adj_t, x: torch.Tensor, n_cell: int,
                 spec: Optional[BackboneSpec] = None, *,
                 backend: str = "fused") -> torch.Tensor:
    """Per-cell prediction (n_cell,) of a baseline stack on the
    homogenized graph ``(adj, adj_t, x)`` (:func:`homogenize`); ``x`` must
    live on the model's device.  ``backend`` picks the aggregation's
    executor family (``kernels/ops.py``)."""
    if x.device != model.device:
        raise ValueError(f"features on {x.device}, model on {model.device}")
    ops.check_backend(backend)
    if spec is None:
        spec = spec_for(model.layers, model.hidden)
    (h,) = apply_stack(model.layers, (x @ model.w_in,),
                       _homo_body(model.kind, adj, adj_t, backend), spec)
    return torch.sigmoid(h @ model.head_w + model.head_b)[:n_cell, 0]
