"""The differentiable ops over the kernels of ``kernels/drspmm.py``.

* ``drspmm_multi``: one hetero layer's whole message passing over a
  :class:`~repro_torch.graphs.ell.RelationPlan`, forward and sampled
  backward (the D-ReLU path);
* ``drspmm``: one relation's DR-SpMM with the sampled backward (the serial
  per-relation D-ReLU path);
* ``spmm``: one relation's SpMM with a dense operand and the full backward
  over the transposed packing (the D-ReLU-off DR-CircuitGNN, a node type
  with k >= width, and the GCN / SAGE baselines);
* ``drspmm_learnable``: DR-SpMM whose edge weights are a differentiable
  canonical vector (the GAT baselines).

The single-relation ops take a ``backend``, the reference's executor
family without its device half:

* ``"fused"`` (the reference's ``pallas_fused`` / ``xla_fused``): one
  launch per direction over the relation's fused arena (kernels 1/4, 6,
  7-9); ``drspmm`` sends a relation at or below the dense-tier crossover to
  the dense-tier kernels 2/5 instead;
* ``"bucket"`` (the reference's ``pallas`` / ``xla``): one launch per
  degree bucket over the :class:`~repro_torch.graphs.ell.BucketedELL`
  slabs (kernels 10-12), each bucket's rows added at ``rows``.

A pre-fused adjacency (:class:`~repro_torch.graphs.ell.FusedELL`) has no
bucket slabs, so it upgrades ``"bucket"`` to ``"fused"``, as in the
reference (:func:`_effective_backend`).

``drspmm_multi``:

The plan's arena-tier relations run as one launch of the arena kernel over
the super-arena and its dense-tier relations as at most one launch of the
dense-tier kernel; the two outputs are reassembled into the relation-concat
order and split per relation.  The backward (the sampled SSpMM of Alg. 2)
is the same shape: one launch of the arena backward kernel over the
transposed super-arena plus at most one dense-tier backward launch, summed
per source node type.  A CUDA operand launches the kernels, a CPU operand
runs their plain versions (``kernels/drspmm.py``).  ``dense=True`` runs the
fully dense oracle instead, for tests; its backward is autograd through the
dense product.  ``drspmm_multi_sharded`` runs the same contract over a plan
partitioned over devices (``sharding/plan_shard.py``): kernel 1 and kernel
4 once per shard on its local arenas, with the halo exchange around them.

Every op call counts one ``ops.dispatch{family, kind}`` in
:data:`~repro_torch.obs.metrics.DEFAULT_REGISTRY`: ``family`` is the route,
the operands' device type and the executor family (``cuda_fused``,
``cpu_bucket``, ...), ``kind`` the executor (``multi_fwd``,
``multi_dense_fwd``, ``multi_bwd``, ``multi_dense_bwd``, ``shard_fwd``,
``shard_bwd``, ``fwd``, ``dense_fwd``, ``bwd``, ``dense_bwd``, ``spmm``,
``learnable_fwd``, ``learnable_bwd``, ``learnable_dw``).  The reference counts while JAX
traces; the port counts each Python-level call, so eager runs and CUDA-graph
captures count and a replay of a captured graph adds nothing.
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.graphs.ell import (DENSE_TIER_AREA, DENSE_TIER_NNZ,
                                    BucketedELL, ELLBucket, FusedELL,
                                    RelationPlan, fuse_bucketed)
from repro_torch.kernels import drspmm as _k
from repro_torch.kernels import learnable as _learn
from repro_torch.obs.metrics import DEFAULT_REGISTRY as _METRICS
from repro_torch.sharding.plan_shard import ShardedRelationPlan

BACKENDS = ("fused", "bucket")


def _record_dispatch(t: torch.Tensor, route: str, kind: str) -> None:
    """Count one op call on ``t``'s device under ``route``."""
    _METRICS.inc("ops.dispatch", family=f"{t.device.type}_{route}",
                 kind=kind)


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")


def _effective_backend(adj, backend: str) -> str:
    """The executor family that runs ``adj``: a pre-fused arena has no
    bucket slabs to loop over, so it upgrades ``"bucket"`` to ``"fused"``
    (the reference's rule, without its traced-argument downgrade: the
    port runs eagerly, so fusing is always possible)."""
    check_backend(backend)
    return "fused" if isinstance(adj, FusedELL) else backend


def _multi_concat(plan: RelationPlan, vals, idxs):
    """Stack per-type CBSR operands into the plan's type-concat slab,
    padding k up to the group max with ``(value 0, column 0)`` entries --
    zero-value duplicates that contribute nothing."""
    kmax = max(int(i.shape[1]) for i in idxs)
    xv = torch.cat([F.pad(v.float(), (0, kmax - v.shape[1])) for v in vals])
    xi = torch.cat([F.pad(i.to(torch.int32), (0, kmax - i.shape[1]))
                    for i in idxs])
    return xv.contiguous(), xi.contiguous()


def _split_out(plan: RelationPlan, y_cat) -> Tuple[torch.Tensor, ...]:
    """Relation-concat output -> per-relation views (segment order)."""
    return tuple(y_cat[s.out_off:s.out_off + s.n_dst] for s in plan.segments)


def _hybrid_fwd(plan: RelationPlan, xv, xi, dim: int) -> torch.Tensor:
    """Tiered forward: at most one arena launch plus one dense-tier launch,
    reassembled into the full relation-concat output."""
    ya = yd = None
    if plan.has_arena:
        _record_dispatch(xv, "fused", "multi_fwd")
        ya = _k.drspmm_fwd_arena(plan.fwd, xv, xi, dim)
        ya = ya.index_select(0, plan.fwd.gather)
    if plan.has_dense:
        _record_dispatch(xv, "fused", "multi_dense_fwd")
        yd = _k.drspmm_dense_tier_fwd(plan.dense_fwd, xv, xi, dim)
    if yd is None:
        return ya
    if ya is None:
        return yd
    return torch.cat(
        [ya[s.arena_out_off:s.arena_out_off + s.n_dst] if s.tier == "arena"
         else yd[s.dense_off:s.dense_off + s.n_dst]
         for s in plan.segments])


def _hybrid_bwd(plan: RelationPlan, gy_cat, xi):
    """Tiered backward -> (arena relation-concat dV | None, dense-tier
    type-concat dV | None).  The transposed super-arena addresses the full
    output concat (its ``nbr`` are offset at pack time), so ``gy_cat``
    feeds it whole; the dense tier gets its segments' cotangent rows
    re-stacked in ``dense_fwd`` row order."""
    dx_cat = dv_dense = None
    if plan.has_arena:
        _record_dispatch(gy_cat, "fused", "multi_bwd")
        dv = _k.drspmm_bwd_arena(plan.bwd, plan.bwd_src_rows, gy_cat, xi)
        dx_cat = dv.index_select(0, plan.bwd.gather)
    if plan.has_dense:
        gy_dense = gy_cat if not plan.has_arena else torch.cat(
            [gy_cat[s.out_off:s.out_off + s.n_dst]
             for s in plan.dense_segments])
        _record_dispatch(gy_cat, "fused", "multi_dense_bwd")
        dv_dense = _k.drspmm_dense_tier_bwd(plan.dense_bwd, gy_dense, xi)
    return dx_cat, dv_dense


def _dx_cat_to_types(plan: RelationPlan, dx_cat, dv_dense, ks):
    """Arena relation-concat dV (+ dense-tier type-concat dV) -> per-type
    gradients.  Arena segments of one source type add up (cell feeds both
    ``near`` and ``pin``); the dense tier's type-concat dV already sums
    every dense relation per source row, so it adds once per consuming
    type.  The k padding of the type concat is sliced off per type."""
    outs = []
    ref = dx_cat if dx_cat is not None else dv_dense
    for ti, t in enumerate(plan.src_types):
        acc = None
        for s in plan.arena_segments:
            if s.src_type == t:
                part = dx_cat[s.src_out_off:s.src_out_off + s.n_src]
                acc = part if acc is None else acc + part
        if dv_dense is not None and any(s.src_type == t
                                        for s in plan.dense_segments):
            o = plan.src_off[ti]
            part = dv_dense[o:o + plan.src_sizes[ti]]
            acc = part if acc is None else acc + part
        if acc is None:
            acc = ref.new_zeros((plan.src_sizes[ti], ks[ti]))
        outs.append(acc[:, :ks[ti]])
    return outs


class _DRSpMMMulti(torch.autograd.Function):
    """Relation-concat Y of the plan; the backward returns one dV per
    source type.  Only the type-concat ``xi`` is saved: the kernels need
    no dense operand and no forward output."""

    @staticmethod
    def forward(ctx, plan, dim, idxs, *vals):
        xv, xi = _multi_concat(plan, vals, idxs)
        ctx.plan = plan
        ctx.ks = [int(i.shape[1]) for i in idxs]
        ctx.save_for_backward(xi)
        return _hybrid_fwd(plan, xv, xi, dim)

    @staticmethod
    def backward(ctx, gy_cat):
        (xi,) = ctx.saved_tensors
        dx_cat, dv_dense = _hybrid_bwd(ctx.plan, gy_cat.float().contiguous(),
                                       xi)
        dvs = _dx_cat_to_types(ctx.plan, dx_cat, dv_dense, ctx.ks)
        return (None, None, None, *dvs)


def _plan_dense_mat(plan: RelationPlan) -> torch.Tensor:
    """Full (n_out_total, n_src_total) block matrix across both tiers,
    built from the plan's device tables (the ``dense`` oracle)."""
    dev = plan.dense_fwd.device
    a = torch.zeros((plan.n_out_total, plan.n_src_total),
                    dtype=torch.float32, device=dev)
    if plan.has_arena:
        fa = _dense_of(plan.fwd, plan.fwd.w)
        for s in plan.arena_segments:
            a[s.out_off:s.out_off + s.n_dst] = \
                fa[s.arena_out_off:s.arena_out_off + s.n_dst]
    for s in plan.dense_segments:
        a[s.out_off:s.out_off + s.n_dst] = \
            plan.dense_fwd[s.dense_off:s.dense_off + s.n_dst]
    return a


def drspmm_multi(plan: RelationPlan,
                 cbsr: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 dim: int, *, dense: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Whole-direction-group DR-SpMM, differentiable in the CBSR values.

    ``plan`` holds tensors on the operands' device (``plan.to(device)``);
    ``cbsr`` maps each source node type to its CBSR pair ``(vals (n_t,
    k_t), idx (n_t, k_t))`` -- k may differ per type.  Returns ``{etype: y
    (n_dst_r, dim)}``; the values get gradients, the indices none."""
    vals = tuple(cbsr[t][0] for t in plan.src_types)
    idxs = tuple(cbsr[t][1] for t in plan.src_types)
    if dense:
        xv, xi = _multi_concat(plan, vals, idxs)
        y_cat = _plan_dense_mat(plan) @ _k._densify(xv, xi, dim)
    else:
        y_cat = _DRSpMMMulti.apply(plan, dim, idxs, *vals)
    return {s.etype: y for s, y in zip(plan.segments, _split_out(plan, y_cat))}


# ---------------------------------------------------------------------------
# drspmm_multi_sharded: the plan partitioned over devices
# ---------------------------------------------------------------------------

def _pad_rows(a: torch.Tensor, total: int) -> torch.Tensor:
    return F.pad(a, (0, 0, 0, total - a.shape[0]))


def _shard_slabs(splan: ShardedRelationPlan, x_cat: torch.Tensor):
    """Each shard's local source slab ``[own | halo]`` on its device: the
    type-concat ``x_cat`` padded to n·S rows, owner s's slab on its own
    device, and shard d's halo segment s gathered at the owner
    (``send[s][d]``) and copied over."""
    n, s_slab, devs = splan.n_shards, splan.src_slab, splan.devices
    x_pad = _pad_rows(x_cat, n * s_slab)
    own = [x_pad[s * s_slab:(s + 1) * s_slab].to(dv)
           for s, dv in enumerate(devs)]
    return [torch.cat([own[d]] + [own[s].index_select(0, splan.send[s][d])
                                  .to(devs[d]) for s in range(n)])
            for d in range(n)]


def _sharded_fwd(splan: ShardedRelationPlan, xv, xi,
                 dim: int) -> torch.Tensor:
    """Relation-concat Y: kernel 1 once per shard over its local forward
    arena and exchanged slab, each shard's output slab brought to the
    operands' device."""
    _record_dispatch(xv, "fused", "shard_fwd")
    ys = []
    for f, sv, si in zip(splan.fwd, _shard_slabs(splan, xv),
                         _shard_slabs(splan, xi)):
        ya = _k.drspmm_fwd_arena(f, sv, si, dim)
        ys.append(ya.index_select(0, f.gather).to(xv.device))
    return torch.cat(ys)[:splan.n_out_total]


def _sharded_bwd(splan: ShardedRelationPlan, gy_cat,
                 xi) -> torch.Tensor:
    """Type-concat dV (n_src_total, k), summed over the relations: kernel
    4 once per shard over its transposed local arena (its ``rows`` map the
    arena rows to the slab rows whose CBSR columns they sample), then the
    halo segment of each shard's dx slab goes back to its owner and is
    added at ``send``.  A padded halo slot adds the arena sentinel's exact
    zeros to the owner's row 0."""
    _record_dispatch(gy_cat, "fused", "shard_bwd")
    n, s_slab, t_slab, h = (splan.n_shards, splan.src_slab, splan.out_slab,
                            splan.halo_pad)
    devs = splan.devices
    gy_pad = _pad_rows(gy_cat, n * t_slab)
    dx = []
    for d, (ft, si) in enumerate(zip(splan.bwd, _shard_slabs(splan, xi))):
        gy_d = gy_pad[d * t_slab:(d + 1) * t_slab].to(devs[d]).contiguous()
        dv = _k.drspmm_bwd_arena(ft, ft.rows, gy_d, si)
        dx.append(dv.index_select(0, ft.gather))
    own = [dx[s][:s_slab] for s in range(n)]
    for d in range(n):
        for s in range(n):
            own[s].index_add_(0, splan.send[s][d],
                              dx[d][s_slab + s * h:s_slab + (s + 1) * h]
                              .to(devs[s]))
    return torch.cat([o.to(gy_cat.device) for o in own])[:splan.n_src_total]


class _DRSpMMMultiSharded(torch.autograd.Function):
    """:class:`_DRSpMMMulti` over a placed :class:`ShardedRelationPlan`:
    the backward's dV is already type-concat (each local transposed arena
    sums every relation of its source rows), so each type's gradient is a
    row slice of it with the k padding sliced off."""

    @staticmethod
    def forward(ctx, splan, dim, idxs, *vals):
        xv, xi = _multi_concat(splan, vals, idxs)
        ctx.splan = splan
        ctx.ks = [int(i.shape[1]) for i in idxs]
        ctx.save_for_backward(xi)
        return _sharded_fwd(splan, xv, xi, dim)

    @staticmethod
    def backward(ctx, gy_cat):
        (xi,) = ctx.saved_tensors
        sp = ctx.splan
        dx = _sharded_bwd(sp, gy_cat.float().contiguous(), xi)
        return (None, None, None,
                *(dx[o:o + n, :k] for o, n, k in zip(sp.src_off,
                                                     sp.src_sizes, ctx.ks)))


def drspmm_multi_sharded(splan: ShardedRelationPlan,
                         cbsr: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                         dim: int, *, backend: str = "fused"
                         ) -> Dict[str, torch.Tensor]:
    """:func:`drspmm_multi` over a plan partitioned by
    :func:`~repro_torch.sharding.plan_shard.shard_relation_plan` and placed
    with ``splan.to(devices)``: the same contract (``{etype: y}`` on the
    operands' device, gradients to every type's values), run as one
    exchange and one launch of kernel 1 per shard forward, one exchange,
    one launch of kernel 4 per shard and the reverse exchange backward.
    A sharded plan has only local arenas, so every ``backend`` runs this
    fused executor (the reference's rule)."""
    check_backend(backend)
    if splan.devices is None:
        raise ValueError("place the sharded plan on its devices first: "
                         "splan.to(device) or splan.to([devices])")
    vals = tuple(cbsr[t][0] for t in splan.src_types)
    idxs = tuple(cbsr[t][1] for t in splan.src_types)
    where = vals[0].device.type
    if any(dv.type != where for dv in splan.devices):
        # a card's operands would be copied to a CPU shard (or the other
        # way round) and run the kernels' plain versions there
        raise ValueError(
            f"operands on {where} but the plan's shards sit on "
            f"{[str(dv) for dv in splan.devices]}: place it with "
            f"splan.to(shard_devices(n, device))")
    y_cat = _DRSpMMMultiSharded.apply(splan, dim, idxs, *vals)
    return {s.etype: y for s, y in zip(splan.segments,
                                       _split_out(splan, y_cat))}


# ---------------------------------------------------------------------------
# device arenas of single adjacencies (spmm, drspmm_learnable)
# ---------------------------------------------------------------------------

# (what, id(pack), device) -> (weakref to pack, device tables): fusing,
# densifying and the copy to the card happen once per adjacency, so an
# epoch after the first pays none of them; an entry goes when its
# adjacency dies
_DEVICE_TABLES: Dict[tuple, tuple] = {}


def _memo(what, pack, device: torch.device, build):
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        # a memoised table would be baked into the graph and replayed
        # for every later batch, whatever that batch's tables hold
        raise RuntimeError(
            f"{what} tables of a packing cannot be built or reused inside "
            f"a CUDA-graph capture: capture a collated batch, whose fused "
            f"arenas are already on the card")
    key = (what, id(pack), str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is not None and hit[0]() is pack:
        return hit[1]
    val = build()
    _DEVICE_TABLES[key] = (
        weakref.ref(pack, lambda _: _DEVICE_TABLES.pop(key, None)), val)
    return val


def device_arena(pack: Union[BucketedELL, FusedELL], device, *,
                 eids: bool = False) -> FusedELL:
    """The fused arena of ``pack`` with its tables on ``device``.  A
    :class:`BucketedELL` is fused first (``eids=True`` reads it as an
    edge-id slab packing); a host :class:`FusedELL` is copied; a
    :class:`FusedELL` already on ``device`` is returned as it is."""
    device = resolve_device(device)
    if isinstance(pack, FusedELL) and isinstance(pack.nbr, torch.Tensor) \
            and pack.nbr.device == device:
        return pack

    def build():
        f = pack if isinstance(pack, FusedELL) else fuse_bucketed(pack,
                                                                 eids=eids)
        if eids and f.eid is None:
            raise ValueError("drspmm_learnable needs an edge-id packing "
                             "(pack_eid_slabs / pack_fused_eid_pair)")
        return f.to(device)
    return _memo(("arena", eids), pack, device, build)


def device_buckets(adj: BucketedELL, device) -> BucketedELL:
    """``adj`` with every bucket's slabs on ``device``: int32 ``nbr``,
    float32 ``w`` and int64 ``rows`` (the ``index_add_`` index), copied
    once per adjacency and device."""
    device = resolve_device(device)

    def build():
        t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)
        return BucketedELL(
            buckets=tuple(ELLBucket(rows=t(b.rows, np.int64),
                                    nbr=t(b.nbr, np.int32),
                                    w=t(b.w, np.float32))
                          for b in adj.buckets),
            n_dst=adj.n_dst, n_src=adj.n_src, nnz=adj.nnz)
    return _memo("buckets", adj, device, build)


def device_dense(adj: Union[BucketedELL, FusedELL], device) -> torch.Tensor:
    """``adj`` as a contiguous float32 (n_dst, n_src) matrix on
    ``device`` (the single-relation dense tier), built once per adjacency
    and device; an arena whose tables are already tensors is densified
    where they are."""
    device = resolve_device(device)
    if isinstance(adj, FusedELL) and isinstance(adj.w, torch.Tensor):
        return _memo("dense", adj, device,
                     lambda: _dense_of(adj, adj.w).to(device).contiguous())
    return _memo("dense", adj, device,
                 lambda: torch.from_numpy(adj.to_dense()).to(device))


def _dense_of(f: FusedELL, w: torch.Tensor) -> torch.Tensor:
    """(n_dst, n_src) matrix of the arena ``f`` with slot weights ``w``
    (C, BR, Ec); differentiable in ``w``."""
    rows = f.rows.long()[_k._arena_rows(f)]                  # (C, BR)
    a = torch.zeros((f.n_dst, f.n_src), dtype=torch.float32,
                    device=w.device)
    return a.index_put((rows[:, :, None].expand(f.nbr.shape),
                        f.nbr.long()), w, accumulate=True)


# ---------------------------------------------------------------------------
# drspmm: one relation's DR-SpMM, sampled backward
# ---------------------------------------------------------------------------

def _bucket_fwd(bk: BucketedELL, x_vals, x_idx, dim: int) -> torch.Tensor:
    """Caller-ordered Y (n_dst, dim): kernel 10 per bucket, each bucket's
    rows added at ``rows`` (its padding rows repeat row 0 with zero
    weights, so the add must accumulate)."""
    y = torch.zeros((bk.n_dst, dim), dtype=torch.float32,
                    device=x_vals.device)
    for b in bk.buckets:
        y.index_add_(0, b.rows, _k.drspmm_fwd_bucket(b, x_vals, x_idx, dim))
    return y


def _bucket_bwd(bk_t: BucketedELL, gy, x_idx) -> torch.Tensor:
    """dV (n_src, k) over the transposed buckets: kernel 11 per bucket at
    the CBSR indices of the bucket's source rows."""
    gv = torch.zeros((bk_t.n_dst, x_idx.shape[1]), dtype=torch.float32,
                     device=gy.device)
    for b in bk_t.buckets:
        xi_rows = x_idx.index_select(0, b.rows)
        gv.index_add_(0, b.rows, _k.drspmm_bwd_bucket(b, gy, xi_rows))
    return gv


class _DRSpMM(torch.autograd.Function):
    """Caller-ordered Y = A·densify(CBSR) of one relation; the backward is
    the sampled dV over the transposed packing, none for the indices.
    ``kind`` picks the executor: ``"arena"`` (kernels 1/4 over the two
    arenas), ``"dense"`` (kernels 2/5 over the two dense matrices) or
    ``"bucket"`` (kernels 10/11 over the two bucket packings)."""

    @staticmethod
    def forward(ctx, kind, a, a_t, dim, x_vals, x_idx):
        xv = x_vals.float().contiguous()
        xi = x_idx.to(torch.int32).contiguous()
        ctx.kind, ctx.a_t = kind, a_t
        ctx.save_for_backward(xi)
        _record_dispatch(xv, "bucket" if kind == "bucket" else "fused",
                         "dense_fwd" if kind == "dense" else "fwd")
        if kind == "arena":
            return _k.drspmm_fwd_arena(a, xv, xi, dim).index_select(
                0, a.gather)
        if kind == "dense":
            return _k.drspmm_dense_tier_fwd(a, xv, xi, dim)
        return _bucket_fwd(a, xv, xi, dim)

    @staticmethod
    def backward(ctx, gy):
        (xi,) = ctx.saved_tensors
        gy = gy.float().contiguous()
        a_t = ctx.a_t
        _record_dispatch(gy, "bucket" if ctx.kind == "bucket" else "fused",
                         "dense_bwd" if ctx.kind == "dense" else "bwd")
        if ctx.kind == "arena":
            gv = _k.drspmm_bwd_arena(a_t, a_t.rows, gy, xi).index_select(
                0, a_t.gather)
        elif ctx.kind == "dense":
            gv = _k.drspmm_dense_tier_bwd(a_t, gy, xi)
        else:
            gv = _bucket_bwd(a_t, gy, xi)
        return None, None, None, None, gv, None


def _dense_tier_single(adj) -> bool:
    """A fused-family relation at or below the dense-tier crossover with a
    small enough dense table runs as the dense tier (a collated arena,
    nnz -1, never does)."""
    return (0 <= adj.nnz <= DENSE_TIER_NNZ
            and adj.n_dst * adj.n_src <= DENSE_TIER_AREA)


def drspmm(adj: Union[BucketedELL, FusedELL],
           adj_t: Union[BucketedELL, FusedELL], x_vals: torch.Tensor,
           x_idx: torch.Tensor, dim: int, *, backend: str = "fused",
           dense: bool = False) -> torch.Tensor:
    """Y = A·densify(CBSR(x_vals, x_idx)) (n_dst, dim) of one relation,
    differentiable in ``x_vals`` (the backward samples Aᵀ·gY at ``x_idx``,
    Alg. 2).  ``adj``/``adj_t`` are the host packings of A and Aᵀ; their
    device tables are built once per adjacency and device.

    Under ``"fused"`` a relation at or below the dense-tier crossover runs
    the dense-tier kernels on its own dense matrix, any other the arena
    kernels on its own arena; under ``"bucket"`` (never dense) kernels 10/11
    run once per degree bucket.  ``dense=True`` runs the oracle
    ``A_dense @ densify(x)`` instead, for tests."""
    dev = x_vals.device
    if dense:                        # host packings only
        return torch.from_numpy(adj.to_dense()).to(dev) @ _k._densify(
            x_vals, x_idx, dim)
    if _effective_backend(adj, backend) == "bucket":
        return _DRSpMM.apply("bucket", device_buckets(adj, dev),
                             device_buckets(adj_t, dev), dim, x_vals, x_idx)
    if _dense_tier_single(adj):
        return _DRSpMM.apply("dense", device_dense(adj, dev),
                             device_dense(adj_t, dev), dim, x_vals, x_idx)
    return _DRSpMM.apply("arena", device_arena(adj, dev),
                         device_arena(adj_t, dev), dim, x_vals, x_idx)


# ---------------------------------------------------------------------------
# spmm: dense-operand SpMM, full backward
# ---------------------------------------------------------------------------

def _bucket_spmm(bk: BucketedELL, x: torch.Tensor) -> torch.Tensor:
    """Caller-ordered Y (n_dst, D): kernel 12 per bucket, each bucket's
    rows added at ``rows``."""
    y = torch.zeros((bk.n_dst, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    for b in bk.buckets:
        y.index_add_(0, b.rows, _k.spmm_bucket(b, x))
    return y

def _spmm_exec(kind: str, a, x: torch.Tensor) -> torch.Tensor:
    _record_dispatch(x, "bucket" if kind == "bucket" else "fused", "spmm")
    if kind == "arena":
        return _k.spmm_arena(a, x).index_select(0, a.gather)
    return _bucket_spmm(a, x)


class _SpMM(torch.autograd.Function):
    """Caller-ordered Y = A·x; the backward is the same executor over Aᵀ
    with gY as the operand (full, not sampled): kernel 6 over the two
    arenas (``kind="arena"``) or kernel 12 over the two bucket packings
    (``kind="bucket"``)."""

    @staticmethod
    def forward(ctx, kind, a, a_t, x):
        ctx.kind, ctx.a_t = kind, a_t
        return _spmm_exec(kind, a, x.float().contiguous())

    @staticmethod
    def backward(ctx, gy):
        if not ctx.needs_input_grad[3]:
            return None, None, None, None
        return None, None, None, _spmm_exec(ctx.kind, ctx.a_t,
                                            gy.float().contiguous())


def spmm(adj: Union[BucketedELL, FusedELL], adj_t: Union[BucketedELL,
                                                         FusedELL],
         x: torch.Tensor, *, backend: str = "fused",
         dense: bool = False) -> torch.Tensor:
    """Y = A·x (n_dst, D), differentiable in ``x``.  ``adj``/``adj_t`` are
    the host packings of A and Aᵀ; their fused arenas (``"fused"``) or
    bucket slabs (``"bucket"``) are copied to ``x``'s device once
    (:func:`device_arena`, :func:`device_buckets`).  ``dense=True`` runs
    the oracle ``A_dense @ x`` instead, for tests."""
    if dense:                        # host packings only
        return torch.from_numpy(adj.to_dense()).to(x.device) @ x
    if _effective_backend(adj, backend) == "bucket":
        return _SpMM.apply("bucket", device_buckets(adj, x.device),
                           device_buckets(adj_t, x.device), x)
    return _SpMM.apply("arena", device_arena(adj, x.device),
                       device_arena(adj_t, x.device), x)


# ---------------------------------------------------------------------------
# drspmm_learnable: per-edge weights with gradients
# ---------------------------------------------------------------------------

class _DRSpMMLearnable(torch.autograd.Function):
    """Caller-ordered Y = A(w)·densify(CBSR) over the forward and
    transposed edge-id arenas; the backward gives dL/dw (kernel 9) and
    dL/dx_vals (kernel 8), none for the indices."""

    @staticmethod
    def forward(ctx, f, ft, nnz, dim, w_canon, x_vals, x_idx):
        w_canon = w_canon.float().contiguous()
        x_vals = x_vals.float().contiguous()
        ctx.f, ctx.ft, ctx.nnz = f, ft, nnz
        ctx.save_for_backward(w_canon, x_vals, x_idx)
        _record_dispatch(x_vals, "fused", "learnable_fwd")
        y = _k.drspmm_fwd_learnable(f, nnz, w_canon, x_vals, x_idx, dim)
        return y.index_select(0, f.gather)

    @staticmethod
    def backward(ctx, gy):
        w_canon, x_vals, x_idx = ctx.saved_tensors
        gy = gy.float().contiguous()
        gw = gx = None
        if ctx.needs_input_grad[4]:
            _record_dispatch(gy, "fused", "learnable_dw")
            gw = _k.drspmm_dw_learnable(ctx.f, ctx.nnz, gy, x_vals, x_idx)
        if ctx.needs_input_grad[5]:
            _record_dispatch(gy, "fused", "learnable_bwd")
            gx = _k.drspmm_bwd_learnable(ctx.ft, ctx.nnz, w_canon, gy,
                                         x_idx).index_select(0, ctx.ft.gather)
        return None, None, None, None, gw, gx, None


def _slab_weights(wp: torch.Tensor, b: ELLBucket) -> ELLBucket:
    """``b`` with its edge-id slab (``w`` = f32(id + 1), 0 on padding)
    replaced by the weights ``wp[id]`` (``wp``: canonical weights plus a
    trailing 0 that padding reads)."""
    ids = b.w.long() - 1
    nnz = wp.shape[0] - 1
    return ELLBucket(rows=b.rows, nbr=b.nbr,
                     w=wp[torch.where(ids < 0, nnz, ids)].contiguous())


class _DRSpMMLearnableBucket(torch.autograd.Function):
    """The per-bucket counterpart of :class:`_DRSpMMLearnable` over edge-id
    slabs: each bucket's weights are gathered from ``w_canon``, then
    kernel 10 (forward) and kernel 11 (dL/dx_vals over the transposed
    slabs) run on them; dL/dw is the bucketed plain reduction
    (``kernels/learnable.py::_bwd_w``), as in the reference."""

    @staticmethod
    def forward(ctx, fs, ts, nnz, dim, w_canon, x_vals, x_idx):
        wp = torch.cat([w_canon.float(),
                        w_canon.new_zeros(1, dtype=torch.float32)])
        x_vals = x_vals.float().contiguous()
        ctx.fs, ctx.ts, ctx.nnz = fs, ts, nnz
        ctx.save_for_backward(wp, x_vals, x_idx)
        y = torch.zeros((fs.n_dst, dim), dtype=torch.float32,
                        device=x_vals.device)
        _record_dispatch(x_vals, "bucket", "learnable_fwd")
        for b in fs.buckets:
            y.index_add_(0, b.rows, _k.drspmm_fwd_bucket(
                _slab_weights(wp, b), x_vals, x_idx, dim))
        return y

    @staticmethod
    def backward(ctx, gy):
        wp, x_vals, x_idx = ctx.saved_tensors
        gy = gy.float().contiguous()
        gw = gx = None
        if ctx.needs_input_grad[4]:
            _record_dispatch(gy, "bucket", "learnable_dw")
            gw = _learn._bwd_w(ctx.fs, gy, x_vals, x_idx, ctx.nnz)
        if ctx.needs_input_grad[5]:
            _record_dispatch(gy, "bucket", "learnable_bwd")
            gx = torch.zeros(x_idx.shape, dtype=torch.float32,
                             device=gy.device)
            for b in ctx.ts.buckets:
                xi_rows = x_idx.index_select(0, b.rows)
                gx.index_add_(0, b.rows, _k.drspmm_bwd_bucket(
                    _slab_weights(wp, b), gy, xi_rows))
        return None, None, None, None, gw, gx, None


def drspmm_learnable(fwd, bwd, nnz: int, w_canon: torch.Tensor,
                     x_vals: torch.Tensor, x_idx: torch.Tensor, dim: int, *,
                     backend: str = "fused",
                     dense: bool = False) -> torch.Tensor:
    """Y = A(w)·densify(CBSR(x)) (n_dst, dim), differentiable in both
    ``w_canon`` (nnz,) and ``x_vals`` (N, k).

    ``fwd``/``bwd`` are the forward and transposed edge-id packings: fused
    arenas (:func:`~repro_torch.graphs.ell.pack_fused_eid_pair`), on the
    host or already on the operands' device, or edge-id slabs
    (:func:`~repro_torch.graphs.ell.pack_eid_slabs`).  Under ``"fused"``
    the slabs are fused into arenas (kernels 7-9); under ``"bucket"`` they
    run bucket by bucket (kernels 10/11 and the plain dW reduction), and
    fused arenas upgrade to ``"fused"``.  ``dense=True`` runs the oracle:
    the dense A(w) times the densified operand, differentiated by
    autograd."""
    dev = x_vals.device
    xi = x_idx.to(torch.int32).contiguous()
    if dense:
        f = device_arena(fwd, dev, eids=True)
        wa = _k._canon_slot_weights(f, nnz, w_canon)
        return _dense_of(f, wa) @ _k._densify(x_vals, x_idx, dim)
    if _effective_backend(fwd, backend) == "bucket":
        return _DRSpMMLearnableBucket.apply(
            device_buckets(fwd, dev), device_buckets(bwd, dev), nnz, dim,
            w_canon, x_vals, xi)
    return _DRSpMMLearnable.apply(device_arena(fwd, dev, eids=True),
                                  device_arena(bwd, dev, eids=True), nnz,
                                  dim, w_canon, x_vals, xi)
