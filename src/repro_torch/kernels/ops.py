"""The differentiable ops over the kernels of ``kernels/drspmm.py``.

* ``drspmm_multi``: one hetero layer's whole message passing over a
  :class:`~repro_torch.graphs.ell.RelationPlan`, forward and sampled
  backward (the D-ReLU path);
* ``spmm``: one relation's SpMM with a dense operand and the full backward
  over the transposed arena (the D-ReLU-off DR-CircuitGNN and the GCN /
  SAGE baselines);
* ``drspmm_learnable``: DR-SpMM whose edge weights are a differentiable
  canonical vector (the GAT baselines).

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
dense product.
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.graphs.ell import (BucketedELL, FusedELL, RelationPlan,
                                    fuse_bucketed)
from repro_torch.kernels import drspmm as _k


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
        ya = _k.drspmm_fwd_arena(plan.fwd, xv, xi, dim)
        ya = ya.index_select(0, plan.fwd.gather)
    if plan.has_dense:
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
        dv = _k.drspmm_bwd_arena(plan.bwd, plan.bwd_src_rows, gy_cat, xi)
        dx_cat = dv.index_select(0, plan.bwd.gather)
    if plan.has_dense:
        gy_dense = gy_cat if not plan.has_arena else torch.cat(
            [gy_cat[s.out_off:s.out_off + s.n_dst]
             for s in plan.dense_segments])
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
# device arenas of single adjacencies (spmm, drspmm_learnable)
# ---------------------------------------------------------------------------

# (id(pack), eids, device) -> (weakref to pack, device arena): fusing and
# the copy to the card happen once per adjacency, so an epoch after the
# first pays neither; an entry goes when its adjacency dies
_DEVICE_ARENAS: Dict[tuple, tuple] = {}


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
    key = (id(pack), eids, str(device))
    hit = _DEVICE_ARENAS.get(key)
    if hit is not None and hit[0]() is pack:
        return hit[1]
    f = pack if isinstance(pack, FusedELL) else fuse_bucketed(pack,
                                                             eids=eids)
    if eids and f.eid is None:
        raise ValueError("drspmm_learnable needs an edge-id packing "
                         "(pack_eid_slabs / pack_fused_eid_pair)")
    f = f.to(device)
    _DEVICE_ARENAS[key] = (
        weakref.ref(pack, lambda _: _DEVICE_ARENAS.pop(key, None)), f)
    return f


def _dense_of(f: FusedELL, w: torch.Tensor) -> torch.Tensor:
    """(n_dst, n_src) matrix of the arena ``f`` with slot weights ``w``
    (C, BR, Ec); differentiable in ``w``."""
    rows = f.rows.long()[_k._arena_rows(f)]                  # (C, BR)
    a = torch.zeros((f.n_dst, f.n_src), dtype=torch.float32,
                    device=w.device)
    return a.index_put((rows[:, :, None].expand(f.nbr.shape),
                        f.nbr.long()), w, accumulate=True)


# ---------------------------------------------------------------------------
# spmm: dense-operand SpMM, full backward
# ---------------------------------------------------------------------------

class _SpMM(torch.autograd.Function):
    """Caller-ordered Y = A·x; the backward is the same kernel over the
    arena of Aᵀ with gY as the operand (full, not sampled)."""

    @staticmethod
    def forward(ctx, fa, fa_t, x):
        ctx.fa_t = fa_t
        return _k.spmm_arena(fa, x.float().contiguous()).index_select(
            0, fa.gather)

    @staticmethod
    def backward(ctx, gy):
        if not ctx.needs_input_grad[2]:
            return None, None, None
        gx = _k.spmm_arena(ctx.fa_t, gy.float().contiguous())
        return None, None, gx.index_select(0, ctx.fa_t.gather)


def spmm(adj: Union[BucketedELL, FusedELL], adj_t: Union[BucketedELL,
                                                         FusedELL],
         x: torch.Tensor, *, dense: bool = False) -> torch.Tensor:
    """Y = A·x (n_dst, D), differentiable in ``x``.  ``adj``/``adj_t`` are
    the host packings of A and Aᵀ; their fused arenas are built and copied
    to ``x``'s device once (:func:`device_arena`).  ``dense=True`` runs the
    oracle ``A_dense @ x`` instead, for tests."""
    if dense:                        # host packings only
        return torch.from_numpy(adj.to_dense()).to(x.device) @ x
    return _SpMM.apply(device_arena(adj, x.device),
                       device_arena(adj_t, x.device), x)


# ---------------------------------------------------------------------------
# drspmm_learnable: per-edge weights with gradients
# ---------------------------------------------------------------------------

class _DRSpMMLearnable(torch.autograd.Function):
    """Caller-ordered Y = A(w)·densify(CBSR); the backward gives dL/dw
    (kernel 9) and dL/dx_vals (kernel 8), none for the indices."""

    @staticmethod
    def forward(ctx, f, ft, nnz, dim, w_canon, x_vals, x_idx):
        w_canon = w_canon.float().contiguous()
        x_vals = x_vals.float().contiguous()
        ctx.f, ctx.ft, ctx.nnz = f, ft, nnz
        ctx.save_for_backward(w_canon, x_vals, x_idx)
        y = _k.drspmm_fwd_learnable(f, nnz, w_canon, x_vals, x_idx, dim)
        return y.index_select(0, f.gather)

    @staticmethod
    def backward(ctx, gy):
        w_canon, x_vals, x_idx = ctx.saved_tensors
        gy = gy.float().contiguous()
        gw = gx = None
        if ctx.needs_input_grad[4]:
            gw = _k.drspmm_dw_learnable(ctx.f, ctx.nnz, gy, x_vals, x_idx)
        if ctx.needs_input_grad[5]:
            gx = _k.drspmm_bwd_learnable(ctx.ft, ctx.nnz, w_canon, gy,
                                         x_idx).index_select(0, ctx.ft.gather)
        return None, None, None, None, gw, gx, None


def drspmm_learnable(fwd, bwd, nnz: int, w_canon: torch.Tensor,
                     x_vals: torch.Tensor, x_idx: torch.Tensor, dim: int, *,
                     dense: bool = False) -> torch.Tensor:
    """Y = A(w)·densify(CBSR(x)) (n_dst, dim), differentiable in both
    ``w_canon`` (nnz,) and ``x_vals`` (N, k).

    ``fwd``/``bwd`` are the forward and transposed edge-id packings: fused
    arenas (:func:`~repro_torch.graphs.ell.pack_fused_eid_pair`), on the
    host or already on the operands' device, or edge-id slabs
    (:func:`~repro_torch.graphs.ell.pack_eid_slabs`).  ``dense=True`` runs
    the oracle: the dense A(w) times the densified operand, differentiated
    by autograd."""
    dev = x_vals.device
    f = device_arena(fwd, dev, eids=True)
    if dense:
        wa = _k._canon_slot_weights(f, nnz, w_canon)
        return _dense_of(f, wa) @ _k._densify(x_vals, x_idx, dim)
    ft = device_arena(bwd, dev, eids=True)
    return _DRSpMMLearnable.apply(f, ft, nnz, dim, w_canon, x_vals,
                                  x_idx.to(torch.int32).contiguous())
