"""``drspmm_multi``: one hetero layer's whole message passing over a
:class:`~repro_torch.graphs.ell.RelationPlan`, forward and backward.

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

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.graphs.ell import RelationPlan
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
        f = plan.fwd
        fa = torch.zeros((f.n_dst, f.n_src), dtype=torch.float32, device=dev)
        rows = (f.block_of.long()[:, None] * f.row_block
                + torch.arange(f.row_block, device=dev)[None, :])
        slot_rows = f.rows.long()[rows]                       # (C, BR)
        fa.index_put_((slot_rows[:, :, None].expand(f.nbr.shape),
                       f.nbr.long()), f.w, accumulate=True)
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
