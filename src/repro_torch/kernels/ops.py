"""``drspmm_multi``: one hetero layer's whole message passing over a
:class:`~repro_torch.graphs.ell.RelationPlan`, forward.

The plan's arena-tier relations run as one launch of the arena kernel over
the super-arena and its dense-tier relations as at most one launch of the
dense-tier kernel; the two outputs are reassembled into the relation-concat
order and split per relation.  A CUDA operand launches the kernels, a CPU
operand runs their plain versions (``kernels/drspmm.py``).  ``dense=True``
runs the fully dense oracle instead, for tests.

The backward (the sampled SSpMM of Alg. 2 over the transposed arena) comes
with the port's training slice; asking for a gradient raises.
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
    """Whole-direction-group DR-SpMM forward.

    ``plan`` holds tensors on the operands' device (``plan.to(device)``);
    ``cbsr`` maps each source node type to its CBSR pair ``(vals (n_t,
    k_t), idx (n_t, k_t))`` -- k may differ per type.  Returns ``{etype: y
    (n_dst_r, dim)}``."""
    vals = tuple(cbsr[t][0] for t in plan.src_types)
    idxs = tuple(cbsr[t][1] for t in plan.src_types)
    if torch.is_grad_enabled() and any(v.requires_grad for v in vals):
        raise NotImplementedError(
            "drspmm_multi has no backward yet: the sampled SSpMM backward "
            "kernels come with the port's training slice; call it under "
            "torch.no_grad() / torch.inference_mode()")
    xv, xi = _multi_concat(plan, vals, idxs)
    if dense:
        y_cat = _plan_dense_mat(plan) @ _k._densify(xv, xi, dim)
    else:
        y_cat = _hybrid_fwd(plan, xv, xi, dim)
    return {s.etype: y for s, y in zip(plan.segments, _split_out(plan, y_cat))}
