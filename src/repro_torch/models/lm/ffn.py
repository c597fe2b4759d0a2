"""FFN layers: SwiGLU, its D-ReLU-sparsified form (the paper's technique
on an LM's FFN hidden), and the MoE FFN.

Port of ``repro/models/lm/ffn.py``.  ``drelu_k`` keeps
the top-k entries of every token's hidden (balanced row sparsity, Eqs. 2-3
of the paper): prefill runs it as a masked dense product, decode gathers
only the k surviving rows of W_down (``vals . W_down[idx]``), the analogue
of DR-SpMM consuming CBSR operands.  The hidden is tagged for the ``proj``
remat policy, as the reference names it.  With no mesh the reference's
``_drelu_sharded`` is ``drelu_grouped``.

MoE: the router is a per-row top-k over the expert axis (the D-ReLU
operator family).  The port is the reference's single-shard path
(``use_shmap=False``: every expert local, ``e_offset`` 0); the
expert-parallel ``shard_map`` branch waits with multi-device training
(ROADMAP.md §1 item 6).  Which assignments a capacity drops is decided by
each assignment's rank among the earlier ones to its expert in the
token-major (T*k) order, the integers of the reference's one-hot cumsum,
so both keep the same set.  Kept assignments own unique slots of the
expert buffer (dropped ones write a discarded sentinel row), and a
token's k contributions are summed over a (T, k, d) view: no float
atomics, no ``index_add_``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.cbsr import cbsr_from_dense
from repro_torch.core.drelu import drelu_grouped
from repro_torch.models.lm.common import round_up, tag_proj


def _swiglu_hidden(x, w_gate, w_up):
    h = F.silu(torch.einsum("bsd,df->bsf", x, w_gate))
    return h * torch.einsum("bsd,df->bsf", x, w_up)


def swiglu_ffn(x, w_gate, w_up, w_down, drelu_k: int = 0,
               drelu_groups: int = 1):
    """(B,S,d) -> (B,S,d).  ``drelu_k`` > 0 sparsifies the hidden row-wise
    via grouped D-ReLU."""
    h = _swiglu_hidden(x, w_gate, w_up)
    if 0 < drelu_k < h.shape[-1]:
        h = drelu_grouped(h, drelu_k, drelu_groups)
    h = tag_proj(h)
    return torch.einsum("bsf,fd->bsd", h, w_down)


def swiglu_ffn_decode_sparse(x, w_gate, w_up, w_down, drelu_k: int):
    """Decode-path FFN exploiting D-ReLU sparsity structurally.

    x: (B, 1, d).  The down-projection touches only the k surviving rows of
    W_down per token: y = sum_t vals_t . W_down[idx_t]."""
    h = _swiglu_hidden(x, w_gate, w_up)
    b, s, f = h.shape
    if not (0 < drelu_k < f):
        return torch.einsum("bsf,fd->bsd", h, w_down)
    c = cbsr_from_dense(h.reshape(b * s, f), drelu_k)
    rows = w_down[c.idx.long()]                 # (B*S, k, d) weight gather
    y = torch.einsum("tk,tkd->td", c.values, rows)
    return y.reshape(b, s, -1)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_capacity(tokens_per_shard: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(tokens_per_shard * top_k / n_experts * capacity_factor)
    return max(round_up(c, 8), 8)


def _route(x2d, router_w, top_k: int):
    """Top-k routing (the D-ReLU operator on the expert axis): fp32 logits
    and softmax, the top k (ties to the lower expert, as ``lax.top_k``: a
    stable descending sort), renormalised and cast to ``x2d``'s dtype.

    Returns (probs (T,k), ids (T,k) int64, full_probs (T,E) fp32)."""
    logits = torch.einsum("td,de->te", x2d.float(), router_w.float())
    full = torch.softmax(logits, dim=-1)
    probs, ids = torch.sort(full, dim=-1, descending=True, stable=True)
    probs, ids = probs[:, :top_k], ids[:, :top_k]
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    return probs.to(x2d.dtype), ids, full


def _slots(ids, e_local: int, e_offset: int, cap: int):
    """Each assignment's (expert, slot) in the capacity buffer, token-major
    (T*k) order: an assignment's slot is the count of earlier assignments
    to its expert, the reference's integer cumsum of the one-hot, computed
    as each assignment's rank in a stable sort by expert (the same
    integers: the sort keeps the token-major order within an expert);
    slots >= ``cap`` and experts off this shard are dropped to the
    sentinel (``e_local``, ``cap``).  Returns (expert, slot, keep), each
    (T*k,)."""
    flat = ids.reshape(-1)
    local = (flat >= e_offset) & (flat < e_offset + e_local)
    el = torch.where(local, flat - e_offset, torch.full_like(flat, e_local))
    by_expert, order = torch.sort(el, stable=True)
    first = torch.searchsorted(by_expert, by_expert)   # each expert's start
    p = torch.empty_like(el)
    p[order] = torch.arange(el.numel(), device=el.device) - first
    keep = local & (p < cap)
    return (torch.where(keep, el, torch.full_like(el, e_local)),
            torch.where(keep, p, torch.full_like(p, cap)), keep)


def _dispatch(x2d, el, p, keep, e_local: int, cap: int, top_k: int):
    """The (E_l, C, d) expert buffer: slot (e, c) holds the token of the
    kept assignment that owns it, an empty slot zeros.  The assignments'
    rows (a (T, k) broadcast of the tokens) are written to their slots;
    kept slots are unique and every dropped assignment writes one sentinel
    row past the buffer, which is cut off.  The backward reads each
    assignment's slot (a gather) and sums a token's k rows."""
    t, d = x2d.shape
    rows = x2d[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    dest = torch.where(keep, el * cap + p, torch.full_like(el, e_local * cap))
    buf = x2d.new_zeros((e_local * cap + 1, d)).index_put((dest,), rows)
    return buf[:-1].reshape(e_local, cap, d)


def _expert_ffn(buf, w_gate, w_up, w_down):
    """buf (E_l, C, d) through per-expert SwiGLU."""
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate))
    h = h * torch.einsum("ecd,edf->ecf", buf, w_up)
    return torch.einsum("ecf,efd->ecd", h, w_down)


def _combine(y_buf, el, p, probs, keep, top_k: int):
    """y (T, d): each token's k expert outputs weighted by its routing
    probabilities (a dropped assignment weighs 0), summed over a (T, k, d)
    view.  A dropped assignment reads some slot of its own (assignment i
    reads slot i mod E_l*C) at weight 0, so no slot is read by more than
    a few assignments and the backward's accumulation has no long run of
    one index."""
    e_local, cap, d = y_buf.shape
    n = el.numel()
    spread = torch.arange(n, device=el.device) % (e_local * cap)
    src = torch.where(keep, el * cap + p, spread)
    gathered = y_buf.reshape(e_local * cap, d)[src]       # (T*k, d)
    flat = probs.reshape(-1)
    contrib = gathered * (flat * keep.to(flat.dtype))[:, None]
    return contrib.reshape(-1, top_k, d).sum(1)


def _moe_routed(x, probs, ids, w_gate, w_up, w_down, top_k,
                capacity_factor, e_offset: int, n_experts_global: int):
    b, s, d = x.shape
    e_local = w_gate.shape[0]
    x2d = x.reshape(b * s, d)
    cap = moe_capacity(b * s, n_experts_global, top_k, capacity_factor)
    el, p, keep = _slots(ids, e_local, e_offset, cap)
    buf = _dispatch(x2d, el, p, keep, e_local, cap, top_k)
    y_buf = _expert_ffn(buf, w_gate, w_up, w_down)
    return _combine(y_buf, el, p, probs, keep, top_k).reshape(b, s, d)


def _moe_local(x, router_w, w_gate, w_up, w_down, top_k, capacity_factor,
               e_offset: int, n_experts_global: int):
    """Single-shard MoE over local experts; x (B,S,d) fully local."""
    probs, ids, _ = _route(x.reshape(-1, x.shape[-1]), router_w, top_k)
    return _moe_routed(x, probs, ids, w_gate, w_up, w_down, top_k,
                       capacity_factor, e_offset, n_experts_global)


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, n_experts: int,
            top_k: int, capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over all experts on this device.  x (B,S,d).

    Returns (y, aux_loss): aux is the standard load-balance loss,
    E * sum(frac * imp); the one-hot ``frac`` carries no gradient, ``imp``
    (the mean routing probability) does.  The router runs once for both
    (the reference runs it twice on the same input: the same numbers)."""
    b, s, d = x.shape
    probs, ids, full = _route(x.reshape(b * s, d), router_w, top_k)
    frac = F.one_hot(ids, n_experts).float().mean(dim=(0, 1))
    imp = full.mean(dim=0)
    aux = n_experts * torch.sum(frac * imp)
    y = _moe_routed(x, probs, ids, w_gate, w_up, w_down, top_k,
                    capacity_factor, 0, n_experts)
    return y, aux
