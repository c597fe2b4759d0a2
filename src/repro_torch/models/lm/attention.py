"""Attention: GQA (flat-head layout) with optional qk-norm, the chunked
flash prefill and one-token decode against a KV cache.

Port of ``repro/models/lm/attention.py``, single device.  KV heads keep
their true count; q head h reads kv head h % n_kv (``jnp.tile``'s order).
``chunked_attention`` takes the untiled k/v: on CUDA tensors it is one
launch of kernel 13 (``kernels/flash_attention.py``), which reads each KV
head where it lies, and on CPU tensors one call of its plain online
softmax; the reference's chunk schedule (``_pick_chunk``, brick or masked)
is not ported, since it changes no number.  Under autograd its backward
is kernel 13b on the card and the plain backward on the CPU (the
reference's is XLA's autodiff of its scan).  Decode attention is plain
PyTorch on both devices, as the reference computes it outside any kernel.
The sequence-sharded ``shard_map`` decode is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.models.lm.common import head_rms_norm, rope, tag_proj

NEG_INF = -1e30


def tile_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd); q head h reads kv head h % KV."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat(1, 1, n_heads // kv, 1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash attention.  q (B,Sq,H,hd); k/v (B,Sk,KV,hd), H % KV == 0,
    q head h reading kv head h % KV (``tile_kv``'s order, without the copy).

    The reference's q/kv chunk schedule changes no number, so the port has
    none: CUDA tensors make one launch of kernel 13, CPU tensors one call
    of its plain version."""
    return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


# ---------------------------------------------------------------------------
# full attention block (training / prefill)
# ---------------------------------------------------------------------------

def attention_block(x, wq, wk, wv, wo, *, n_kv: int,
                    qk_q: Optional[torch.Tensor] = None,
                    qk_k: Optional[torch.Tensor] = None,
                    rope_theta: float = 1e6,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Projections + RoPE + chunked flash + out-projection.

    x (B,S,d).  ``kv_x`` switches to cross-attention (no RoPE, no causal
    mask).  wq (d,H,hd); wk/wv (d,KV,hd); wo (H,hd,d)."""
    s = x.shape[1]
    src = x if kv_x is None else kv_x

    q = torch.einsum("bsd,dhe->bshe", x, wq)
    k = torch.einsum("bsd,dke->bske", src, wk)
    v = torch.einsum("bsd,dke->bske", src, wv)
    if qk_q is not None:
        q = head_rms_norm(q, qk_q)
        k = head_rms_norm(k, qk_k)
    if kv_x is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    # the projections the "proj" remat policy keeps, as the reference
    # names them
    q, k, v = tag_proj(q), tag_proj(k), tag_proj(v)
    ctx = tag_proj(chunked_attention(q, k, v, causal=causal and kv_x is None))
    out = torch.einsum("bshe,hed->bsd", ctx, wo)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# decode: one token against the KV cache
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, pos, new_k, new_v):
    """One-token attention against a KV cache.

    q (B,1,H,hd); caches (B,S_max,KV,hd); new_k/new_v (B,1,KV,hd) are
    written at ``pos`` before attending -- in place: the port updates the
    caches it is given (the reference returns new arrays) and returns them.
    ``pos`` is a scalar (lockstep batch) or a (B,) tensor (continuous
    batching: every slot at its own position).
    Returns (ctx (B,1,H,hd), k_cache, v_cache)."""
    if torch.is_tensor(pos) and pos.ndim == 1:          # per-slot positions
        b_idx = torch.arange(q.shape[0], device=q.device)
        k_cache[b_idx, pos] = new_k[:, 0]
        v_cache[b_idx, pos] = new_v[:, 0]
    else:
        p = int(pos)
        k_cache[:, p:p + 1] = new_k
        v_cache[:, p:p + 1] = new_v
    ctx = _local_decode(q, k_cache, v_cache, pos, 0)
    return ctx, k_cache, v_cache


def _partial_decode(q, kc, vc, pos, offset):
    """Masked partial attention stats over one KV span (f32).

    q (B,1,H,hd); kc/vc (B,S_l,KV,hd); pos scalar or (B,)."""
    h, hd = q.shape[2], q.shape[3]
    s_local = kc.shape[1]
    scale = 1.0 / (hd ** 0.5)
    kt = tile_kv(kc, h)
    vt = tile_kv(vc, h)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kt.float()) * scale
    span = torch.arange(s_local, device=q.device) + offset
    if torch.is_tensor(pos) and pos.ndim == 1:
        valid = span[None, :] <= pos[:, None]               # (B, S_l)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    else:
        s = torch.where((span <= int(pos))[None, None, None, :], s, NEG_INF)
    m = s.amax(-1)                                          # (B,H,1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhqs,bshd->bqhd", p, vt.float())
    return m, l, acc


def _local_decode(q, kc, vc, pos, offset):
    m, l, acc = _partial_decode(q, kc, vc, pos, offset)
    return (acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
            ).to(q.dtype)
