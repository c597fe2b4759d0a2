"""Causal (or full) softmax attention, single pass with an online softmax,
and its backward.

Replaces ``flash_attention`` (``src/repro/kernels/flash_attention.py:71``),
the TPU kernel of the LM's prefill.  q is (B, Sq, H, hd) and k/v
(B, Sk, KV, hd) with ``H % KV == 0``: q head h reads KV head ``h % KV``
(``jnp.tile``'s order, as ``tile_kv`` lays the heads out), so the KV heads
are never copied.  The scale is ``1/sqrt(hd)``; scores, the running max /
sum and the output sum stay in fp32 (``NEG_INF = -1e30`` masks, the output
divides by ``max(l, 1e-30)``) and the output has q's dtype.  The causal
mask is by absolute position, ``q_offset + i >= j``.

CUDA source: ``csrc/flash_attention_fwd.cu`` (head dim 32, 64 or 128, any
Sq and Sk).  Its bound at the qwen3-0.6b prefill is the causal FLOPs at
the bf16 tensor-core peak.  bf16 runs a warp-specialised tensor-core kernel:
TMA loads of bf16 K/V tiles at their KV heads into a shared-memory ring,
``wgmma`` for Q·Kᵀ and for P·V, where P goes in as P_hi = bf16(P) plus
P_lo = bf16(P - P_hi), which keeps it to about 2^-16, so the result stays
within one bf16 rounding of the plain version's fp32 P.  fp32 runs a
scalar kernel whose sums match the plain version to fp32 rounding.
:func:`flash_attention_plain` is the same function in plain PyTorch: CPU
tensors run it, and the card's runs are held against it.

Training (the reference differentiates ``chunked_attention``'s XLA scan;
the port's gradient is a kernel of its own): when q, k or v needs a
gradient, :func:`flash_attention` goes through one autograd Function on
both devices.  Its forward also writes each row's log-sum-exp (fp32,
(B, H, Sq), ``m + log l`` of the scaled scores); its backward is
:func:`flash_attention_bwd`, kernel 13b (``csrc/flash_attention_bwd.cu``,
FlashAttention-2's backward without atomics) on the card and
:func:`flash_attention_bwd_plain` on the CPU.  dK and dV come back at the
KV heads, summed over the q heads that read each.  In bf16, 13b runs two
warp-specialised tensor-core kernels (TMA + ``wgmma``, the machinery of
kernel 13 in ``csrc/flash_hopper.cuh``): dK/dV a 128-key tile, dQ a 128-row
tile, with P and dS as bf16 hi + lo, since one bf16 rounding of either
leaves the gradients more than one bf16 ulp from the plain version; fp32
runs scalar kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.drspmm import _on_card

BLOCK_K = 64
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          return_lse: bool = False):
    """Online softmax over kv tiles of ``BLOCK_K`` rows, every q row at
    once (the reference's ``_flash_inner`` for one q chunk).  k/v with KV <
    H heads are tiled first, head h from KV head h % KV.  With
    ``return_lse`` also each row's log-sum-exp, (B, H, Sq) fp32."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    _check_heads(h, k, v)
    if k.shape[2] != h:
        k, v = (t.repeat(1, 1, h // t.shape[2], 1) for t in (k, v))
    scale = 1.0 / (hd ** 0.5)
    qf = q.float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, BLOCK_K):
        kc, vc = k[:, k0:k0 + BLOCK_K].float(), v[:, k0:k0 + BLOCK_K].float()
        s = torch.einsum("bqhd,bshd->bhqs", qf, kc) * scale
        if causal:
            k_pos = k0 + torch.arange(kc.shape[1], device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = (acc * corr.transpose(1, 2)[..., None]
               + torch.einsum("bhqs,bshd->bqhd", p, vc))
        m = m_new
    den = torch.clamp(l, min=1e-30)
    out = (acc / den.transpose(1, 2)[..., None]).to(q.dtype)
    return (out, m + torch.log(den)) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              q_offset: int = 0):
    """dq, dk, dv of :func:`flash_attention_plain` from its output ``o``
    and log-sum-exp ``lse``: FlashAttention-2's formulas in fp32 over the
    whole (Sq, Sk) score matrix.  dk/dv at the KV heads, summed over the q
    heads that read each; each gradient in its input's dtype."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    _check_heads(h, k, v)
    kt, vt = (t.repeat(1, 1, h // n_kv, 1).float() for t in (k, v))
    qf, dof = q.float(), do.float()
    scale = 1.0 / (hd ** 0.5)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)           # (B, H, Sq)
    s = torch.einsum("bqhd,bshd->bhqs", qf, kt) * scale
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqs,bqhd->bshd", p, dof)
    dp = torch.einsum("bqhd,bshd->bhqs", dof, vt)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqs,bshd->bqhd", ds, kt) * scale
    dk = torch.einsum("bhqs,bqhd->bshd", ds, qf) * scale
    # tiled head r * KV + j reads KV head j
    fold = lambda t: t.reshape(b, sk, h // n_kv, n_kv, hd).sum(2)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def _check_heads(h: int, k: torch.Tensor, v: torch.Tensor) -> None:
    kv = k.shape[2]
    if kv == 0 or h % kv or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"share a KV head count that divides the {h} q "
                         f"heads")


def _check_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int) -> None:
    """Raise on what the kernels do not take."""
    b, sq, h, hd = q.shape
    if k.shape != (b, k.shape[1], k.shape[2], hd):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    _check_heads(h, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} is an absolute position, >= 0")


def _call(entry: str, *args, stream_of: torch.Tensor) -> None:
    """C entry ``entry`` on ``stream_of``'s current stream; raises on a
    CUDA error."""
    lib = _lib(entry)
    rc = getattr(lib, entry)(*args, _build.stream_of(stream_of))
    _build.check(lib, rc, entry)


def _forward(q, k, v, causal: bool, q_offset: int, with_lse: bool):
    """Kernel 13 on CUDA tensors: (out, lse or None)."""
    _check_launch(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _call("flash_attention_fwd", _build.ptr(q), _build.ptr(k), _build.ptr(v),
          _build.ptr(out), None if lse is None else _build.ptr(lse),
          b, h, n_kv, sq, sk, hd, int(q.dtype == torch.bfloat16),
          int(causal), int(q_offset), stream_of=out)
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Kernel 13 and its backward (13b) on the card, the plain versions on
    the CPU, with the same log-sum-exp plumbing on both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _on_card(q, k, v):
            out, lse = _forward(q, k, v, causal, q_offset, with_lse=True)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=q_offset,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd), H % KV == 0.  Returns
    (B, Sq, H, hd) in q's dtype.  CUDA tensors launch kernel 13; when q, k
    or v needs a gradient, the backward is kernel 13b there (the plain
    versions on CPU tensors)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset)
    if not _on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    return _forward(q, k, v, causal, q_offset, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` from its output ``o`` and
    log-sum-exp ``lse``; dk/dv at the KV heads.  CUDA tensors launch kernel
    13b (three launches: D = rowsum(dO·O), dK/dV, dQ; counted once); in
    bf16 the tensors must start on 16-byte boundaries (TMA), or the launch
    raises."""
    if not _on_card(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         q_offset=q_offset)
    _check_launch(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    if o.shape != q.shape or o.dtype != q.dtype or do.shape != q.shape \
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype}, dO "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} "
                         f"{lse.dtype} do not fit q {tuple(q.shape)} "
                         f"{q.dtype}")
    q, k, v, o, lse = (t.contiguous() for t in (q, k, v, o, lse))
    do = do.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _call("flash_attention_bwd", *(_build.ptr(t) for t in (
        q, k, v, o, do, lse, delta, dq, dk, dv)),
        b, h, n_kv, sq, sk, hd, int(q.dtype == torch.bfloat16), int(causal),
        int(q_offset), stream_of=dq)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# pointer arguments of each C entry, before its 9 ints and the stream
_N_PTRS = {"flash_attention_fwd": 5, "flash_attention_bwd": 10}


def _lib(entry: str) -> ctypes.CDLL:
    """The library built from ``csrc/<entry>.cu``, its entry typed."""
    lib = _build.library(entry)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * _N_PTRS[entry] + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
