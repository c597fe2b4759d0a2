"""Causal (or full) softmax attention, single pass with an online softmax.

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
tensors run it, and the card's runs are held against it.  The kernel has
no backward: on CUDA tensors that need a gradient the wrapper raises.
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
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """Online softmax over kv tiles of ``BLOCK_K`` rows, every q row at
    once (the reference's ``_flash_inner`` for one q chunk).  k/v with KV <
    H heads are tiled first, head h from KV head h % KV."""
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
    return (acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
            ).to(q.dtype)


def _check_heads(h: int, k: torch.Tensor, v: torch.Tensor) -> None:
    kv = k.shape[2]
    if kv == 0 or h % kv or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"share a KV head count that divides the {h} q "
                         f"heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd), H % KV == 0.  Returns
    (B, Sq, H, hd) in q's dtype.  CUDA tensors launch kernel 13."""
    if not _on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention kernel has no backward: LM training on the "
            "card waits for ROADMAP.md §1 item 6 (chunked_attention's "
            "autograd); run it under torch.no_grad() or on the CPU")
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, n_kv, hd):
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.flash_attention_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        b, h, n_kv, sq, sk, hd, int(q.dtype == torch.bfloat16), int(causal),
        int(q_offset), _build.stream_of(out))
    _build.check(lib, rc, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
