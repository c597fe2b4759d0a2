"""Shared LM building blocks: parameter templates, norms, RoPE.

Port of ``repro/models/lm/common.py``.  Each model family declares its
weights once as a nested dict of :class:`PSpec` (shape + logical axes +
init); real parameters are derived from the template.  The numerics follow
the reference cast for cast: norms in fp32 cast back to the input dtype and
then scaled by ``gamma`` in that dtype, RoPE angles in fp32.
``cross_entropy_chunked`` is the training loss; :func:`tag_proj` marks the
tensors that the ``proj`` remat policy keeps.  The sharding helpers are
not ported (one device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical name per dim
    init: str = "normal"                      # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Template = Dict[str, Any]   # nested dicts of PSpec


def _map_template(template: Template, fn):
    out = {}
    for k, v in template.items():
        out[k] = _map_template(v, fn) if isinstance(v, dict) else fn(k, v)
    return out


def init_params(template: Template, generator: torch.Generator,
                device, dtype=torch.float32):
    """Real parameters for ``template`` on ``device`` (normal: N(0, 1) x
    scale, drawn from ``generator``, which lives on ``device``, in template
    order).  The numbers differ from the reference's ``jax.random`` ones;
    parity tests carry weights across."""
    def mk(_, spec: PSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        return (torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
                * spec.scale).to(dtype)

    return _map_template(template, mk)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def head_rms_norm(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head_dim of (..., H, hd) tensors (qwen3)."""
    return rms_norm(x, gamma, eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e6) -> torch.Tensor:
    """Rotary embedding for (..., S, H, hd); ``positions`` is (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     -1).to(x.dtype)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_heads(n_heads: int, n_kv: int, tp: int) -> Tuple[int, int]:
    """Zero-padded head counts so the flat q-head axis divides by ``tp``.

    Padded q heads have zero in/out weights (inert); kv is padded only when
    needed for the tile mapping (h_pad % kv == 0).  Returns (h_pad, kv_pad).
    """
    if tp <= 1 or n_heads % tp == 0:
        return n_heads, n_kv
    h_pad = round_up(n_heads, tp)
    if h_pad % n_kv == 0:
        return h_pad, n_kv
    if n_kv == n_heads:                       # MHA: pad kv alongside q
        return h_pad, h_pad
    kv_pad = n_kv
    while h_pad % kv_pad != 0:
        kv_pad += 1
    return h_pad, kv_pad


def pad_vocab(vocab: int, tp: int) -> int:
    """Vocab padded for TP sharding; pad logits are masked in the loss."""
    if tp <= 1:
        return vocab
    m = 256 * tp
    return round_up(vocab, m) if vocab % tp else vocab


def tag_proj(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``checkpoint_name(x, "proj")``: under autograd an
    ``aten.alias`` view of ``x`` (no copy, no number changed), which the
    ``proj`` remat policy (``model._maybe_remat``) saves and every other
    policy recomputes; without autograd ``x`` itself."""
    return torch.ops.aten.alias(x) if torch.is_grad_enabled() else x


def _ce_chunk_sum(xc: torch.Tensor, out_w: torch.Tensor, tc: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Sum over one chunk's tokens of logsumexp(logits) - logits[target],
    fp32 logits, padded vocab columns at -1e30."""
    logits = xc.float() @ out_w.float()
    if out_w.shape[-1] > vocab:
        pad = torch.arange(out_w.shape[-1], device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def cross_entropy_chunked(x_final: torch.Tensor, out_w: torch.Tensor,
                          targets: torch.Tensor, vocab: int,
                          chunk: int = 512) -> torch.Tensor:
    """Next-token CE in sequence chunks, so no more than one chunk's
    (B, chunk, V) fp32 logits are live: under autograd each chunk is
    recomputed in the backward (non-reentrant checkpoint), as the
    reference's ``jax.checkpoint`` of its scan body.  ``out_w`` is
    (d, V_padded); ids >= ``vocab`` never occur in ``targets``.  The
    chunk sums add up in order, then divide by B * S."""
    b, s, _ = x_final.shape
    n_chunks = max(s // chunk, 1)
    chunk = s // n_chunks
    if n_chunks * chunk != s:
        raise ValueError(f"sequence {s} does not split into {n_chunks} "
                         f"chunks of {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x_final.device)
    for c in range(n_chunks):
        xc = x_final[:, c * chunk:(c + 1) * chunk]
        tc = targets[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk_sum, xc, out_w, tc, vocab,
                              use_reentrant=False)
        else:
            part = _ce_chunk_sum(xc, out_w, tc, vocab)
        total = total + part
    return total / (b * s)
