"""Serving the dense LM: KV-cache template, prefill, and one-token decode.

Port of the dense branches of ``repro/models/lm/serve.py``.  The cache is
``{"k", "v"}`` of shape (L, B, S_max, KV, hd) in the model's dtype.
``prefill`` runs the prompt through every layer (its attention is kernel 13
on the card) and stacks the layers' K/V as the reference's scan does;
``decode_step`` writes each layer's new K/V into the cache in place and
attends in plain PyTorch.  Both run without autograd.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import ffn as ffn_mod
from repro_torch.models.lm.common import head_rms_norm, rms_norm, rope
from repro_torch.models.lm.model import LM, layer_list

CacheTmpl = Dict[str, Tuple[Tuple[int, ...], Tuple[Any, ...], Any]]


def cache_template(lm: LM, batch: int, s_max: int) -> CacheTmpl:
    """name -> (shape, logical axes, dtype)."""
    c = lm.cfg
    shape = (c.n_layers, batch, s_max, lm.kv_pad, c.hd)
    kv_axes = (None, "batch", "kv_seq", None, None)
    return {"k": (shape, kv_axes, lm.dtype), "v": (shape, kv_axes, lm.dtype)}


def cache_zeros(lm: LM, batch: int, s_max: int):
    return {k: torch.zeros(sh, dtype=d, device=lm.device)
            for k, (sh, ax, d) in cache_template(lm, batch, s_max).items()}


# ---------------------------------------------------------------------------
# decode-time sublayers
# ---------------------------------------------------------------------------

def _decode_attn(lm: LM, x, lp, kc, vc, pos, prefix=""):
    """x (B,1,d) -> (attn_out (B,1,d), kc, vc)."""
    dt = lm.dtype
    b = x.shape[0]
    q = torch.einsum("bsd,dhe->bshe", x, lp[prefix + "wq"].to(dt))
    nk = torch.einsum("bsd,dke->bske", x, lp[prefix + "wk"].to(dt))
    nv = torch.einsum("bsd,dke->bske", x, lp[prefix + "wv"].to(dt))
    if (prefix + "qk_q") in lp:
        q = head_rms_norm(q, lp[prefix + "qk_q"])
        nk = head_rms_norm(nk, lp[prefix + "qk_k"])
    if torch.is_tensor(pos) and pos.ndim == 1:
        positions = pos[:, None]                   # per-slot positions (B,1)
    else:
        positions = torch.full((b, 1), int(pos), device=x.device)
    q = rope(q, positions, lm.cfg.rope_theta)
    nk = rope(nk, positions, lm.cfg.rope_theta)
    ctx, kc, vc = attn.decode_attention(q, kc, vc, pos, nk.to(kc.dtype),
                                        nv.to(vc.dtype))
    out = torch.einsum("bshe,hed->bsd", ctx, lp[prefix + "wo"].to(dt))
    return out, kc, vc


def _decode_ffn(lm: LM, x, lp):
    c = lm.cfg
    w = [lp[n].to(lm.dtype) for n in ("w_gate", "w_up", "w_down")]
    if c.drelu_k:
        # D-ReLU structural sparsity: the down-projection gathers only the
        # k surviving rows of W_down (the DR-SpMM analogue)
        return ffn_mod.swiglu_ffn_decode_sparse(x, *w, c.drelu_k)
    return ffn_mod.swiglu_ffn(x, *w)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(lm: LM, params, tokens, extra: Optional[Dict] = None,
            s_max: Optional[int] = None):
    """Run the full prompt; returns (cache, last-token logits).

    The cache covers [0, s_max); tokens fill positions [0, S)."""
    b, s = tokens.shape
    s_max = s_max or s
    assert s_max == s, "prefill cache sized to prompt (pad prompt to s_max)"
    x = lm._embed(params, tokens)
    ks, vs = [], []
    for lp in layer_list(params):
        x, (k, v) = lm._dense_body(x, lp, kv_out=True)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    hidden = rms_norm(x, params["final_norm"])[:, -1:]
    return cache, lm.logits_last(params, hidden)


@torch.no_grad()
def decode_step(lm: LM, params, cache: Dict, token, pos):
    """One serve step: token (B,1) int, ``pos`` a scalar or a (B,) tensor.

    Writes the token's K/V into ``cache`` in place; returns
    (cache, logits (B,1,V_pad))."""
    x = lm._embed(params, token)
    for i, lp in enumerate(layer_list(params)):
        h, _, _ = _decode_attn(lm, rms_norm(x, lp["ln1"]), lp,
                               cache["k"][i], cache["v"][i], pos)
        x = x + h
        x = x + _decode_ffn(lm, rms_norm(x, lp["ln2"]), lp)
    hidden = rms_norm(x, params["final_norm"])
    return cache, lm.logits_last(params, hidden)
