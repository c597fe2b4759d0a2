"""Serving the dense, MoE and SSM LMs: cache templates, prefill, and
one-token decode.

Port of the dense, moe and ssm branches of ``repro/models/lm/serve.py``
(the hybrid, VLM and audio families wait, ROADMAP.md §1 item 6).  The
dense and MoE cache is ``{"k", "v"}`` of shape (L, B, S_max, KV, hd) in
the model's dtype; the SSM cache is each layer's fp32 state (L, B, H, P, N)
and its last CONV_K-1 raw conv inputs (``conv_x`` / ``conv_b`` /
``conv_c``, the model's dtype).  ``prefill`` runs the prompt through every
layer (attention is kernel 13 on the card; the MoE FFN caps over the
prompt's B*S tokens) and stacks the layers' caches as the reference's scan
does; ``decode_step`` writes each layer's new K/V, or its new state and
conv window, into the cache in place (the MoE FFN caps over the step's B
tokens, so a decode does not reproduce a prefill's logits; an SSM step
ignores ``pos``).  Both run without autograd.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import ffn as ffn_mod
from repro_torch.models.lm import mamba2 as m2
from repro_torch.models.lm.common import head_rms_norm, rms_norm, rope
from repro_torch.models.lm.model import LM, layer_list

CacheTmpl = Dict[str, Tuple[Tuple[int, ...], Tuple[Any, ...], Any]]


def cache_template(lm: LM, batch: int, s_max: int) -> CacheTmpl:
    """name -> (shape, logical axes, dtype)."""
    c = lm.cfg
    if c.family == "ssm":
        return _ssm_cache_tmpl(c, c.n_layers, batch, lm.dtype)
    shape = (c.n_layers, batch, s_max, lm.kv_pad, c.hd)
    kv_axes = (None, "batch", "kv_seq", None, None)
    return {"k": (shape, kv_axes, lm.dtype), "v": (shape, kv_axes, lm.dtype)}


def _ssm_cache_tmpl(c, n_layers, batch, dt):
    di = c.ssm_expand * c.d_model
    n = c.ssm_state
    h = di // c.ssm_head_dim
    k = m2.CONV_K - 1
    return {
        "state": ((n_layers, batch, h, c.ssm_head_dim, n),
                  (None, "batch", "ssm_heads", None, None), torch.float32),
        "conv_x": ((n_layers, batch, k, di), (None, "batch", None, "mlp"), dt),
        "conv_b": ((n_layers, batch, k, n), (None, "batch", None, None), dt),
        "conv_c": ((n_layers, batch, k, n), (None, "batch", None, None), dt),
    }


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
    if c.family == "moe":
        y, _ = ffn_mod.moe_ffn(x, lp["router"], *w, n_experts=c.n_experts,
                               top_k=c.top_k,
                               capacity_factor=c.capacity_factor)
        return y
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
    c = lm.cfg
    b, s = tokens.shape
    s_max = s_max or s
    assert s_max == s, "prefill cache sized to prompt (pad prompt to s_max)"
    x = lm._embed(params, tokens)
    if c.family == "ssm":
        caches = []
        for lp in layer_list(params):
            h, cch = m2.mamba2_block(rms_norm(x, lp["ln"]), lp, c,
                                     mode="prefill")
            x = x + h
            caches.append(cch)
        cache = {k: torch.stack([getattr(cc, k) for cc in caches])
                 for k in m2.SSMCache._fields}
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ks, vs = [], []
        for lp in layer_list(params):
            if c.family == "moe":
                (x, aux), (k, v) = lm._moe_body((x, aux), lp, kv_out=True)
            else:
                x, (k, v) = lm._dense_body(x, lp, kv_out=True)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    hidden = rms_norm(x, params["final_norm"])[:, -1:]
    return cache, lm.logits_last(params, hidden)


@torch.no_grad()
def decode_step(lm: LM, params, cache: Dict, token, pos):
    """One serve step: token (B,1) int, ``pos`` a scalar or a (B,) tensor.

    Writes the token's K/V (an SSM layer: its state and conv window) into
    ``cache`` in place; returns (cache, logits (B,1,V_pad))."""
    x = lm._embed(params, token)
    for i, lp in enumerate(layer_list(params)):
        if lm.cfg.family == "ssm":
            h, new = m2.mamba2_block(
                rms_norm(x, lp["ln"]), lp, lm.cfg, mode="decode",
                cache=m2.SSMCache(*(cache[k][i]
                                    for k in m2.SSMCache._fields)))
            for k in m2.SSMCache._fields:
                cache[k][i].copy_(getattr(new, k))
            x = x + h
            continue
        h, _, _ = _decode_attn(lm, rms_norm(x, lp["ln1"]), lp,
                               cache["k"][i], cache["v"][i], pos)
        x = x + h
        x = x + _decode_ffn(lm, rms_norm(x, lp["ln2"]), lp)
    hidden = rms_norm(x, params["final_norm"])
    return cache, lm.logits_last(params, hidden)
