"""Serving every LM family: cache templates, prefill, and one-token
decode.

Port of ``repro/models/lm/serve.py``.  The dense and MoE cache is
``{"k", "v"}`` of shape (L, B, S_max, KV, hd) in the model's dtype; the SSM
cache is each layer's fp32 state (L, B, H, P, N) and its last CONV_K-1 raw
conv inputs (``conv_x`` / ``conv_b`` / ``conv_c``, the model's dtype).
The hybrid's is the SSM cache plus ``sk`` / ``sv`` (n_app, B, S_max, KV,
hd), one entry for each application of the shared block, ceil(n_layers /
attn_every).  The VLM's self-attention cache is (groups, self_per_group,
B, S_max, KV, hd) and its cross cache ``xk`` / ``xv`` (groups, B,
n_img_tokens, KV, hd); the audio family's is ``k`` / ``v`` and ``xk`` /
``xv`` (L, B, enc_frames, KV, hd).  ``prefill`` runs the prompt through
every layer (attention is kernel 13 on the card; the MoE FFN caps over
the prompt's B*S tokens) and stacks the layers' caches as the reference's
scan does; the VLM and audio branches write ``xk`` / ``xv`` once, from
``extra["image_emb"]`` / the encoder's output of ``extra["frames"]``.
``decode_step`` writes each layer's new K/V, or its new state and conv
window, into the cache in place and attends to the cross caches as they
are (``_decode_cross``); the MoE FFN caps over the step's B tokens, so a
decode does not reproduce a prefill's logits; an SSM step ignores
``pos``.  Both run without autograd.
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
    kv, hd, dt = lm.kv_pad, c.hd, lm.dtype
    kv_axes = (None, "batch", "kv_seq", None, None)
    if c.family in ("dense", "moe"):
        shape = (c.n_layers, batch, s_max, kv, hd)
        return {"k": (shape, kv_axes, dt), "v": (shape, kv_axes, dt)}
    if c.family == "ssm":
        return _ssm_cache_tmpl(c, c.n_layers, batch, dt)
    if c.family == "hybrid":
        t = _ssm_cache_tmpl(c, c.n_layers, batch, dt)
        n_app = -(-c.n_layers // c.attn_every)       # ceil: one per group
        shape = (n_app, batch, s_max, kv, hd)
        t["sk"] = (shape, kv_axes, dt)
        t["sv"] = (shape, kv_axes, dt)
        return t
    x_axes = (None, "batch", None, None, None)
    if c.family == "vlm":
        g, spg = lm.n_groups, lm.self_per_group
        self_shape = (g, spg, batch, s_max, kv, hd)
        self_axes = (None, None, "batch", "kv_seq", None, None)
        x_shape = (g, batch, c.n_img_tokens, kv, hd)
        return {"k": (self_shape, self_axes, dt),
                "v": (self_shape, self_axes, dt),
                "xk": (x_shape, x_axes, dt), "xv": (x_shape, x_axes, dt)}
    shape = (c.n_layers, batch, s_max, kv, hd)               # audio
    x_shape = (c.n_layers, batch, c.enc_frames, kv, hd)
    return {"k": (shape, kv_axes, dt), "v": (shape, kv_axes, dt),
            "xk": (x_shape, x_axes, dt), "xv": (x_shape, x_axes, dt)}


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


def _decode_cross(lm: LM, x, lp, xk, xv, prefix="x_"):
    """Cross-attention of x (B,1,d) against a cached memory (every entry
    valid)."""
    dt = lm.dtype
    q = torch.einsum("bsd,dhe->bshe", x, lp[prefix + "wq"].to(dt))
    ctx = attn._local_decode(q, xk, xv, xk.shape[1] - 1, 0)
    return torch.einsum("bshe,hed->bsd", ctx, lp[prefix + "wo"].to(dt))


def _decode_ffn(lm: LM, x, lp):
    c = lm.cfg
    if c.family == "audio":
        return lm._gelu_ffn(x, lp)
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

    The cache covers [0, s_max); tokens fill positions [0, S).  The VLM
    takes ``extra["image_emb"]`` (B, n_img_tokens, d), the audio family
    ``extra["frames"]`` (B, enc_frames, d)."""
    c = lm.cfg
    b, s = tokens.shape
    s_max = s_max or s
    assert s_max == s, "prefill cache sized to prompt (pad prompt to s_max)"
    x = lm._embed(params, tokens)
    if c.family == "ssm":
        caches = []
        for lp in layer_list(params):
            x, cch = _ssm_prefill(lm, x, lp)
            caches.append(cch)
        cache = _stack_ssm(caches)
    elif c.family == "hybrid":
        x, cache = _hybrid_prefill_body(lm, params, x)
    elif c.family == "vlm":
        img = extra["image_emb"].to(lm.dtype)
        selfs, spg = layer_list(params), lm.self_per_group
        ks, vs, xks, xvs = [], [], [], []
        for g, clp in enumerate(layer_list(params, "cross")):
            gk, gv = [], []
            for lp in selfs[g * spg:(g + 1) * spg]:
                x, (k, v) = lm._dense_body(x, lp, kv_out=True)
                gk.append(k)
                gv.append(v)
            ks.append(torch.stack(gk))
            vs.append(torch.stack(gv))
            xks.append(torch.einsum("bsd,dke->bske", img,
                                    clp["wk"].to(lm.dtype)))
            xvs.append(torch.einsum("bsd,dke->bske", img,
                                    clp["wv"].to(lm.dtype)))
            x = lm._cross_body(x, clp, img)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "xk": torch.stack(xks), "xv": torch.stack(xvs)}
    elif c.family == "audio":
        enc_out = lm.encode_audio(params, extra["frames"])
        kvs = []
        for lp in layer_list(params):
            x, ((k, v), (xk, xv)) = lm._dec_body(x, lp, enc_out, kv_out=True)
            kvs.append((k, v, xk, xv))
        cache = {n: torch.stack([t[i] for t in kvs])
                 for i, n in enumerate(("k", "v", "xk", "xv"))}
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


def _ssm_prefill(lm: LM, x, lp):
    h, cch = m2.mamba2_block(rms_norm(x, lp["ln"]), lp, lm.cfg,
                             mode="prefill")
    return x + h, cch


def _stack_ssm(caches):
    return {k: torch.stack([getattr(cc, k) for cc in caches])
            for k in m2.SSMCache._fields}


def _hybrid_prefill_body(lm: LM, params, x):
    """The hybrid's prefill: the shared block's k/v at each application,
    the SSM layers' caches in layer order."""
    head, tail, _, n_tail = lm._hybrid_split(params["layers"])
    caches, sks, svs = [], [], []
    for group in head + ([tail] if n_tail else []):
        x, (sk, sv) = lm._shared_block(params, x, kv_out=True)
        sks.append(sk)
        svs.append(sv)
        for lp in group:
            x, cch = _ssm_prefill(lm, x, lp)
            caches.append(cch)
    cache = _stack_ssm(caches)
    cache["sk"], cache["sv"] = torch.stack(sks), torch.stack(svs)
    return x, cache


@torch.no_grad()
def decode_step(lm: LM, params, cache: Dict, token, pos):
    """One serve step: token (B,1) int, ``pos`` a scalar or a (B,) tensor.

    Writes the token's K/V (an SSM layer: its state and conv window) into
    ``cache`` in place; returns (cache, logits (B,1,V_pad))."""
    c = lm.cfg
    x = lm._embed(params, token)
    if c.family == "ssm":
        for i, lp in enumerate(layer_list(params)):
            x = _ssm_decode(lm, x, lp, cache, i)
    elif c.family == "hybrid":
        x = _hybrid_decode_body(lm, params, cache, x, pos)
    elif c.family == "vlm":
        selfs, spg = layer_list(params), lm.self_per_group
        for g, clp in enumerate(layer_list(params, "cross")):
            for j, lp in enumerate(selfs[g * spg:(g + 1) * spg]):
                x = _dense_decode(lm, x, lp, cache["k"][g][j],
                                  cache["v"][g][j], pos)
            h = _decode_cross(lm, rms_norm(x, clp["ln1"]), clp,
                              cache["xk"][g], cache["xv"][g], prefix="")
            x = x + torch.tanh(clp["gate_attn"]).to(x.dtype) * h
            f = _decode_ffn(lm, rms_norm(x, clp["ln2"]), clp)
            x = x + torch.tanh(clp["gate_ffn"]).to(x.dtype) * f
    else:
        for i, lp in enumerate(layer_list(params)):
            h, _, _ = _decode_attn(lm, rms_norm(x, lp["ln1"]), lp,
                                   cache["k"][i], cache["v"][i], pos)
            x = x + h
            if c.family == "audio":
                x = x + _decode_cross(lm, rms_norm(x, lp["ln_x"]), lp,
                                      cache["xk"][i], cache["xv"][i])
            x = x + _decode_ffn(lm, rms_norm(x, lp["ln2"]), lp)
    hidden = rms_norm(x, params["final_norm"])
    return cache, lm.logits_last(params, hidden)


def _dense_decode(lm: LM, x, lp, kc, vc, pos):
    h, _, _ = _decode_attn(lm, rms_norm(x, lp["ln1"]), lp, kc, vc, pos)
    x = x + h
    return x + _decode_ffn(lm, rms_norm(x, lp["ln2"]), lp)


def _ssm_decode(lm: LM, x, lp, cache, i):
    """SSM layer ``i`` for one token; its state and conv window written
    into ``cache`` in place."""
    h, new = m2.mamba2_block(
        rms_norm(x, lp["ln"]), lp, lm.cfg, mode="decode",
        cache=m2.SSMCache(*(cache[k][i] for k in m2.SSMCache._fields)))
    for k in m2.SSMCache._fields:
        cache[k][i].copy_(getattr(new, k))
    return x + h


def _hybrid_decode_body(lm: LM, params, cache, x, pos):
    """The hybrid's decode: application a of the shared block attends to
    (and writes) ``sk[a]`` / ``sv[a]``; the SSM layers follow in order."""
    head, tail, _, n_tail = lm._hybrid_split(params["layers"])
    sp = {k: v[0] for k, v in params["shared"].items()}
    i = 0
    for a, group in enumerate(head + ([tail] if n_tail else [])):
        x = _dense_decode(lm, x, sp, cache["sk"][a], cache["sv"][a], pos)
        for lp in group:
            x = _ssm_decode(lm, x, lp, cache, i)
            i += 1
    return x
