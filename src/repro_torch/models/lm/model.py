"""The LM for the dense (qwen3, minitron, minicpm), MoE (granite,
moonshot) and SSM (mamba2) families as an ``nn.Module``.

Port of ``repro/models/lm/model.py``.  The weights follow the reference's
template: stacked per-layer tensors (``layers.wq`` is (L, d, H, hd)),
stored in fp32 and cast to ``cfg.dtype`` where the reference casts them
(``_attn_args``, the FFN, expert and SSM projection weights).  The
functions take the parameter tree ``params`` (``lm.params()``: nested
dicts of the module's tensors) as the reference's pure functions do, so
the two packages compare call for call.  The layer scan is a Python loop
over the layer index; the MoE body carries (x, aux) from layer to layer.
``loss`` is the training objective (chunked CE + 0.01 aux); with
``cfg.remat`` each layer body is recomputed in the backward under
``cfg.remat_policy`` (:func:`_maybe_remat`).  The MoE FFN is the
reference's single-shard path (every expert on the device).  The hybrid
(zamba2), VLM and audio families wait (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import ffn as ffn_mod
from repro_torch.models.lm import mamba2 as m2
from repro_torch.models.lm.common import (PSpec, cross_entropy_chunked,
                                          init_params, pad_heads, pad_vocab,
                                          rms_norm)

Params = Dict[str, Any]

FAMILIES = ("dense", "moe", "ssm")


def layer_list(params: Params):
    """Every layer's slice at once (``unbind``: the backward stacks the
    layers' gradients once instead of one full-size buffer a layer)."""
    per_key = {k: v.unbind(0) for k, v in params["layers"].items()}
    return [{k: v[i] for k, v in per_key.items()}
            for i in range(len(next(iter(per_key.values()))))]


# the matrix products at the dispatcher (what einsum, matmul and @ become)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _policy(saved, ctx, op, *args, **kwargs):
    # grad mode: ops inside an autograd Function's forward (a plain
    # kernel version's full-range slices are aliases too) are not tags
    return (CheckpointPolicy.MUST_SAVE
            if op in saved and torch.is_grad_enabled()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, enable: bool, policy: str = "full"):
    """``fn`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``:
    ``full`` saves only the inputs; ``dots`` also every matrix product's
    output (``dots_saveable``; the attention kernel's own products stay
    inside its autograd Function); ``proj`` also the tensors tagged by
    ``common.tag_proj`` (q, k, v, the attention context and the FFN
    hidden: ``save_only_these_names("proj")``).  The recompute re-runs
    ``fn``; a saved op's output is taken from the first run.  No policy
    changes a number."""
    if not enable:
        return fn
    if policy not in ("full", "dots", "proj"):
        raise ValueError(f"remat policy {policy!r}: full, dots or proj")
    saved = {"dots": _DOTS, "proj": (torch.ops.aten.alias.default,)}.get(
        policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if saved is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              functools.partial(_policy, saved)))
    return run


class LM(nn.Module):
    """A config-specialised model: template + apply functions."""

    def __init__(self, cfg: ArchConfig, tp: int = 1, *, device="cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r}: the port has the dense, moe and "
                f"ssm LMs; the hybrid / vlm / audio families wait "
                f"(ROADMAP.md §1 item 6)")
        # "meta" builds the module's shapes without allocating them
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.cfg = cfg
        self.tp = tp
        if cfg.family == "ssm":
            self.h_pad, self.kv_pad = 0, 0
        else:
            self.h_pad, self.kv_pad = pad_heads(cfg.n_heads, cfg.n_kv, tp)
        self.v_pad = pad_vocab(cfg.vocab, tp)
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)
        self.template = self._build_template()
        for k, v in self.template.items():
            if isinstance(v, dict):
                self.add_module(k, nn.ParameterDict({
                    n: nn.Parameter(torch.empty(s.shape, device=dev))
                    for n, s in v.items()}))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.empty(v.shape, device=dev)))

    # ------------------------------------------------------------------
    # parameter templates
    # ------------------------------------------------------------------

    def _attn_tmpl(self, n: int) -> Dict[str, PSpec]:
        c, hd = self.cfg, self.cfg.hd
        t = {
            "wq": PSpec((n, c.d_model, self.h_pad, hd),
                        (None, "embed", "heads", None)),
            "wk": PSpec((n, c.d_model, self.kv_pad, hd),
                        (None, "embed", "kv_heads", None)),
            "wv": PSpec((n, c.d_model, self.kv_pad, hd),
                        (None, "embed", "kv_heads", None)),
            "wo": PSpec((n, self.h_pad, hd, c.d_model),
                        (None, "heads", None, "embed")),
        }
        if c.qk_norm:
            t["qk_q"] = PSpec((n, hd), (None, None), "ones")
            t["qk_k"] = PSpec((n, hd), (None, None), "ones")
        return t

    def _ffn_tmpl(self, n: int) -> Dict[str, PSpec]:
        c = self.cfg
        return {"w_gate": PSpec((n, c.d_model, c.d_ff), (None, "embed", "mlp")),
                "w_up": PSpec((n, c.d_model, c.d_ff), (None, "embed", "mlp")),
                "w_down": PSpec((n, c.d_ff, c.d_model), (None, "mlp", "embed"))}

    def _moe_tmpl(self, n: int) -> Dict[str, PSpec]:
        c = self.cfg
        return {
            "router": PSpec((n, c.d_model, c.n_experts), (None, "embed", None)),
            "w_gate": PSpec((n, c.n_experts, c.d_model, c.d_ff),
                            (None, "experts", "embed", None)),
            "w_up": PSpec((n, c.n_experts, c.d_model, c.d_ff),
                          (None, "experts", "embed", None)),
            "w_down": PSpec((n, c.n_experts, c.d_ff, c.d_model),
                            (None, "experts", None, "embed")),
        }

    def _ssm_tmpl(self, n: int) -> Dict[str, PSpec]:
        c = self.cfg
        d, di = c.d_model, c.ssm_expand * c.d_model
        nst, h = c.ssm_state, (c.ssm_expand * c.d_model) // c.ssm_head_dim
        k = m2.CONV_K
        return {
            "z_proj": PSpec((n, d, di), (None, "embed", "mlp")),
            "x_proj": PSpec((n, d, di), (None, "embed", "mlp")),
            "b_proj": PSpec((n, d, nst), (None, "embed", None)),
            "c_proj": PSpec((n, d, nst), (None, "embed", None)),
            "dt_proj": PSpec((n, d, h), (None, "embed", "ssm_heads")),
            "dt_bias": PSpec((n, h), (None, "ssm_heads"), "zeros"),
            "conv_x_w": PSpec((n, k, di), (None, None, "mlp"), "normal", 0.1),
            "conv_x_b": PSpec((n, di), (None, "mlp"), "zeros"),
            "conv_b_w": PSpec((n, k, nst), (None, None, None), "normal", 0.1),
            "conv_b_b": PSpec((n, nst), (None, None), "zeros"),
            "conv_c_w": PSpec((n, k, nst), (None, None, None), "normal", 0.1),
            "conv_c_b": PSpec((n, nst), (None, None), "zeros"),
            "a_log": PSpec((n, h), (None, "ssm_heads"), "zeros"),
            "d_skip": PSpec((n, h), (None, "ssm_heads"), "ones"),
            "ssd_norm": PSpec((n, di), (None, "mlp"), "ones"),
            "out_proj": PSpec((n, di, d), (None, "mlp", "embed")),
        }

    def _norms(self, n: int, names) -> Dict[str, PSpec]:
        return {k: PSpec((n, self.cfg.d_model), (None, None), "ones")
                for k in names}

    def _build_template(self) -> Params:
        c = self.cfg
        t: Params = {
            "embed": PSpec((self.v_pad, c.d_model), ("vocab", "embed")),
            "final_norm": PSpec((c.d_model,), (None,), "ones"),
        }
        if not c.tie_embeddings:
            t["out_w"] = PSpec((c.d_model, self.v_pad), ("embed", "vocab"))
        if c.family == "dense":
            t["layers"] = {**self._attn_tmpl(c.n_layers),
                           **self._ffn_tmpl(c.n_layers),
                           **self._norms(c.n_layers, ("ln1", "ln2"))}
        elif c.family == "moe":
            t["layers"] = {**self._attn_tmpl(c.n_layers),
                           **self._moe_tmpl(c.n_layers),
                           **self._norms(c.n_layers, ("ln1", "ln2"))}
        else:
            t["layers"] = {**self._ssm_tmpl(c.n_layers),
                           **self._norms(c.n_layers, ("ln",))}
        return t

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def params(self) -> Params:
        """The parameter tree (the module's own tensors, not copies)."""
        return {k: dict(getattr(self, k).items()) if isinstance(v, dict)
                else getattr(self, k) for k, v in self.template.items()}

    def _load_tree(self, tree, leaf=lambda a: a) -> None:
        """Copy a parameter tree shaped like the template into the module."""
        state = {}
        for k, v in self.template.items():
            for n, a in (tree[k].items() if isinstance(v, dict)
                         else [(None, tree[k])]):
                state[k if n is None else f"{k}.{n}"] = leaf(a)
        self.load_state_dict(state)

    def init(self, generator: torch.Generator) -> Params:
        """Draw every weight as the template says from ``generator`` (a
        ``torch.Generator`` on the model's device) and return the tree."""
        self._load_tree(init_params(self.template, generator, self.device))
        return self.params()

    @classmethod
    def from_jax_params(cls, cfg: ArchConfig, params, *, device="cuda",
                        tp: int = 1) -> "LM":
        """A model holding the reference's parameter tree ``params`` (nested
        dicts whose leaves convert with ``np.asarray``)."""
        lm = cls(cfg, tp, device=device)
        lm._load_tree(params, lambda a: torch.from_numpy(
            np.array(a, np.float32)))
        return lm

    def _out_w(self, params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["out_w"])

    # ------------------------------------------------------------------
    # layer bodies
    # ------------------------------------------------------------------

    def _attn_args(self, lp, prefix=""):
        g = lambda k: lp[prefix + k].to(self.dtype)
        qn = lp.get(prefix + "qk_q")
        return dict(wq=g("wq"), wk=g("wk"), wv=g("wv"), wo=g("wo"),
                    qk_q=None if qn is None else lp[prefix + "qk_q"],
                    qk_k=None if qn is None else lp[prefix + "qk_k"],
                    n_kv=self.kv_pad, rope_theta=self.cfg.rope_theta)

    def _dense_body(self, x, lp, *, kv_out: bool = False):
        h = attn.attention_block(rms_norm(x, lp["ln1"]),
                                 return_kv=kv_out, **self._attn_args(lp))
        kv = None
        if kv_out:
            h, kv = h
        x = x + h
        f = ffn_mod.swiglu_ffn(rms_norm(x, lp["ln2"]),
                               lp["w_gate"].to(self.dtype),
                               lp["w_up"].to(self.dtype),
                               lp["w_down"].to(self.dtype),
                               drelu_k=self.cfg.drelu_k, drelu_groups=self.tp)
        x = x + f
        return (x, kv) if kv_out else x

    def _moe_body(self, xa, lp, *, kv_out: bool = False):
        x, aux = xa
        c = self.cfg
        h = attn.attention_block(rms_norm(x, lp["ln1"]),
                                 return_kv=kv_out, **self._attn_args(lp))
        kv = None
        if kv_out:
            h, kv = h
        x = x + h
        f, aux_l = ffn_mod.moe_ffn(rms_norm(x, lp["ln2"]), lp["router"],
                                   lp["w_gate"].to(self.dtype),
                                   lp["w_up"].to(self.dtype),
                                   lp["w_down"].to(self.dtype),
                                   n_experts=c.n_experts, top_k=c.top_k,
                                   capacity_factor=c.capacity_factor)
        x = x + f
        return ((x, aux + aux_l), kv) if kv_out else (x, aux + aux_l)

    def _ssm_body(self, x, lp):
        h, _ = m2.mamba2_block(rms_norm(x, lp["ln"]), lp, self.cfg)
        return x + h

    # ------------------------------------------------------------------
    # forward: tokens -> final hidden
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.dtype)

    def forward(self, params, tokens, extra: Optional[Dict] = None):
        """Returns (hidden (B,S,d), aux_loss scalar); each layer under
        remat when ``cfg.remat``."""
        c = self.cfg
        x = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if c.family == "moe":
            body = _maybe_remat(self._moe_body, c.remat, c.remat_policy)
            for lp in layer_list(params):
                x, aux = body((x, aux), lp)
        else:
            body = _maybe_remat(self._dense_body if c.family == "dense"
                                else self._ssm_body, c.remat,
                                c.remat_policy)
            for lp in layer_list(params):
                x = body(x, lp)
        return rms_norm(x, params["final_norm"]), aux

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------

    def loss(self, params, batch: Dict) -> torch.Tensor:
        """Mean next-token CE of ``batch["tokens"]`` against
        ``batch["targets"]`` (fp32 logits a 512-token chunk at a time) +
        0.01 x the aux loss."""
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "targets")}
        hidden, aux = self.forward(params, batch["tokens"], extra or None)
        ce = cross_entropy_chunked(hidden, self._out_w(params),
                                   batch["targets"], self.cfg.vocab)
        return ce + 0.01 * aux

    def logits_last(self, params, hidden_last):
        """hidden_last (B,1,d) -> (B,1,V_pad), an fp32 product."""
        return torch.einsum("bsd,dv->bsv", hidden_last.float(),
                            self._out_w(params).float())


def build_lm(cfg: ArchConfig, tp: int = 1, **kw) -> LM:
    return LM(cfg, tp, **kw)
