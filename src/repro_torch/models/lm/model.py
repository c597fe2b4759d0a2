"""The LM for the dense family (qwen3, minitron, minicpm) as an ``nn.Module``.

Port of ``repro/models/lm/model.py``.  The weights follow the reference's
template: stacked per-layer tensors (``layers.wq`` is (L, d, H, hd)),
stored in fp32 and cast to ``cfg.dtype`` where the reference casts them
(``_attn_args``, the FFN weights).  The functions take the parameter tree
``params`` (``lm.params()``: nested dicts of the module's tensors) as the
reference's pure functions do, so the two packages compare call for call.
The layer scan is a Python loop over the layer index.  Other families, the
training loss and remat wait (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import ffn as ffn_mod
from repro_torch.models.lm.common import (PSpec, init_params, pad_heads,
                                          pad_vocab, rms_norm)

Params = Dict[str, Any]


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked per-layer weights."""
    return {k: v[i] for k, v in params["layers"].items()}


class LM(nn.Module):
    """A config-specialised model: template + apply functions."""

    def __init__(self, cfg: ArchConfig, tp: int = 1, *, device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port has the dense LM only; "
                f"the moe / ssm / hybrid / vlm / audio families wait "
                f"(ROADMAP.md §1 item 6)")
        # "meta" builds the module's shapes without allocating them
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.cfg = cfg
        self.tp = tp
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
        t["layers"] = {**self._attn_tmpl(c.n_layers),
                       **self._ffn_tmpl(c.n_layers),
                       **self._norms(c.n_layers, ("ln1", "ln2"))}
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

    # ------------------------------------------------------------------
    # forward: tokens -> final hidden
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.dtype)

    def forward(self, params, tokens, extra: Optional[Dict] = None):
        """Returns (hidden (B,S,d), aux_loss scalar).  On the card the
        attention kernel has no backward: call it under ``torch.no_grad()``
        there (training on the card raises)."""
        x = self._embed(params, tokens)
        for i in range(self.cfg.n_layers):
            x = self._dense_body(x, layer_params(params, i))
        return (rms_norm(x, params["final_norm"]),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def logits_last(self, params, hidden_last):
        """hidden_last (B,1,d) -> (B,1,V_pad), an fp32 product."""
        return torch.einsum("bsd,dv->bsv", hidden_last.float(),
                            self._out_w(params).float())


def build_lm(cfg: ArchConfig, tp: int = 1, **kw) -> LM:
    return LM(cfg, tp, **kw)
