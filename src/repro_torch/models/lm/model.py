"""The LM for the dense (qwen3, minitron, minicpm), MoE (granite,
moonshot), SSM (mamba2), hybrid (zamba2), VLM (llama-3.2-vision) and
audio (whisper) families as an ``nn.Module``.

Port of ``repro/models/lm/model.py``.  The weights follow the reference's
template: stacked per-layer tensors (``layers.wq`` is (L, d, H, hd)),
stored in fp32 and cast to ``cfg.dtype`` where the reference casts them
(``_attn_args``, the FFN, expert and SSM projection weights).  The
functions take the parameter tree ``params`` (``lm.params()``: nested
dicts of the module's tensors) as the reference's pure functions do, so
the two packages compare call for call.  The layer scan is a Python loop
over the layer index; the MoE body carries (x, aux) from layer to layer.
The hybrid runs the shared attention block (one set of weights, a leading
dim of 1) before each group of ``attn_every`` SSM layers, and once more
before a tail of ``n_layers % attn_every``; the VLM runs groups of
``self_per_group`` dense layers, each followed by one cross-attention
layer over the image tokens whose two residual branches are scaled by
``tanh`` of their gates; the audio family is whisper's encoder (non-causal
self-attention over the frames, GELU FFN) and decoder (causal
self-attention, cross-attention over the encoder's output with the
``x_``-prefixed weights, GELU FFN).  ``jax.nn.gelu`` is the tanh
approximation, and so is the port's.
``loss`` is the training objective (chunked CE + 0.01 aux); with
``cfg.remat`` each layer body is recomputed in the backward under
``cfg.remat_policy`` (:func:`_maybe_remat`).  The MoE FFN is the
reference's single-shard path (every expert on the device).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
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

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

# the template's zero leaves whose zeros close a branch: the VLM's cross
# gates (tanh(0) = 0) and the GELU FFN's biases; the scale of each when
# ``draw_zero_inits`` draws them
ZERO_INITS = {"gate_attn": 1.0, "gate_ffn": 1.0, "b1": 0.1, "b2": 0.1}


def extra_input(cfg) -> Optional[tuple]:
    """(batch key, memory length) of ``cfg``'s extra input, one (length,
    d_model) memory a sequence: the VLM's ``image_emb`` over its image
    tokens, the audio family's ``frames``; None for the other families."""
    return {"vlm": ("image_emb", cfg.n_img_tokens),
            "audio": ("frames", cfg.enc_frames)}.get(cfg.family)


@torch.no_grad()
def draw_zero_inits(params: Params, generator: torch.Generator) -> None:
    """Draw the ``ZERO_INITS`` leaves of a parameter tree in place, N(0, 1)
    x their scale from ``generator`` (on the leaves' device), in sorted
    order: a check from freshly initialised weights would otherwise leave
    the branches they close untested."""
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            draw_zero_inits(v, generator)
        elif k in ZERO_INITS:
            v.copy_(torch.randn(v.shape, generator=generator,
                                device=v.device) * ZERO_INITS[k])


def layer_list(params: Params, key: str = "layers"):
    """Every layer's slice of the stack ``params[key]`` at once (``unbind``:
    the backward stacks the layers' gradients once instead of one
    full-size buffer a layer)."""
    per_key = {k: v.unbind(0) for k, v in params[key].items()}
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
            raise ValueError(cfg.family)
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

    def _attn_tmpl(self, n: int, cross: bool = False) -> Dict[str, PSpec]:
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
        if c.qk_norm and not cross:
            t["qk_q"] = PSpec((n, hd), (None, None), "ones")
            t["qk_k"] = PSpec((n, hd), (None, None), "ones")
        return t

    def _ffn_tmpl(self, n: int, gelu: bool = False) -> Dict[str, PSpec]:
        c = self.cfg
        if gelu:
            return {"w1": PSpec((n, c.d_model, c.d_ff), (None, "embed", "mlp")),
                    "b1": PSpec((n, c.d_ff), (None, "mlp"), "zeros"),
                    "w2": PSpec((n, c.d_ff, c.d_model), (None, "mlp", "embed")),
                    "b2": PSpec((n, c.d_model), (None, None), "zeros")}
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
        elif c.family == "ssm":
            t["layers"] = {**self._ssm_tmpl(c.n_layers),
                           **self._norms(c.n_layers, ("ln",))}
        elif c.family == "hybrid":
            t["layers"] = {**self._ssm_tmpl(c.n_layers),
                           **self._norms(c.n_layers, ("ln",))}
            t["shared"] = {**self._attn_tmpl(1), **self._ffn_tmpl(1),
                           **self._norms(1, ("ln1", "ln2"))}
        elif c.family == "vlm":
            n_cross = c.n_layers // c.cross_every
            n_self = c.n_layers - n_cross
            self.n_groups = n_cross
            self.self_per_group = n_self // n_cross
            t["layers"] = {**self._attn_tmpl(n_self),
                           **self._ffn_tmpl(n_self),
                           **self._norms(n_self, ("ln1", "ln2"))}
            cross = {**self._attn_tmpl(n_cross, cross=True),
                     **self._ffn_tmpl(n_cross),
                     **self._norms(n_cross, ("ln1", "ln2"))}
            cross["gate_attn"] = PSpec((n_cross,), (None,), "zeros")
            cross["gate_ffn"] = PSpec((n_cross,), (None,), "zeros")
            t["cross"] = cross
        else:                                   # audio
            t["enc_layers"] = {**self._attn_tmpl(c.enc_layers),
                               **self._ffn_tmpl(c.enc_layers, gelu=True),
                               **self._norms(c.enc_layers, ("ln1", "ln2"))}
            t["enc_norm"] = PSpec((c.d_model,), (None,), "ones")
            dec = {**self._attn_tmpl(c.n_layers),
                   **self._ffn_tmpl(c.n_layers, gelu=True),
                   **self._norms(c.n_layers, ("ln1", "ln2", "ln_x"))}
            for k, v in self._attn_tmpl(c.n_layers, cross=True).items():
                dec["x_" + k] = v
            t["layers"] = dec
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

    def _gelu_ffn(self, x, lp, prefix=""):
        """whisper's FFN: GELU (the tanh approximation, ``jax.nn.gelu``'s
        default) between two biased projections."""
        g = lambda k: lp[prefix + k].to(self.dtype)
        h = F.gelu(torch.einsum("bsd,df->bsf", x, g("w1")) + g("b1"),
                   approximate="tanh")
        return torch.einsum("bsf,fd->bsd", h, g("w2")) + g("b2")

    # ------------------------------------------------------------------
    # forward: tokens -> final hidden
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.dtype)

    def forward(self, params, tokens, extra: Optional[Dict] = None):
        """Returns (hidden (B,S,d), aux_loss scalar); each layer under
        remat when ``cfg.remat``.  The VLM reads ``extra["image_emb"]``
        (B, n_img_tokens, d) and the audio family ``extra["frames"]`` (B,
        enc_frames, d), both cast to the model's dtype."""
        c = self.cfg
        x = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if c.family == "moe":
            body = _maybe_remat(self._moe_body, c.remat, c.remat_policy)
            for lp in layer_list(params):
                x, aux = body((x, aux), lp)
        elif c.family in ("dense", "ssm"):
            body = _maybe_remat(self._dense_body if c.family == "dense"
                                else self._ssm_body, c.remat,
                                c.remat_policy)
            for lp in layer_list(params):
                x = body(x, lp)
        elif c.family == "hybrid":
            x = self._hybrid_forward(params, x)
        elif c.family == "vlm":
            x = self._vlm_forward(params, x, extra["image_emb"])
        else:
            x = self._audio_forward(params, x, extra["frames"])
        return rms_norm(x, params["final_norm"]), aux

    # --- hybrid: the shared attention block every attn_every ssm layers --

    def _shared_block(self, params, x, *, kv_out: bool = False):
        """The one shared dense block (attention + SwiGLU FFN with D-ReLU);
        with ``kv_out`` also its (k, v) (the prefill's cache)."""
        sp = {k: v[0] for k, v in params["shared"].items()}
        return self._dense_body(x, sp, kv_out=kv_out)

    def _hybrid_split(self, layers):
        """(groups: a list of ``attn_every`` layer slices a group, the tail's
        slices, n_groups, n_tail) of the SSM stack ``layers``."""
        c = self.cfg
        lps = layer_list({"layers": layers})
        n_groups = c.n_layers // c.attn_every
        n_full = n_groups * c.attn_every
        head = [lps[g * c.attn_every:(g + 1) * c.attn_every]
                for g in range(n_groups)]
        return head, lps[n_full:], n_groups, c.n_layers - n_full

    def _hybrid_forward(self, params, x):
        """The shared block before each group of ``attn_every`` SSM layers
        and, when ``n_layers % attn_every``, once more before the tail
        (zamba2: 6 groups + a tail of 2, 7 applications).  As in the
        reference, the SSM layers run under remat and the shared block
        outside it."""
        c = self.cfg
        head, tail, _, n_tail = self._hybrid_split(params["layers"])
        ssm_body = _maybe_remat(self._ssm_body, c.remat, c.remat_policy)
        for group in head + ([tail] if n_tail else []):
            x = self._shared_block(params, x)
            for lp in group:
                x = ssm_body(x, lp)
        return x

    # --- vlm: groups of self layers + one gated cross-attention ---------

    def _cross_body(self, x, lp, img):
        """Cross-attention over the image tokens (no RoPE, no mask) and a
        SwiGLU FFN, each residual branch scaled by tanh of its gate."""
        h = attn.attention_block(rms_norm(x, lp["ln1"]), kv_x=img,
                                 causal=False, **self._attn_args(lp))
        x = x + torch.tanh(lp["gate_attn"]).to(x.dtype) * h
        f = ffn_mod.swiglu_ffn(rms_norm(x, lp["ln2"]),
                               lp["w_gate"].to(self.dtype),
                               lp["w_up"].to(self.dtype),
                               lp["w_down"].to(self.dtype),
                               drelu_k=self.cfg.drelu_k, drelu_groups=self.tp)
        return x + torch.tanh(lp["gate_ffn"]).to(x.dtype) * f

    def _vlm_forward(self, params, x, img):
        c = self.cfg
        img = img.to(self.dtype)
        self_body = _maybe_remat(self._dense_body, c.remat, c.remat_policy)
        cross_body = _maybe_remat(lambda x_, lp: self._cross_body(x_, lp, img),
                                  c.remat, c.remat_policy)
        selfs, k = layer_list(params), self.self_per_group
        for g, clp in enumerate(layer_list(params, "cross")):
            for lp in selfs[g * k:(g + 1) * k]:
                x = self_body(x, lp)
            x = cross_body(x, clp)
        return x

    # --- audio: whisper encoder-decoder ---------------------------------

    def _enc_body(self, x, lp):
        h = attn.attention_block(rms_norm(x, lp["ln1"]), causal=False,
                                 **self._attn_args(lp))
        x = x + h
        return x + self._gelu_ffn(rms_norm(x, lp["ln2"]), lp)

    def _dec_body(self, x, lp, enc_out, *, kv_out: bool = False):
        """Causal self-attention, cross-attention over ``enc_out`` (the
        ``x_`` weights, after ``ln_x``), GELU FFN; with ``kv_out`` also
        ((k, v), (xk, xv)) for the prefill's cache."""
        h = attn.attention_block(rms_norm(x, lp["ln1"]), return_kv=kv_out,
                                 **self._attn_args(lp))
        kv = None
        if kv_out:
            h, kv = h
        x = x + h
        hx = attn.attention_block(rms_norm(x, lp["ln_x"]), kv_x=enc_out,
                                  causal=False, return_kv=kv_out,
                                  **self._attn_args(lp, prefix="x_"))
        xkv = None
        if kv_out:
            hx, xkv = hx
        x = x + hx
        x = x + self._gelu_ffn(rms_norm(x, lp["ln2"]), lp)
        return (x, (kv, xkv)) if kv_out else x

    def encode_audio(self, params, frames):
        """frames (B, F, d): precomputed mel-frame embeddings (the
        convolutional front end is a stub, as in the reference)."""
        c = self.cfg
        x = frames.to(self.dtype)
        body = _maybe_remat(self._enc_body, c.remat, c.remat_policy)
        for lp in layer_list(params, "enc_layers"):
            x = body(x, lp)
        return rms_norm(x, params["enc_norm"])

    def _audio_forward(self, params, x, frames):
        c = self.cfg
        enc_out = self.encode_audio(params, frames)
        body = _maybe_remat(lambda x_, lp: self._dec_body(x_, lp, enc_out),
                            c.remat, c.remat_policy)
        for lp in layer_list(params):
            x = body(x, lp)
        return x

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
