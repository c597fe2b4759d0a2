"""Architecture + shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; the four
input-shape cells are :data:`SHAPES`.  ``--arch <id>`` in the launchers
resolves through :func:`get_config`.

The port's own copy of ``repro/configs/base.py`` (which imports no JAX):
the same fields, shapes and numbers, resolving ``repro_torch.configs.<id>``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | moe | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- hybrid (zamba2): one shared attention block every N ssm blocks ---
    attn_every: int = 0
    # --- vlm: cross-attention layer every N layers ---
    cross_every: int = 0
    n_img_tokens: int = 1600
    # --- audio (whisper): encoder-decoder ---
    enc_layers: int = 0
    enc_frames: int = 1500
    # --- paper technique: D-ReLU top-k on FFN hidden (0 = off) ---
    drelu_k: int = 0
    # --- training ---
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"     # full | dots (dots_saveable)
    grad_accum: int = 1            # microbatches per step (memory lever)
    lr_schedule: str = "cosine"    # minicpm uses "wsd"
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid: O(1)-state decode)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d

        if self.family == "ssm":
            return emb + L * self._ssm_params()
        if self.family == "moe":
            ffn = 3 * d * f * self.n_experts + d * self.n_experts  # router
        else:
            ffn = 3 * d * f
        per = attn + ffn + 2 * d                      # + norms

        if self.family == "hybrid":
            n_attn_app = L // max(self.attn_every, 1)
            per_ssm = self._ssm_params()
            shared = attn + 3 * d * f + 2 * d
            return emb + L * per_ssm + shared + n_attn_app * 0
        if self.family == "vlm":
            n_cross = L // max(self.cross_every, 1)
            n_self = L - n_cross
            cross = attn + 3 * d * f + 2 * d
            return emb + n_self * per + n_cross * cross
        if self.family == "audio":
            enc = self.enc_layers * per
            return emb + enc + L * per
        return emb + L * per

    def _ssm_params(self) -> int:
        d = self.d_model
        di = self.ssm_expand * d
        n = self.ssm_state
        nh = di // self.ssm_head_dim
        # in_proj -> (x, z, B, C, dt) ; out_proj
        return d * (2 * di + 2 * n + nh) + di * d + nh + di

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv
        emb = self.vocab * d * 2
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        ffn_active = 3 * d * f * self.top_k + d * self.n_experts
        return emb + L * (attn + ffn_active + 2 * d)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "qwen3-1.7b", "minitron-4b", "minicpm-2b", "qwen3-0.6b", "mamba2-1.3b",
    "llama-3.2-vision-90b", "moonshot-v1-16b-a3b", "granite-moe-1b-a400m",
    "whisper-large-v3", "zamba2-1.2b",
)


def list_archs() -> Tuple[str, ...]:
    return ARCH_IDS


def get_config(name: str, **overrides) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    cfg: ArchConfig = mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (per-arch smoke contract)."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv=min(max(cfg.n_kv * 4 // max(cfg.n_heads, 1), 1), 4),
        d_ff=256 if cfg.family != "moe" else 64,
        head_dim=32,
        vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        cross_every=min(cfg.cross_every, 2) if cfg.cross_every else 0,
        n_img_tokens=8 if cfg.family == "vlm" else cfg.n_img_tokens,
        enc_layers=min(cfg.enc_layers, 2) if cfg.enc_layers else 0,
        enc_frames=16 if cfg.family == "audio" else cfg.enc_frames,
        drelu_k=min(cfg.drelu_k, 32) if cfg.drelu_k else 0,
        dtype="float32",
    )
