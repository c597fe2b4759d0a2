"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].  Vision frontend is a stub:
input_specs() provides precomputed patch embeddings (spec contract)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv=8, d_ff=28672,
    vocab=128256, head_dim=128,
    cross_every=5, n_img_tokens=1600,
    drelu_k=7168,
    # 90B × 1M tokens/step: 4 microbatches keep per-device activation
    # residency inside v5e HBM (EXPERIMENTS.md §Dry-run memory notes)
    grad_accum=4,
)
