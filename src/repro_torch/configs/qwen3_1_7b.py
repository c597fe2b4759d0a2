"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True,
    drelu_k=1536,  # paper technique: D-ReLU top-k on FFN hidden (d_ff/4)
)
