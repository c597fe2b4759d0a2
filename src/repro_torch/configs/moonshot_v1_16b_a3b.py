"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].  The MoE router is the per-row dynamic
top-k of the paper generalized to the expert axis (DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
    vocab=163840, head_dim=128,
    n_experts=64, top_k=6,
)
