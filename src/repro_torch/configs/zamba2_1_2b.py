"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].  DR-SpMM inapplicable to the SSM core (DESIGN.md
§Arch-applicability); D-ReLU applies in the shared block's FFN."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6,
    drelu_k=2048,
)
