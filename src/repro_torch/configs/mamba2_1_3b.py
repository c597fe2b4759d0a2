"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: the paper's DR-SpMM is inapplicable to the SSD core
(DESIGN.md §Arch-applicability); D-ReLU remains available on projections.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
