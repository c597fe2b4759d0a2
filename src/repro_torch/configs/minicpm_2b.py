"""minicpm-2b [dense] — WSD schedule, llama-like [arXiv:2404.06395; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv=36, d_ff=5760,
    vocab=122753, head_dim=64,
    lr_schedule="wsd", tie_embeddings=True,
    drelu_k=1440,
)
