"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356].  input_specs() provides precomputed mel-frame embeddings
(B, enc_frames, d_model) per the spec contract."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120,
    vocab=51866, head_dim=64,
    enc_layers=32, enc_frames=1500,
    drelu_k=1280,
)
