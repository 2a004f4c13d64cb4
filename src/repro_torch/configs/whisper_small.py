"""whisper-small [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, head_dim=64,
    encoder_decoder=True, n_encoder_layers=12, encoder_seq=1500,
    frontend="audio", tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
