"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=192,
    xlstm=XLSTMConfig(slstm_at=(1, 3, 5, 7, 9, 11)),
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)
