"""llava-next-34b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128,
    frontend="vision", vision_patches=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
