"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, HybridConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, moe_every=2),
    hybrid=HybridConfig(period=8, attn_index=4, d_state=16, d_conv=4,
                        expand=2),
    source="arXiv:2403.19887; hf",
)
