"""jamba2-3b [hybrid] — Mamba-1 + attention 13:1, a dense SwiGLU in
every layer, one KV head, no positional encoding, the mixer's inner
RMSNorms [hf:ai21labs/AI21-Jamba2-3B config.json; arXiv:2403.19887].

A port-only arch: ``configs.get_arch`` finds it in ``PORT_ARCHS``, and
``ARCHS`` stays the reference's. The layer order is
``JambaConfig.layers_block_type``'s: attention where ``layer %
attn_layer_period == attn_layer_offset`` (14 and 7), so a period of 14
holds attention in slot 7; ``num_experts`` 1 makes every FFN dense
(``moe`` None). ``mamba_dt_rank`` 160 is the port's ``d_model // 16``.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="jamba2-3b", family="hybrid",
    n_layers=28, d_model=2560, n_heads=20, n_kv_heads=1, d_ff=8192,
    vocab=65536, head_dim=128, rope=False, tie_embeddings=True,
    norm_eps=1e-6,
    hybrid=HybridConfig(period=14, attn_index=7, d_state=16, d_conv=4,
                        expand=2, inner_norms=True),
    source="hf:ai21labs/AI21-Jamba2-3B; arXiv:2403.19887",
)
