"""Architecture + shape configuration system.

Every assigned architecture is described by an :class:`ArchConfig`. Configs are
exact copies of the published numbers (see per-arch modules in this package).
``reduced()`` returns a CPU-smoke-test-sized config of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int          # per-expert hidden dim
    moe_every: int = 1        # 1 = every layer is MoE, 2 = alternate dense/MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: one attention layer per ``period`` layers."""
    period: int = 8           # 1 attention : (period-1) mamba
    attn_index: int = 4       # which slot in the period is attention
    d_state: int = 16         # mamba SSM state dim
    d_conv: int = 4           # mamba conv kernel
    expand: int = 2           # mamba inner expansion
    # RMSNorms on the mixer's dt (dt_rank), B and C (d_state) after
    # x_proj, as Jamba's mixer has them (a port-only field)
    inner_norms: bool = False


@dataclass(frozen=True)
class XLSTMConfig:
    """sLSTM/mLSTM block pattern for xLSTM."""
    slstm_at: Tuple[int, ...] = (1, 3, 5, 7, 9, 11)  # sLSTM slots; rest mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv1d_kernel: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope: bool = True         # False: attention with no positional
                              # encoding, as Jamba's (a port-only field)
    # MoE / hybrid / xlstm sub-configs
    moe: Optional[MoEConfig] = None
    hybrid: Optional[HybridConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500   # whisper: 30s audio -> 1500 frames
    # modality frontend stub: None | 'audio' | 'vision'
    frontend: Optional[str] = None
    vision_patches: int = 2880   # llava-next anyres: max patch-embedding count
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    source: str = ""          # provenance tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attn_layers(self) -> int:
        """Number of attention layers (hybrid archs interleave)."""
        if self.hybrid is not None:
            return self.n_layers // self.hybrid.period
        return self.n_layers

    @property
    def subquadratic(self) -> bool:
        """True if the arch supports O(1)-state or mostly-recurrent decode,
        i.e. is eligible for the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops accounting)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        if self.qkv_bias:
            attn += (n_q + 2 * n_kv) * hd
        dense_ffn = 3 * d * self.d_ff  # gate/up/down (SwiGLU)
        per_layer_norms = 2 * d
        total = 0
        if self.xlstm is not None:
            # mLSTM/sLSTM blocks: qkv + gates + proj, approximated exactly in
            # models/xlstm.py::count_params; here use the same formula.
            from repro_torch.models import xlstm as _x
            return _x.count_params(self)
        for layer in range(self.n_layers):
            is_attn = True
            if self.hybrid is not None:
                is_attn = ((layer % self.hybrid.period)
                           == self.hybrid.attn_index)
            if is_attn:
                total += attn
            elif self.hybrid is not None:
                # mamba block params
                d_in = self.hybrid.expand * d
                total += (d * 2 * d_in                 # in_proj
                          + d_in * self.hybrid.d_conv  # conv
                          + d_in * (self.hybrid.d_state * 2 + 1)  # x_proj-ish
                          + d_in                        # dt
                          + d_in * self.hybrid.d_state  # A
                          + d_in * d)                   # out_proj
            if self.moe is not None and (layer % self.moe.moe_every) == 0:
                total += (self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                          + d * self.moe.n_experts)
            elif self.d_ff > 0:
                total += dense_ffn
            total += per_layer_norms
        total += self.vocab * d           # embedding
        if not self.tie_embeddings:
            total += self.vocab * d       # lm head
        total += d                        # final norm
        if self.encoder_decoder:
            enc_attn = attn
            enc = self.n_encoder_layers * (
                enc_attn + dense_ffn + per_layer_norms)
            cross = self.n_layers * (attn + d)  # cross-attn per decoder layer
            total += enc + cross
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for i in range(self.n_layers)
                         if (i % self.moe.moe_every) == 0)
        expert_p = 3 * self.d_model * self.moe.d_ff_expert
        inactive = (moe_layers * expert_p
                    * (self.moe.n_experts - self.moe.top_k))
        return int(full - inactive)

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if self.hybrid is None else
                         (self.hybrid.period if self.hybrid else 2)),
            d_model=64,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            encoder_seq=8 if self.encoder_decoder else self.encoder_seq,
            vision_patches=(8 if self.frontend == "vision"
                            else self.vision_patches),
            n_encoder_layers=min(self.n_encoder_layers, 2),
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=32)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(
                self.hybrid, period=4, attn_index=2, d_state=8, expand=2)
            kw["n_layers"] = 4
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_at=(1,))
            kw["n_layers"] = 2
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shapes (identical across archs; eligibility varies).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_eligible(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; reason if not."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("pure full-attention arch: 500k decode is quadratic-"
                       "KV-bound; skipped per brief (sub-quadratic only)")
    return True, ""
