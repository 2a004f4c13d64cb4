"""Roofline-term derivation from a compiled dry-run artifact.

    compute term    = HLO_FLOPs_global    / (chips * PEAK_FLOPS)
    memory term     = HLO_bytes_global    / (chips * HBM_BW)
    collective term = collective_bytes_per_chip / LINK_BW

FLOPs/bytes are per device (per rank), so global = per-device * chips and
the first two terms reduce to per_device / peak.

collective_bytes is NOT in cost_analysis: we parse the post-partitioning
HLO text and sum the bytes each chip moves per collective:

    all-gather          result_bytes          (each chip receives the rest)
    all-reduce          2 x operand_bytes     (ring reduce-scatter+all-gather)
    reduce-scatter      operand_bytes
    all-to-all          result_bytes
    collective-permute  result_bytes

Hardware constants: one NVIDIA H100 SXM5 80GB at its 700 W limit, from
its data sheet (not measured): dense bf16 tensor-core peak, HBM3 rate,
and NVLink 4 in one direction a card. A 256-card mesh spans 32 nodes of
8 cards, and between nodes a card has about 50 GB/s (one 400 Gb/s
InfiniBand link a card), so on such a mesh the collective term below,
which assumes NVLink everywhere, is a lower bound.

In the port the dry run fills the report from
:func:`repro_torch.launch.hlo_cost.analyze_traced`, whose totals are
per rank, as the compiled module's are per device.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989e12   # H100 SXM5 80GB, 700 W: dense bf16 (data sheet)
HBM_BW = 3.35e12      # H100 SXM5 80GB, 700 W: HBM3 (data sheet)
LINK_BW = 450e9       # H100 SXM5 80GB, 700 W: NVLink 4, one direction
                      # a card (data sheet)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?(%?[\w.-]+)\s*=\s*(.*)$")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_OPCODE_RE = re.compile(r"\s([\w-]+)\(")


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-chip bytes moved per collective kind, from post-SPMD HLO text."""
    sizes: Dict[str, int] = {}
    defs = []  # (name, result_bytes, opcode, args_str)
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, rhs = m.group(1).lstrip("%"), m.group(2)
        om = _OPCODE_RE.search(rhs)
        if not om:
            continue
        result_b = _shape_bytes(rhs[:om.start()])
        opcode = om.group(1)
        args = rhs[om.end():]
        close = args.find(")")
        args = args[:close] if close >= 0 else args
        sizes[name] = result_b
        defs.append((name, result_b, opcode, args))
    per_kind: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for name, result_b, opcode, args in defs:
        base = opcode[:-len("-start")] if opcode.endswith("-start") else opcode
        if base == "all-reduce-done" or base.endswith("-done"):
            continue
        if base not in _COLLECTIVES:
            continue
        operand_b = sum(sizes.get(a.group(1), 0)
                        for a in re.finditer(r"%?([\w.-]+)", args))
        if base == "all-reduce":
            per_kind[base] += 2 * (operand_b or result_b)
        elif base == "reduce-scatter":
            per_kind[base] += operand_b or result_b
        else:
            per_kind[base] += result_b
    return per_kind


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, float] = field(default_factory=dict)
    peak_memory_per_chip: float = 0.0
    model_flops: float = 0.0          # 6*N(_active)*D convention, global

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global HLO flops — remat/redundancy waste meter."""
        hlo_global = self.flops_per_chip * self.chips
        return self.model_flops / hlo_global if hlo_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of peak at the modeled step time."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.chips / self.t_bound) / PEAK_FLOPS

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_per_chip": self.peak_memory_per_chip,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(arch_cfg, shape_cfg) -> float:
    """Useful-FLOPs convention (PaLM-style MFU accounting):
    per token, 2*N_active for the forward matmuls plus the causal
    self-attention term 2*S_ctx*H*hd per attention layer (x0.5 causal);
    train multiplies by 3 (fwd + bwd)."""
    n = arch_cfg.active_param_count()
    L_attn = arch_cfg.attn_layers
    H, hd = arch_cfg.n_heads, arch_cfg.resolved_head_dim
    S = shape_cfg.seq_len

    if shape_cfg.kind in ("train", "prefill"):
        tokens = shape_cfg.global_batch * S
        # qk^T + pv = 2 matmuls: 2 * 2 * S * (H*hd), halved for causality
        attn_fwd_per_tok = 2.0 * S * H * hd * L_attn * 0.5
        fwd = 2.0 * n + attn_fwd_per_tok
        mult = 3.0 if shape_cfg.kind == "train" else 1.0
        return mult * fwd * tokens
    # decode: one token per sequence, attends the full cache
    attn_per_tok = 2.0 * 2.0 * S * H * hd * L_attn
    return (2.0 * n + attn_per_tok) * shape_cfg.global_batch
