"""Ground-truth analyzers: the "compile + run on the accelerator" oracle.

The paper harvests ground truth by running 20k+ graphs on an Intel AI
accelerator. Without that hardware we use deterministic analyzers over the
same graphs (see DESIGN.md §2): the *learning problem* — predict a hardware
characteristic from IR text alone — is unchanged, and the analyzers model a
TPU-v5e-class chip:

* register_pressure — peak live vector-register units over the program,
  classic liveness on the SSA use-def chains. A live tensor occupies
  ``ceil(resident_tile / (8*128 lanes))`` VREG units (capped: spills go to
  VMEM). This is the TPU analogue of the paper's register/spill target.
* valu_utilization — number of vector-ALU issue slots: elementwise and
  reduction ops issue ``ceil(numel/VLEN)`` vector instructions; contraction
  ops run on the MXU but issue epilogue vALU work.
* latency_us — three-term roofline over ops: max(FLOPs/peak, bytes/HBM_bw)
  accumulated, in microseconds.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.ir.graph import (Graph, Op, Tensor, ELEMENTWISE, FUSED_OP,
                            REDUCTION, CONTRACTION, DATA_MOVEMENT)

VLEN = 8 * 128            # one VREG: 8 sublanes x 128 lanes of f32
TILE_VREGS = 16           # a live value holds a streaming tile window of at
                          # most this many VREGs (rest resides in VMEM/HBM)
PEAK_FLOPS = 197e12       # bf16 TPU v5e-class
HBM_BW = 819e9


def _vreg_units(t: Tensor) -> int:
    return min(math.ceil(t.numel / VLEN), TILE_VREGS)


def op_flops(g: Graph, op: Op) -> float:
    out = g.values[op.result]
    if op.opcode == FUSED_OP:
        # a fused elementwise chain does every constituent's arithmetic
        # but only one HBM round trip (op_bytes sees just its operands
        # and result — the intermediates never materialize)
        return float(out.numel) * int(op.attrs.get("n_fused", 1))
    if op.opcode == "matmul":
        a = g.values[op.operands[0]]
        k = a.shape[-1]
        return 2.0 * out.numel * k
    if op.opcode in ("conv2d", "depthwise_conv2d"):
        a = g.values[op.operands[0]]
        kh = kw = int(op.attrs.get("kernel", 3))
        cin = a.shape[-1] if op.opcode == "conv2d" else 1
        return 2.0 * out.numel * kh * kw * cin
    if op.opcode == "attention":
        return 4.0 * out.numel * out.shape[-1]
    if op.opcode in REDUCTION:
        a = g.values[op.operands[0]]
        return 4.0 * a.numel  # multi-pass (max/sub/exp/sum style)
    if op.opcode in ELEMENTWISE:
        return float(out.numel)
    return 0.0


def op_bytes(g: Graph, op: Op) -> float:
    read = sum(g.values[o].bytes for o in op.operands)
    return float(read + g.values[op.result].bytes)


def _valu_issues(g: Graph, op: Op) -> int:
    out = g.values[op.result]
    if op.opcode == FUSED_OP:
        return int(op.attrs.get("n_fused", 1)) * \
            math.ceil(out.numel / VLEN)
    if op.opcode in ELEMENTWISE:
        return math.ceil(out.numel / VLEN)
    if op.opcode in REDUCTION:
        a = g.values[op.operands[0]]
        return 4 * math.ceil(a.numel / VLEN)
    if op.opcode in CONTRACTION:
        # MXU does the MACs; vALU handles accumulation epilogue
        return math.ceil(out.numel / VLEN)
    if op.opcode in DATA_MOVEMENT:
        return math.ceil(out.numel / (2 * VLEN))
    return 0


def register_pressure(g: Graph) -> int:
    """Peak live VREG units over program points (liveness over use-def)."""
    last_use: Dict[int, int] = {}
    for i, op in enumerate(g.ops):
        for o in op.operands:
            last_use[o] = i
    for o in g.outputs:
        last_use[o] = len(g.ops)
    live = {a for a in range(g.n_args) if a in last_use}
    peak = sum(_vreg_units(g.values[v]) for v in live)
    cur = peak
    for i, op in enumerate(g.ops):
        live.add(op.result)
        cur += _vreg_units(g.values[op.result])
        peak = max(peak, cur)
        for o in set(op.operands) | {op.result}:
            if last_use.get(o, -1) == i:
                live.discard(o)
                cur -= _vreg_units(g.values[o])
    return int(peak)


def valu_utilization(g: Graph) -> int:
    """Total vector-ALU issue slots for the graph (paper's xpu utilization:
    'the number of times the vector ALU unit is utilized')."""
    return int(sum(_valu_issues(g, op) for op in g.ops))


def latency_us(g: Graph) -> float:
    """Roofline latency estimate in microseconds."""
    total = 0.0
    for op in g.ops:
        t_c = op_flops(g, op) / PEAK_FLOPS
        t_m = op_bytes(g, op) / HBM_BW
        total += max(t_c, t_m)
    return total * 1e6


TARGETS = {
    "register_pressure": register_pressure,
    "valu_utilization": valu_utilization,
    "latency_us": latency_us,
}


def analyze(g: Graph) -> Dict[str, float]:
    return {k: float(fn(g)) for k, fn in TARGETS.items()}
