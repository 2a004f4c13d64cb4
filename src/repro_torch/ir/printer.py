"""xpu-dialect MLIR printer — paper Fig. 2 textual form.

Example output::

    func.func @graph(%arg0: tensor<8x224x224x3xf32>)
        -> tensor<8x112x112x64xf32> {
      %0 = "xpu.conv2d"(%arg0) : (tensor<8x224x224x3xf32>)
          -> tensor<8x112x112x64xf32>
      %1 = "xpu.relu"(%0) : (tensor<8x112x112x64xf32>)
          -> tensor<8x112x112x64xf32>
      return %1 : tensor<8x112x112x64xf32>
    }
"""
from __future__ import annotations

from repro_torch.ir.graph import Graph


def to_mlir(g: Graph, dialect: str = "xpu") -> str:
    args = ", ".join(
        f"{g.ssa_name(i)}: {g.values[i].mlir()}" for i in range(g.n_args))
    rets = ", ".join(g.values[o].mlir() for o in g.outputs)
    lines = [f"func.func @{g.name}({args}) -> ({rets}) {{"]
    for op in g.ops:
        operands = ", ".join(g.ssa_name(o) for o in op.operands)
        in_types = ", ".join(g.values[o].mlir() for o in op.operands)
        out_type = g.values[op.result].mlir()
        attrs = ""
        if op.attrs:
            kv = ", ".join(f"{k} = {v}" for k, v in sorted(op.attrs.items()))
            attrs = f" {{{kv}}}"
        lines.append(
            f"  {g.ssa_name(op.result)} = \"{dialect}.{op.opcode}\""
            f"({operands}){attrs} : ({in_types}) -> {out_type}")
    ret_vals = ", ".join(g.ssa_name(o) for o in g.outputs)
    lines.append(f"  return {ret_vals} : {rets}")
    lines.append("}")
    return "\n".join(lines)
