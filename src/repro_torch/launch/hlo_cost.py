"""Loop-aware HLO cost analysis from ``compiled.as_text()``.

Why this exists: XLA-CPU's ``cost_analysis()`` counts a ``while`` body ONCE
regardless of trip count, so scanned-layer models (all of ours) would be
undercounted by ~n_layers x. This walker parses the post-SPMD HLO module,
recurses through fusions/calls/while bodies, multiplies while-body costs by
the trip count recovered from the loop condition, and accumulates:

* flops           — dot: 2*result_numel*contracted_size; convolution:
                    2*result_numel*window*cin/groups; elementwise ~ numel;
                    reduce ~ operand numel.
* hbm_bytes       — TPU-fusion-approximating HBM traffic: on TPU,
                    elementwise/reduction chains fuse into their matmul
                    neighbors, so only (a) dot/convolution operands+results,
                    (b) dynamic-(update-)slice windows into large buffers
                    (KV-cache updates, scanned-weight slicing), (c) fusion
                    boundaries, and (d) collective payloads touch HBM.
                    Pure-elementwise traffic is deliberately excluded —
                    an under-estimate for elementwise-heavy blocks (mamba
                    scans), noted in EXPERIMENTS.md.
* collective bytes— per kind, with the all-reduce 2x (RS+AG ring) factor,
                    loop-multiplied like everything else.

All quantities are per-device (the module is post-partitioning).

The walker is the reference's, unchanged, so ``analyze_hlo(text)`` gives
the reference's totals for the same text. :func:`analyze_traced` is the
port's own source of the same totals: it runs a PyTorch function on
``meta`` tensors (or DTensors over them) and walks the aten ops it
dispatches with the walker's conventions.
"""
from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-_]+)\s*\(.*->.*\{$")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-_]+)\s*=\s*(.+)$")
_OPCODE_RE = re.compile(r"^\s*([\w\-]+)\(")

ELEMENTWISE_OPS = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "exponential", "exponential-minus-one", "log", "log-plus-one",
    "rsqrt", "sqrt", "tanh", "logistic", "power", "and", "or", "xor", "not",
    "select", "clamp", "compare", "floor", "ceil", "round-nearest-afz",
    "sign", "cosine", "sine", "atan2", "remainder", "shift-left",
    "shift-right-logical", "shift-right-arithmetic",
}
FREE_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "reshape", "broadcast", "iota", "copy", "convert", "transpose",
    "slice", "dynamic-slice", "dynamic-update-slice", "concatenate",
    "pad", "reverse", "gather", "scatter", "reduce", "reduce-window",
    "rng", "rng-bit-generator", "after-all", "partition-id", "replica-id",
    "optimization-barrier", "copy-start", "copy-done", "custom-call",
    "get-dimension-size", "sort", "map", "infeed", "outfeed", "domain",
}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _shape_info(type_str: str) -> Tuple[int, List[Tuple[str, List[int]]]]:
    """bytes and [(dtype, dims)] of an HLO type string (maybe tuple)."""
    total, shapes = 0, []
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims_s = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        dims = [int(d) for d in dims_s.split(",") if d]
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
        shapes.append((dt, dims))
    return total, shapes


def _numel(dims: List[int]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


@dataclass
class Instr:
    name: str
    opcode: str
    result_type: str
    result_bytes: int
    result_shapes: List
    operands: List[str]
    raw: str


@dataclass
class Computation:
    name: str
    instrs: List[Instr] = field(default_factory=list)
    by_name: Dict[str, Instr] = field(default_factory=dict)


def parse_module(hlo_text: str) -> Tuple[Dict[str, Computation], str]:
    comps: Dict[str, Computation] = {}
    entry: Optional[str] = None
    cur: Optional[Computation] = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if cur is None:
            m = _COMP_HDR.match(stripped)
            if m and stripped.endswith("{"):
                cur = Computation(m.group(1))
                if stripped.startswith("ENTRY"):
                    entry = m.group(1)
            continue
        if stripped.startswith("}"):
            comps[cur.name] = cur
            cur = None
            continue
        im = _INSTR_RE.match(line)
        if not im:
            continue
        name, rhs = im.group(1), im.group(2)
        om = None
        # result type = text up to the opcode token
        opm = re.search(r"\s([\w\-]+)\(", " " + rhs)
        if not opm:
            continue
        result_type = rhs[:opm.start()].strip() if opm.start() > 0 else ""
        opcode = opm.group(1)
        rbytes, rshapes = _shape_info(result_type)
        # operands: names inside the first paren group
        args_start = rhs.find(opcode + "(") + len(opcode) + 1
        depth, i = 1, args_start
        while i < len(rhs) and depth:
            if rhs[i] == "(":
                depth += 1
            elif rhs[i] == ")":
                depth -= 1
            i += 1
        args = rhs[args_start:i - 1]
        operands = re.findall(r"%([\w.\-_]+)", args)
        ins = Instr(name, opcode, result_type, rbytes, rshapes, operands, rhs)
        cur.instrs.append(ins)
        cur.by_name[name] = ins
    return comps, entry or ""


def _while_trip_count(comps, cond_name: str) -> int:
    cond = comps.get(cond_name)
    if cond is None:
        return 1
    consts = {}
    for ins in cond.instrs:
        if ins.opcode == "constant":
            m = re.search(r"constant\((-?\d+)\)", ins.raw)
            if m:
                consts[ins.name] = int(m.group(1))
    for ins in cond.instrs:
        if ins.opcode == "compare":
            for o in ins.operands:
                if o in consts:
                    return max(consts[o], 1)
    return 1


_CALL_TARGET = re.compile(
    r"(?:calls|to_apply|body)=%?([\w.\-_]+)")
_COND_TARGET = re.compile(r"condition=%?([\w.\-_]+)")


def _dot_flops(comp: Computation, ins: Instr) -> float:
    lhs = comp.by_name.get(ins.operands[0]) if ins.operands else None
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.raw)
    if lhs is None or not lhs.result_shapes or m is None:
        return 2.0 * _numel(ins.result_shapes[0][1]) if ins.result_shapes \
            else 0.0
    dims = lhs.result_shapes[0][1]
    contracted = 1
    for d in m.group(1).split(","):
        if d:
            contracted *= dims[int(d)]
    out = _numel(ins.result_shapes[0][1]) if ins.result_shapes else 0
    return 2.0 * out * contracted


def _conv_flops(comp: Computation, ins: Instr) -> float:
    rhs_op = comp.by_name.get(ins.operands[1]) if len(ins.operands) > 1 \
        else None
    out = _numel(ins.result_shapes[0][1]) if ins.result_shapes else 0
    if rhs_op is None or not rhs_op.result_shapes:
        return 2.0 * out
    kdims = rhs_op.result_shapes[0][1]
    # kernel = spatial... x cin x cout; conservative: numel/cout
    cout = kdims[-1] if kdims else 1
    m = re.search(r"feature_group_count=(\d+)", ins.raw)
    groups = int(m.group(1)) if m else 1
    per_out = _numel(kdims) / max(cout, 1) / groups
    return 2.0 * out * per_out


@dataclass
class CostTotals:
    flops: float = 0.0
    contraction_flops: float = 0.0   # dot/conv only (fusion-boundary gate)
    hbm_bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=lambda: {
        k: 0.0 for k in COLLECTIVES})

    def add(self, other: "CostTotals", mult: float = 1.0):
        self.flops += other.flops * mult
        self.contraction_flops += other.contraction_flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k, v in other.coll.items():
            self.coll[k] += v * mult

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def _cost_of(comps, comp_name: str, memo: Dict[str, CostTotals]
             ) -> CostTotals:
    if comp_name in memo:
        return memo[comp_name]
    comp = comps.get(comp_name)
    total = CostTotals()
    if comp is None:
        memo[comp_name] = total
        return total
    memo[comp_name] = total  # break cycles
    for ins in comp.instrs:
        opc = ins.opcode
        operand_bytes = sum(
            comp.by_name[o].result_bytes for o in ins.operands
            if o in comp.by_name)
        if opc == "while":
            body_m = re.search(r"body=%?([\w.\-_]+)", ins.raw)
            tm_ = _TRIP_RE.search(ins.raw)
            if tm_:
                trip = int(tm_.group(1))
            else:
                cond_m = _COND_TARGET.search(ins.raw)
                trip = _while_trip_count(comps, cond_m.group(1)) \
                    if cond_m else 1
            if body_m:
                total.add(_cost_of(comps, body_m.group(1), memo), trip)
            continue
        if opc in ("fusion", "call"):
            tm = _CALL_TARGET.search(ins.raw)
            if tm:
                sub = _cost_of(comps, tm.group(1), memo)
                total.flops += sub.flops
                total.contraction_flops += sub.contraction_flops
                for k, v in sub.coll.items():
                    total.coll[k] += v
                # only contraction-bearing fusions are HBM boundaries; pure
                # elementwise fusions are assumed folded into their matmul
                # neighbors on TPU (the Pallas-fused ideal)
                if sub.contraction_flops > 0:
                    total.hbm_bytes += operand_bytes + ins.result_bytes
            continue
        if opc == "conditional":
            for tm in re.finditer(r"(?:true_computation|false_computation|"
                                  r"branch_computations)=.*?%?([\w.\-_]+)",
                                  ins.raw):
                total.add(_cost_of(comps, tm.group(1), memo), 1.0)
            continue
        base = opc[:-6] if opc.endswith("-start") else opc
        if base in COLLECTIVES:
            if base == "all-reduce":
                total.coll[base] += 2 * (operand_bytes or ins.result_bytes)
            elif base == "reduce-scatter":
                total.coll[base] += operand_bytes or ins.result_bytes
            else:
                total.coll[base] += ins.result_bytes
            total.hbm_bytes += operand_bytes + ins.result_bytes
            continue
        if opc == "dot":
            f = _dot_flops(comp, ins)
            total.flops += f
            total.contraction_flops += f
            total.hbm_bytes += operand_bytes + ins.result_bytes
        elif opc == "convolution":
            f = _conv_flops(comp, ins)
            total.flops += f
            total.contraction_flops += f
            total.hbm_bytes += operand_bytes + ins.result_bytes
        elif opc == "dynamic-slice":
            # reads only the sliced window (= result)
            total.hbm_bytes += ins.result_bytes
        elif opc == "dynamic-update-slice":
            # read-modify-write of the update window (operand 1)
            upd = comp.by_name.get(ins.operands[1]) \
                if len(ins.operands) > 1 else None
            total.hbm_bytes += 2 * (upd.result_bytes if upd else 0)
        elif opc in ("gather", "scatter"):
            total.hbm_bytes += 2 * ins.result_bytes
        elif opc in ELEMENTWISE_OPS:
            total.flops += float(_numel(ins.result_shapes[0][1])) \
                if ins.result_shapes else 0.0
        elif opc == "reduce":
            src = comp.by_name.get(ins.operands[0]) if ins.operands else None
            if src and src.result_shapes:
                total.flops += float(_numel(src.result_shapes[0][1]))
        # other elementwise/reduce/layout ops: fused on TPU, no HBM cost
    memo[comp_name] = total
    return total


def analyze_hlo(hlo_text: str) -> CostTotals:
    comps, entry = parse_module(hlo_text)
    if not entry:
        # fall back: largest computation
        entry = max(comps, key=lambda c: len(comps[c].instrs)) if comps \
            else ""
    return _cost_of(comps, entry, {})


# ------------------------------------------------- the port's traced source
# aten ops by the walker's classes (overload packets' names)
_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv"}
_CONV_OPS = {"convolution", "_convolution", "conv1d", "conv2d", "conv3d"}
_ELEMENTWISE_ATEN = {
    "add", "sub", "mul", "div", "maximum", "minimum", "abs", "neg", "exp",
    "expm1", "log", "log1p", "rsqrt", "sqrt", "tanh", "sigmoid", "pow",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not", "where",
    "clamp", "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
    "floor", "ceil", "round", "sign", "cos", "sin", "atan2", "remainder",
    "fmod", "reciprocal", "square", "softplus", "log_sigmoid_forward",
}
# ops the compiler expands into k elementwise passes (or reductions) over
# their operand: counted as k * numel
_COMPOUND_ATEN = {"silu": 2, "gelu": 8, "_softmax": 5, "_log_softmax": 5,
                  "logsumexp": 4, "native_layer_norm": 8, "erf": 1,
                  "_softmax_backward_data": 3, "silu_backward": 4,
                  "gelu_backward": 10, "sigmoid_backward": 2,
                  "tanh_backward": 2, "threshold_backward": 1,
                  "log_sigmoid_backward": 4, "relu": 1, "hardtanh": 1}
_REDUCE_ATEN = {"sum", "mean", "amax", "amin", "max", "min", "prod",
                "argmax", "argmin", "cumsum", "norm", "linalg_vector_norm",
                "_foreach_norm", "any", "all", "sort", "topk"}
_GATHER_ATEN = {"index", "gather", "embedding", "index_select",
                "take_along_dim"}
_SCATTER_ATEN = {"index_put", "index_put_", "scatter", "scatter_",
                 "scatter_add", "scatter_add_", "index_add", "index_add_",
                 "embedding_dense_backward", "_index_put_impl_"}
_COLLECTIVE_ATEN = {"all_gather_into_tensor": "all-gather",
                    "all_reduce": "all-reduce",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all",
                    "broadcast": "collective-permute"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    import torch
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [y for x in tree for y in _leaves(x)]
    if isinstance(tree, dict):
        return [y for x in tree.values() for y in _leaves(x)]
    return [tree]


@dataclass
class TracedCost(CostTotals):
    """:class:`CostTotals` of a traced run, with the largest number of
    bytes its op results held alive at once (views and in-place results
    not counted again) and the count of each aten op it ran."""
    peak_live_bytes: float = 0.0
    op_counts: Dict[str, int] = field(default_factory=dict)


def _conv_cost(args, out) -> float:
    w = args[1]
    groups = int(args[8]) if len(args) > 8 else 1
    cout = w.shape[0]
    per_out = w.numel() / max(cout, 1) / groups
    return 2.0 * out.numel() * per_out


def _op_cost(name: str, args, kwargs, outs, totals: CostTotals) -> None:
    """Add one aten op's flops, HBM bytes and collective bytes, by the
    walker's conventions."""
    ins = _tensors((args, kwargs))
    in_b = sum(_nbytes(t) for t in ins)
    out_b = sum(_nbytes(t) for t in outs)
    if name in _COLLECTIVE_ATEN:
        kind = _COLLECTIVE_ATEN[name]
        if kind == "all-reduce":
            totals.coll[kind] += 2 * (in_b or out_b)
        elif kind == "reduce-scatter":
            totals.coll[kind] += in_b or out_b
        else:
            totals.coll[kind] += out_b
        totals.hbm_bytes += in_b + out_b
        return
    if name in _DOT_OPS:
        a, b = (ins[-2], ins[-1])
        contracted = a.shape[-1]
        f = 2.0 * outs[0].numel() * contracted
        totals.flops += f
        totals.contraction_flops += f
        totals.hbm_bytes += in_b + out_b
        if name in ("addmm", "baddbmm"):
            totals.flops += outs[0].numel()
    elif name in _CONV_OPS:
        f = _conv_cost(args, outs[0])
        totals.flops += f
        totals.contraction_flops += f
        totals.hbm_bytes += in_b + out_b
    elif name == "convolution_backward":
        gy, x, w = args[0], args[1], args[2]
        groups = int(args[9]) if len(args) > 9 else 1
        per = 2.0 * gy.numel() * w.numel() / max(w.shape[0], 1) / groups
        f = per * sum(1 for o in outs if o is not None and o.numel())
        totals.flops += f
        totals.contraction_flops += f
        totals.hbm_bytes += in_b + out_b
    elif name == "copy_" and args[0]._is_view():
        # a window written into a larger buffer (a cache update)
        totals.hbm_bytes += 2 * _nbytes(args[1])
    elif name in _GATHER_ATEN:
        totals.hbm_bytes += 2 * out_b
    elif name in _SCATTER_ATEN:
        totals.hbm_bytes += 2 * out_b
    elif name in _ELEMENTWISE_ATEN:
        totals.flops += float(outs[0].numel()) if outs else 0.0
    elif name in _COMPOUND_ATEN:
        totals.flops += _COMPOUND_ATEN[name] * float(ins[0].numel())
    elif name in _REDUCE_ATEN:
        totals.flops += float(sum(t.numel() for t in ins))
    # layout ops (views, copies, casts, cat, pad, ...) are free, as in
    # the walker's FREE_OPS


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is on the caller's stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATOR):
            return True
        f = f.f_back
    return False


_PROPAGATOR = "distributed/tensor/_sharding_prop.py"


def analyze_traced(fn, *args, **kwargs) -> TracedCost:
    """Run ``fn(*args, **kwargs)`` on ``meta`` tensors (DTensors over
    ``meta`` shards on a fake process group included: each rank's ops are
    its shards' ops) and total its aten ops with the walker's
    conventions, per device:

    * flops: a dot ``2 * result * contracted``; a convolution as the
      walker counts it (``2 * result * kernel / cout / groups``, its
      backward once a gradient); an elementwise op its numel (ops the
      compiler expands, such as softmax or SiLU, a fixed multiple); a
      reduction its operand's numel;
    * HBM bytes: dot and convolution operands and results, gathers and
      scatters ``2 * result``, windows written into larger buffers
      ``2 * window``, collective payloads; elementwise traffic is left
      out, as the walker leaves out what fuses on the accelerator;
    * collective bytes by kind, from the ``_c10d_functional`` ops that
      DTensor issues: all-gather its result, all-reduce twice its
      operand, reduce-scatter its operand, all-to-all its result.

    A Python loop runs once per trip, so there is no trip count to
    recover (the walker's while-loop logic is moot here). DTensor-level
    ops are not counted themselves: each falls through to the per-rank
    ops it runs, and only those are counted. The sharding propagator's
    own evaluations are left out: on fake tensors, and (in newer torch)
    an op's decomposition run on ``meta`` tensors of the global shape
    to find its output placement, which no rank runs."""
    import weakref

    import torch
    from torch.distributed.tensor import DTensor
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    totals = TracedCost()
    live = [0, 0]     # bytes alive now, peak

    def free(n):
        live[0] -= n

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = _tensors((args, kwargs))
            if any(isinstance(t, DTensor) for t in ins):
                return NotImplemented     # DTensor runs the rank's ops
            out = func(*args, **kwargs)
            outs = _tensors(out)
            if any(isinstance(t, FakeTensor) for t in ins + outs) or \
                    _in_sharding_propagation():
                return out                # the sharding propagator's
            name = func.overloadpacket.__name__
            totals.op_counts[name] = totals.op_counts.get(name, 0) + 1
            _op_cost(name, args, kwargs, outs, totals)
            # a view or an in-place result shares an input's storage
            # (``_is_view()`` is not yet set on a result at this level);
            # a collective's autograd wrapper holds its input on a device
            # (a copy only on meta)
            seen = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                if t.untyped_storage()._cdata in seen or \
                        name == "_wrap_tensor_autograd":
                    continue
                n = _nbytes(t)
                live[0] += n
                live[1] = max(live[1], live[0])
                weakref.finalize(t, free, n)
            return out

    with _Recorder():
        fn(*args, **kwargs)
    totals.peak_live_bytes = float(live[1])
    return totals
