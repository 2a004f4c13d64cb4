"""Real-MLIR pathway: StableHLO text from PyTorch functions.

A function is traced by PyTorch (``make_fx`` on fake tensors, core-ATen
decompositions) and the traced graph is printed by this module as
StableHLO in MLIR's pretty form, op for op in the spelling that a
StableHLO lowering of the same layer gives: one ``dot_general`` a
product (the ``view``/``permute``/``expand`` chains that torch puts
around ``mm``/``bmm`` fold into its batching and contracting dims),
softmax as max-reduce / subtract / exponential / add-reduce / divide,
SiLU, ReLU and log-softmax as private functions reached by ``call``,
top-k as the two-result ``chlo.top_k`` line, scalars as ``constant`` +
``broadcast_in_dim``. So the front door (:mod:`repro_torch.ir.frontdoor`)
parses the port's text as it parses any other StableHLO.

Targets are counted over the emitted ops with XLA's cost-analysis
conventions (see :func:`_cost`), and the roofline latency uses the
modelled target's constants in :mod:`repro_torch.ir.analyzers` — the
same target the dataset layer labels with, not the card this runs on.

Graph sources:

* :func:`sample_stablehlo_corpus` — a fixed pool of subgraphs (mlp /
  attention / conv / norm-residual) mirroring the xpu op mix.
* :func:`arch_subgraphs` / :func:`lower_arch_corpus` — per-layer
  subgraphs (attention, SwiGLU MLP, norms, router, lm head) of the real
  architectures registered in ``repro_torch.configs.ARCHS`` at reduced
  widths, traced from meta-tensor specs (no tensor data materialized).
  These are the "ingest a program we did not generate" acceptance
  inputs for the front door.

The affine/scf "lower-level dialects produce much larger sequences"
corpus is not produced here; it lives in
:data:`repro_torch.ir.frontdoor.AFFINE_EXAMPLE`.
"""
from __future__ import annotations

import decimal
import functools
import math
import operator
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.ir.analyzers import HBM_BW, PEAK_FLOPS

aten = torch.ops.aten

_DTYPES = {torch.float32: "f32", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.float64: "f64",
           torch.int64: "i64", torch.int32: "i32", torch.bool: "i1"}
_ITEMSIZE = {"f32": 4, "f16": 2, "bf16": 2, "f64": 8, "i64": 8, "i32": 4,
             "i1": 1}

# XLA's cost-analysis conventions, checked against ``cost_analysis()`` of
# single-op functions on the CPU: an elementwise op costs one flop an
# output element; a transcendental costs none (XLA counts it under its
# own key); a reduce costs (input - output) elements; a dot 2*out*K; a
# convolution 2*Cin*Cout*batch*(valid window taps, padding excluded).
_TRANSCENDENTAL = {"exponential", "log", "rsqrt", "sqrt", "tanh",
                   "logistic", "power"}
# bytes: the tensors an op's line spells, each once — an elementwise
# line spells one type (its operands share it, fused into its producer),
# a dot, reduce, convolution or transpose its operands' and result's.
# constant, broadcast_in_dim and reshape move no data of their own.
# (XLA's ``bytes accessed`` also counts fusion intermediates, which the
# traced graph does not have, so the two are compared, not matched.)
_NO_TRAFFIC = {"constant", "broadcast_in_dim", "reshape"}

# ATen ops the printer spells itself; every other op is decomposed to
# core ATen before printing.
_COMPOSITES = (aten.silu.default, aten.gelu.default, aten.relu.default,
               aten.sigmoid.default, aten._softmax.default,
               aten._log_softmax.default, aten.mean.dim,
               aten.sum.dim_IntList, aten.amax.default,
               aten.pow.Tensor_Scalar, aten.topk.default)
# (the decompositions turn reshape, t and transpose into these)
_VIEWS = {aten.view.default, aten._unsafe_view.default}
# shape ops a product's operand chain may fold through
_SHAPE_OPS = _VIEWS | {aten.permute.default, aten.unsqueeze.default,
                       aten.clone.default, aten.alias.default,
                       aten.expand.default}


def _numel(shape: Sequence[int]) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _list(xs) -> str:
    return "[" + ", ".join(str(int(x)) for x in xs) + "]"


def _mlir_float(v: float) -> str:
    """A float32 constant as MLIR prints it: 6 significant digits in
    ``%e`` form padded to 6 decimals when that reads back as the same
    float (and rounding did not carry into a new leading digit, which
    MLIR's check rejects), else 9 significant digits, truncated;
    non-finite values as hex bits."""
    f = np.float32(v)
    if not np.isfinite(f):
        return "0x" + f"{int(f.view(np.uint32)):08X}"
    s = f"{float(f):.5e}".replace("e", "0e")
    carried = s.lstrip("-").startswith("1.000000") and \
        abs(float(f)) < abs(float(s))
    if np.float32(s) == f and not carried:
        return s
    sign, digits, exp = decimal.Decimal(float(f)).as_tuple()
    msd = exp + len(digits) - 1               # power of the first digit
    digits = "".join(map(str, digits[:9])).rstrip("0") or "0"
    neg = "-" if sign else ""
    if msd < -3 or msd >= 9:
        return f"{neg}{digits[0]}.{digits[1:] or '0'}E{msd}"
    if msd < 0:
        return f"{neg}0.{'0' * (-msd - 1)}{digits}"
    whole = digits[:msd + 1].ljust(msd + 1, "0")
    return f"{neg}{whole}.{digits[msd + 1:] or '0'}"


@dataclass(frozen=True)
class _V:
    """An SSA value: its printed name, shape and element type."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "f32"

    @property
    def type(self) -> str:
        return ("tensor<" + "".join(f"{d}x" for d in self.shape)
                + self.dtype + ">")

    @property
    def nbytes(self) -> int:
        return _numel(self.shape) * _ITEMSIZE.get(self.dtype, 4)


@dataclass
class _Op:
    kind: str
    types: Tuple[_V, ...]                # the values the line spells
    flops: float = 0.0
    callee: Optional["_Func"] = None


class _Func:
    """One ``func.func`` being printed: its SSA names (numbered values,
    ``%cst``-style hints uniqued per function as MLIR does), its lines
    and the op records the targets are counted from."""

    def __init__(self, name: str, arg_types: Sequence[Tuple[Tuple[int, ...],
                                                            str]],
                 public: bool = False):
        self.name, self.public = name, public
        self.args = [_V(f"%arg{i}", tuple(s), d)
                     for i, (s, d) in enumerate(arg_types)]
        self.lines: List[str] = []
        self.ops: List[_Op] = []
        self.results: List[_V] = []
        self._n = 0
        self._names: set = set()
        self._conflict = 0

    # ------------------------------------------------------------ names
    def _value(self, shape, dtype="f32") -> _V:
        v = _V(f"%{self._n}", tuple(int(s) for s in shape), dtype)
        self._n += 1
        return v

    def _hinted(self, hint: str, shape, dtype="f32") -> _V:
        name = f"%{hint}"
        while name in self._names:
            name = f"%{hint}_{self._conflict}"
            self._conflict += 1
        self._names.add(name)
        return _V(name, tuple(int(s) for s in shape), dtype)

    def _emit(self, kind, types, text, flops=0.0, callee=None):
        self.lines.append(text)
        self.ops.append(_Op(kind, tuple(types), float(flops), callee))

    # -------------------------------------------------------------- ops
    def elementwise(self, kind: str, *xs: _V) -> _V:
        out = self._value(xs[0].shape, xs[0].dtype)
        self._emit(kind, [out],
                   f"{out.name} = stablehlo.{kind} "
                   f"{', '.join(x.name for x in xs)} : {out.type}",
                   0 if kind in _TRANSCENDENTAL else _numel(out.shape))
        return out

    def constant(self, value: float, dtype: str = "f32") -> _V:
        out = self._hinted("cst", (), dtype)
        self._emit("constant", [out],
                   f"{out.name} = stablehlo.constant "
                   f"dense<{_mlir_float(value)}> : {out.type}")
        return out

    def broadcast(self, x: _V, shape, dims) -> _V:
        out = self._value(shape, x.dtype)
        self._emit("broadcast_in_dim", [x, out],
                   f"{out.name} = stablehlo.broadcast_in_dim {x.name}, "
                   f"dims = {_list(dims)} : ({x.type}) -> {out.type}")
        return out

    def splat(self, value: float, shape) -> _V:
        """A scalar at ``shape``: ``constant`` + ``broadcast_in_dim``."""
        c = self.constant(value)
        return self.broadcast(c, shape, []) if tuple(shape) else c

    def broadcast_to(self, x: _V, shape) -> _V:
        """Numpy broadcasting in the reference's two steps: rank
        promotion (leading 1s), then the size-1 dims expanded."""
        shape = tuple(shape)
        if x.shape == shape:
            return x
        if not x.shape:
            return self.broadcast(x, shape, [])
        r, k = len(shape), len(x.shape)
        if k < r:
            x = self.broadcast(x, (1,) * (r - k) + x.shape, range(r - k, r))
        if x.shape != shape:
            x = self.broadcast(x, shape, range(r))
        return x

    def binary(self, kind: str, a, b, shape) -> _V:
        """``a <kind> b`` at ``shape``; python scalars become splats."""
        a = (self.splat(a, shape) if isinstance(a, (int, float))
             else self.broadcast_to(a, shape))
        b = (self.splat(b, shape) if isinstance(b, (int, float))
             else self.broadcast_to(b, shape))
        return self.elementwise(kind, a, b)

    def reshape(self, x: _V, shape) -> _V:
        out = self._value(shape, x.dtype)
        self._emit("reshape", [x, out],
                   f"{out.name} = stablehlo.reshape {x.name} : "
                   f"({x.type}) -> {out.type}")
        return out

    def transpose(self, x: _V, perm) -> _V:
        out = self._value([x.shape[p] for p in perm], x.dtype)
        self._emit("transpose", [x, out],
                   f"{out.name} = stablehlo.transpose {x.name}, "
                   f"dims = {_list(perm)} : ({x.type}) -> {out.type}")
        return out

    def reduce(self, x: _V, kind: str, init: float, dims) -> _V:
        dims = sorted(int(d) for d in dims)
        c = self.constant(init, x.dtype)
        out = self._value([s for i, s in enumerate(x.shape)
                           if i not in dims], x.dtype)
        self._emit("reduce", [x, c, out],
                   f"{out.name} = stablehlo.reduce({x.name} init: "
                   f"{c.name}) applies stablehlo.{kind} across dimensions "
                   f"= {_list(dims)} : ({x.type}, {c.type}) -> {out.type}",
                   _numel(x.shape) - _numel(out.shape))
        return out

    def keepdims(self, x: _V, dims, rank: int) -> _V:
        """A reduced value back at full rank with size-1 reduced dims."""
        kept = [i for i in range(rank) if i not in dims]
        shape = [1] * rank
        for i, s in zip(kept, x.shape):
            shape[i] = s
        return self.broadcast(x, shape, kept)

    def dot_general(self, a: _V, b: _V, batch, contract) -> _V:
        (ba, bb), (ca, cb) = batch, contract
        free_a = [i for i in range(len(a.shape)) if i not in ba + ca]
        free_b = [i for i in range(len(b.shape)) if i not in bb + cb]
        out = self._value([a.shape[i] for i in ba]
                          + [a.shape[i] for i in free_a]
                          + [b.shape[i] for i in free_b], a.dtype)
        dims = (f"batching_dims = {_list(ba)} x {_list(bb)}, "
                if ba else "")
        dims += f"contracting_dims = {_list(ca)} x {_list(cb)}"
        k = _numel([a.shape[i] for i in ca])
        self._emit("dot_general", [a, b, out],
                   f"{out.name} = stablehlo.dot_general {a.name}, {b.name}, "
                   f"{dims}, precision = [DEFAULT, DEFAULT] : "
                   f"({a.type}, {b.type}) -> {out.type}",
                   2 * _numel(out.shape) * k)
        return out

    def convolution(self, x: _V, w: _V, layouts, shape, stride, pad,
                    dilation) -> _V:
        """``layouts``: the three dim-role strings (``b f 0 1`` style)
        of input, kernel and output in their own dim order."""
        out = self._value(shape, x.dtype)
        lx, lw, lo = (("[" + ", ".join(roles) + "]") for roles in layouts)
        n = len(stride)
        window = (f"stride = {_list(stride)}, pad = ["
                  + ", ".join(f"[{p}, {p}]" for p in pad)
                  + f"], lhs_dilate = {_list([1] * n)}, rhs_dilate = "
                  f"{_list(dilation)}, reverse = ["
                  + ", ".join(["false"] * n) + "]")
        # flops: every (output position, kernel tap) pair that reads an
        # input element, padding excluded, per dim; times batch, Cin, Cout
        role = {r: i for i, r in enumerate(layouts[0])}
        wrole = {r: i for i, r in enumerate(layouts[1])}
        taps = 1
        for d in range(n):
            size_in = x.shape[role[str(d)]]
            k = w.shape[wrole[str(d)]]
            size_out = shape[layouts[2].index(str(d))]
            taps *= sum(1 for o in range(size_out) for j in range(k)
                        if 0 <= o * stride[d] - pad[d] + j * dilation[d]
                        < size_in)
        flops = (2 * taps * x.shape[role["b"]] * w.shape[wrole["i"]]
                 * w.shape[wrole["o"]])
        self._emit("convolution", [x, w, out],
                   f"{out.name} = stablehlo.convolution({x.name}, {w.name}) "
                   f"dim_numbers = {lx}x{lw}->{lo}, window = {{{window}}} "
                   f"{{batch_group_count = 1 : i64, feature_group_count = "
                   f"1 : i64, precision_config = [#stablehlo<precision "
                   f"DEFAULT>, #stablehlo<precision DEFAULT>]}} : "
                   f"({x.type}, {w.type}) -> {out.type}", flops)
        return out

    def top_k(self, x: _V, k: int) -> Tuple[_V, _V]:
        shape = x.shape[:-1] + (k,)
        vals = self._hinted("values", shape, x.dtype)
        idx = self._hinted("indices", shape, "i32")
        self._emit("top_k", [x, vals, idx],
                   f"{vals.name}, {idx.name} = chlo.top_k({x.name}, k = {k})"
                   f" : {x.type} -> ({vals.type}, {idx.type})")
        return vals, idx

    def call(self, callee: "_Func", *xs: _V) -> _V:
        res = callee.results[0]
        out = self._value(res.shape, res.dtype)
        self._emit("call", [*xs, out],
                   f"{out.name} = call @{callee.name}"
                   f"({', '.join(x.name for x in xs)}) : "
                   f"({', '.join(x.type for x in xs)}) -> {out.type}",
                   callee=callee)
        return out

    def text(self) -> str:
        sig = ", ".join(f"{a.name}: {a.type}" for a in self.args)
        types = [r.type for r in self.results]
        ret = types[0] if len(types) == 1 else "(" + ", ".join(types) + ")"
        head = (f"  func.func {'public' if self.public else 'private'} "
                f"@{self.name}({sig}) -> {ret} {{")
        body = [f"    {ln}" for ln in self.lines]
        body.append(f"    return {', '.join(r.name for r in self.results)}"
                    f" : {', '.join(types)}")
        return "\n".join([head, *body, "  }"])


# ---------------------------------------------------- compound spellings
def _softmax(f: _Func, x: _V, dim: int, log: bool = False) -> _V:
    m = f.reduce(x, "maximum", -math.inf, [dim])
    m = f.elementwise("maximum", f.splat(-math.inf, m.shape), m)
    m = f.broadcast(f.keepdims(m, [dim], len(x.shape)), x.shape,
                    range(len(x.shape)))
    shifted = f.elementwise("subtract", x, m)
    e = f.elementwise("exponential", shifted)
    s = f.keepdims(f.reduce(e, "add", 0.0, [dim]), [dim], len(x.shape))
    if log:
        s = f.elementwise("log", s)
    s = f.broadcast(s, x.shape, range(len(x.shape)))
    return f.elementwise("subtract" if log else "divide",
                         shifted if log else e, s)


def _sigmoid_body(f: _Func, x: _V) -> _V:
    e = f.elementwise("exponential", f.elementwise("negate", x))
    den = f.elementwise("add", f.splat(1.0, x.shape), e)
    return f.elementwise("divide", f.splat(1.0, x.shape), den)


def _silu_body(f: _Func, x: _V) -> _V:
    return f.elementwise("multiply", x, _sigmoid_body(f, x))


def _relu_body(f: _Func, x: _V) -> _V:
    return f.elementwise("maximum", x, f.splat(0.0, x.shape))


def _gelu_tanh(f: _Func, x: _V) -> _V:
    cube = f.elementwise("multiply", f.elementwise("multiply", x, x), x)
    inner = f.elementwise("add", x, f.elementwise(
        "multiply", f.splat(0.044715, x.shape), cube))
    t = f.elementwise("tanh", f.elementwise(
        "multiply", f.splat(math.sqrt(2.0 / math.pi), x.shape), inner))
    one_plus = f.elementwise("add", f.splat(1.0, x.shape), t)
    cdf = f.elementwise("multiply", f.splat(0.5, x.shape), one_plus)
    return f.elementwise("multiply", x, cdf)


# ----------------------------------------------- folding shape-op chains
def _shape(node) -> Tuple[int, ...]:
    return tuple(int(s) for s in node.meta["val"].shape)


def _regroup_view(groups, sizes, new_shape):
    """Groups of root dims after a view to ``new_shape``, or None when
    the view splits a root dim (then it is printed as a reshape)."""
    atoms = [a for g in groups for a in g]
    out, i = [], 0
    for n in new_shape:
        g, p = [], 1
        while p < n and i < len(atoms):
            g.append(atoms[i])
            p *= sizes[atoms[i]]
            i += 1
        if p != n:
            return None
        if n == 1 and i < len(atoms) and sizes[atoms[i]] == 1:
            g.append(atoms[i])
            i += 1
        out.append(g)
    for a in atoms[i:]:                    # trailing size-1 root dims
        if sizes[a] != 1 or not out:
            return None
        out[-1].append(a)
    return out


def _regroup(root_shape, chain):
    """Each dim of the chain's last value as the list of root dims it
    flattens, in order; None when a step is not a regrouping."""
    sizes = list(root_shape)
    groups = [[i] for i in range(len(sizes))]
    for n in chain:
        t = n.target
        if t is aten.permute.default:
            groups = [groups[d] for d in n.args[1]]
        elif t is aten.unsqueeze.default:
            groups.insert(n.args[1] % (len(groups) + 1), [])
        elif t is aten.expand.default:      # new leading size-1 dims only
            new = list(_shape(n))
            lead = len(new) - len(groups)
            if lead < 0 or new != [1] * lead + [
                    _numel([sizes[a] for a in g]) for g in groups]:
                return None
            groups = [[] for _ in range(lead)] + groups
        elif t in _VIEWS:
            groups = _regroup_view(groups, sizes, _shape(n))
            if groups is None:
                return None
        # clone / alias: the same value
    return groups


def _pair(ga, sa, gb, sb):
    """Two groups paired dim for dim, or None. Size-1 dims without a
    partner (a batch dim that torch's broadcast added to one side) are
    left out; they become free dims of their side."""
    for a, b in ((ga, gb), ([i for i in ga if sa[i] != 1],
                            [i for i in gb if sb[i] != 1])):
        if len(a) == len(b) and all(sa[i] == sb[j] for i, j in zip(a, b)):
            return list(a), list(b)
    return None


def _product_dims(ga, sa, gb, sb, batched: bool):
    """dot_general dims of a (b)mm whose operands are regroupings of two
    roots, or None when the groups do not pair dim for dim or a free
    group is out of root order (the output would need a transpose)."""
    if batched:
        (b1, m, k1), (b2, k2, n) = ga, gb
    else:
        (m, k1), (k2, n), b1, b2 = ga, gb, [], []
    batch, contract = _pair(b1, sa, b2, sb), _pair(k1, sa, k2, sb)
    if batch is None or contract is None:
        return None
    for g, s in ((m, sa), (n, sb)):
        big = [i for i in g if s[i] != 1]
        if big != sorted(big):
            return None
    return batch, contract


class _Printer:
    """Prints one traced graph as a StableHLO module."""

    def __init__(self, gm: torch.fx.GraphModule, name: str):
        self.name = name
        self.nodes = list(gm.graph.nodes)
        places = [n for n in self.nodes if n.op == "placeholder"]
        self.main = _Func("main", [(_shape(n), _DTYPES[n.meta["val"].dtype])
                                   for n in places], public=True)
        self.env: Dict = dict(zip(places, self.main.args))
        self.privates: Dict[Tuple[str, str], _Func] = {}
        self.folded: set = set()
        self.sinks: Dict = {}              # folded view -> its product
        self.plans: Dict = {}
        self._plan()

    # ------------------------------------------------------- pre-pass
    def _candidates(self, node):
        """(root, chain, groups) for the operand ``node``, the farthest
        root first: single-user shape ops fold into the product."""
        chain, cur = [], node
        while (cur.op == "call_function" and cur.target in _SHAPE_OPS
               and len(cur.users) == 1 and cur not in self.sinks):
            chain.insert(0, cur)
            cur = cur.args[0]
        for i in range(len(chain) + 1):
            root = cur if i == 0 else chain[i - 1]
            groups = _regroup(_shape(root), chain[i:])
            if groups is not None:
                yield root, chain[i:], groups

    def _plan(self):
        for n in self.nodes:
            if n.target in (aten.mm.default, aten.bmm.default):
                self._plan_product(n)
            elif n.target is aten.convolution.default:
                self._plan_convolution(n)

    def _plan_product(self, n):
        plan = None
        for ra, ca, ga in self._candidates(n.args[0]):
            for rb, cb, gb in self._candidates(n.args[1]):
                dims = _product_dims(ga, _shape(ra), gb, _shape(rb),
                                     n.target is aten.bmm.default)
                if dims is not None:
                    plan = (ra, ca, rb, cb, dims)
                    break
            if plan is not None:
                break
        ra, ca, rb, cb, (batch, contract) = plan
        self.folded.update(ca + cb)
        sa, sb = _shape(ra), _shape(rb)
        natural = ([sa[i] for i in batch[0]]
                   + [sa[i] for i in range(len(sa))
                      if i not in batch[0] + contract[0]]
                   + [sb[i] for i in range(len(sb))
                      if i not in batch[1] + contract[1]])
        users = list(n.users)
        if (len(users) == 1 and users[0].target in _VIEWS
                and list(_shape(users[0])) == natural):
            self._sink(users[0], n)
        self.plans[n] = (ra, rb, batch, contract)

    def _plan_convolution(self, n):
        """Permutes around a 2-D convolution (an NHWC/HWIO function
        traced through torch's NCHW/OIHW op) fold into its layouts."""
        x, w, bias, stride, _, _, transposed, _, groups = n.args
        if bias is not None or transposed or groups != 1 or \
                len(stride) != 2:
            raise NotImplementedError("convolution: 2-D, no bias, "
                                      "groups=1, not transposed")

        def fold_in(node, roles):
            if node.target is aten.permute.default and len(node.users) == 1:
                self.folded.add(node)
                root = [None] * len(roles)
                for i, p in enumerate(node.args[1]):
                    root[p] = roles[i]
                return node.args[0], root
            return node, roles

        lo = ["b", "f", "0", "1"]
        users = list(n.users)
        if len(users) == 1 and users[0].target is aten.permute.default:
            lo = [lo[p] for p in users[0].args[1]]
            self._sink(users[0], n)
        self.plans[n] = (fold_in(x, ["b", "f", "0", "1"]),
                         fold_in(w, ["o", "i", "0", "1"]), lo)

    def _sink(self, view, producer):
        """``view`` of ``producer``'s value is the printed op's result."""
        self.folded.add(view)
        self.sinks[view] = producer

    # ---------------------------------------------------------- print
    def private(self, kind: str, body: Callable, x: _V) -> _V:
        """``call`` a private function (one a kind and operand type)."""
        key = (kind, x.type)
        if key not in self.privates:
            used = {fn.name for fn in self.privates.values()}
            name, i = kind, 0
            while name in used:
                name, i = f"{kind}_{i}", i + 1
            fn = _Func(name, [(x.shape, x.dtype)])
            fn.results = [body(fn, fn.args[0])]
            self.privates[key] = fn
        return self.main.call(self.privates[key], x)

    def run(self) -> str:
        for n in self.nodes:
            if n.op == "placeholder" or n in self.folded:
                if n in self.sinks:
                    self.env[n] = self.env[self.sinks[n]]
                continue
            if n.op == "output":
                outs = n.args[0]
                outs = outs if isinstance(outs, (list, tuple)) else [outs]
                self.main.results = [self.env[o] for o in outs]
                continue
            self.env[n] = self.lower(n)
        funcs = [self.main, *self.privates.values()]
        return (f"module @{self.name} attributes {{mhlo.num_partitions = "
                f"1 : i32, mhlo.num_replicas = 1 : i32}} {{\n"
                + "\n".join(fn.text() for fn in funcs) + "\n}\n")

    def lower(self, n):
        f, t, env = self.main, n.target, self.env
        if t is operator.getitem:
            return env[n.args[0]][n.args[1]]
        if t is aten.topk.default:
            x, k = env[n.args[0]], n.args[1]
            dim = (n.args[2] if len(n.args) > 2 else -1) % len(x.shape)
            if dim != len(x.shape) - 1 or (len(n.args) > 3
                                           and not n.args[3]):
                raise NotImplementedError("topk: largest along the last "
                                          "dim only")
            return f.top_k(x, k)
        shape = _shape(n)
        if t in (aten.mm.default, aten.bmm.default):
            ra, rb, batch, contract = self.plans[n]
            v = f.dot_general(env[ra], env[rb], batch, contract)
            if v.shape == shape or any(u in self.sinks for u in n.users):
                return v
            return f.reshape(v, shape)
        if t is aten.convolution.default:
            return self._convolution(n)
        args = [env[a] if isinstance(a, torch.fx.Node) else a
                for a in n.args]
        x = args[0]
        if t in _ELEMENTWISE:
            if t in (aten.add.Tensor, aten.sub.Tensor) and \
                    n.kwargs.get("alpha", 1) != 1:
                raise NotImplementedError(f"{t} with alpha")
            if t is aten.div.Tensor and n.kwargs.get("rounding_mode"):
                raise NotImplementedError(f"{t} with rounding_mode")
            kind = _ELEMENTWISE[t]
            if len(args) == 1:
                return f.elementwise(kind, x)
            return f.binary(kind, x, args[1], shape)
        if t in _VIEWS:
            return f.reshape(x, shape) if x.shape != shape else x
        if t is aten.permute.default:
            return f.transpose(x, [d % len(shape) for d in args[1]])
        if t is aten.unsqueeze.default:
            d = args[1] % len(shape)
            return f.broadcast(x, shape, [i for i in range(len(shape))
                                          if i != d])
        if t in (aten.clone.default, aten.alias.default):
            return x
        if t is aten.expand.default:
            return f.broadcast_to(x, shape)
        if t is aten._softmax.default:
            return _softmax(f, x, args[1] % len(shape))
        if t is aten._log_softmax.default:
            return self.private(
                "log_softmax",
                lambda g, y: _softmax(g, y, args[1] % len(shape), log=True),
                x)
        if t is aten.silu.default:
            return self.private("silu", _silu_body, x)
        if t is aten.relu.default:
            return self.private("relu", _relu_body, x)
        if t is aten.sigmoid.default:
            return _sigmoid_body(f, x)
        if t is aten.gelu.default:
            if n.kwargs.get("approximate", "none") != "tanh":
                raise NotImplementedError("gelu without approximate='tanh'")
            return _gelu_tanh(f, x)
        if t in (aten.mean.dim, aten.sum.dim_IntList, aten.amax.default):
            rank = len(x.shape)
            dims = sorted({d % rank for d in (args[1] if args[1]
                                               else range(rank))})
            keep = args[2] if len(args) > 2 else n.kwargs.get("keepdim",
                                                              False)
            kind, init = (("maximum", -math.inf)
                          if t is aten.amax.default else ("add", 0.0))
            v = f.reduce(x, kind, init, dims)
            if keep:
                v = f.keepdims(v, dims, rank)
            if t is aten.mean.dim:
                v = f.binary("divide", v, float(_numel(
                    [x.shape[d] for d in dims])), v.shape)
            return v
        if t is aten.pow.Tensor_Scalar:
            e = args[1]
            if float(e).is_integer() and 2 <= e <= 4:
                acc = f.elementwise("multiply", x, x)
                for _ in range(int(e) - 2):
                    acc = f.elementwise("multiply", acc, x)
                return acc
            return f.binary("power", x, float(e), shape)
        raise NotImplementedError(f"no StableHLO spelling for {t}")

    def _convolution(self, n):
        (x, lx), (w, lw), lo = self.plans[n]
        _, _, _, stride, pad, dil, _, _, _ = n.args
        shape = _shape(next(iter(n.users))) if any(
            u in self.sinks for u in n.users) else _shape(n)
        return self.main.convolution(self.env[x], self.env[w],
                                     (lx, lw, lo), shape, list(stride),
                                     list(pad), list(dil))


_ELEMENTWISE = {
    aten.add.Tensor: "add", aten.sub.Tensor: "subtract",
    aten.mul.Tensor: "multiply", aten.div.Tensor: "divide",
    aten.maximum.default: "maximum", aten.minimum.default: "minimum",
    aten.neg.default: "negate", aten.abs.default: "abs",
    aten.exp.default: "exponential", aten.log.default: "log",
    aten.rsqrt.default: "rsqrt", aten.sqrt.default: "sqrt",
    aten.tanh.default: "tanh",
}


@functools.lru_cache(maxsize=1)
def _decompositions():
    from torch._decomp import core_aten_decompositions
    return {op: fn for op, fn in core_aten_decompositions().items()
            if op not in _COMPOSITES}


def _lower(fn: Callable, specs) -> Tuple[str, _Func]:
    """Trace ``fn`` on fake tensors and print it: (module text, main
    function with its op records)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn, decomposition_table=_decompositions(),
                 tracing_mode="fake")(*specs)
    name = re.sub(r"\W", "_", getattr(fn, "__name__", "fn"))   # <lambda>
    printer = _Printer(gm, name)
    return printer.run(), printer.main


def _cost(fn: _Func) -> Tuple[float, float]:
    """(flops, bytes) over the emitted ops, a callee's body once per
    call (the rules above the op records)."""
    flops = nbytes = 0.0
    for op in fn.ops:
        if op.callee is not None:
            f, b = _cost(op.callee)
            flops, nbytes = flops + f, nbytes + b
            continue
        flops += op.flops
        if op.kind not in _NO_TRAFFIC:
            nbytes += sum(v.nbytes for v in op.types)
    return flops, nbytes


def lower_fn(fn: Callable, *args) -> Tuple[str, Dict[str, float]]:
    """Lower ``fn`` (a PyTorch function of the given tensors, meta
    tensors included) to StableHLO text and count its targets.

    A failure to count never raises: the text comes back with zeroed
    targets, as it does where a compiler's cost analysis is missing."""
    text, main = _lower(fn, args)
    try:
        flops, nbytes = _cost(main)
    except (TypeError, ValueError, OverflowError):
        flops = nbytes = 0.0
    targets = {
        "flops": flops,
        "bytes": nbytes,
        "latency_us": max(flops / PEAK_FLOPS, nbytes / HBM_BW) * 1e6,
    }
    return text, targets


def _spec(*shape) -> torch.Tensor:
    """A float32 spec: shape and dtype, no storage."""
    return torch.empty(shape, dtype=torch.float32, device="meta")


# A pool of subgraphs mirroring the xpu-dialect op mix.
def _mlp(b, s, d, f):
    def fn(x, w1, w2):
        return F.gelu(x @ w1, approximate="tanh") @ w2
    return fn, (_spec(b, s, d), _spec(d, f), _spec(f, d))


def _attention_core(x, wq, wk, wv, h):
    """softmax(q k^T / sqrt(hd)) v per head, (b, s, h*hd) out. The
    second product is written v-first, the operand order a StableHLO
    lowering of the einsum picks, so the two texts match op for op."""
    b, s, d = x.shape[0], x.shape[1], wq.shape[1]
    hd = d // h
    q = (x @ wq).reshape(b, s, h, hd)
    k = (x @ wk).reshape(b, s, h, hd)
    v = (x @ wv).reshape(b, s, h, hd)
    a = (q.permute(0, 2, 1, 3) @ k.permute(0, 2, 3, 1)) / math.sqrt(hd)
    w = torch.softmax(a, dim=-1)
    o = (v.permute(0, 2, 3, 1) @ w.transpose(-1, -2)).permute(0, 3, 1, 2)
    return o.reshape(b, s, d)


def _attn(b, s, d, h):
    def fn(x, wq, wk, wv):
        return _attention_core(x, wq, wk, wv, h)
    return fn, (_spec(b, s, d), _spec(d, d), _spec(d, d), _spec(d, d))


def _conv(b, s, cin, cout):
    def fn(x, w):                        # NHWC input, HWIO kernel
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=1)
        return F.relu(y.permute(0, 2, 3, 1))
    return fn, (_spec(b, s, s, cin), _spec(3, 3, cin, cout))


def _norm_residual(b, s, d):
    def fn(x, g):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return x + (x - mu) * torch.rsqrt(var + 1e-5) * g
    return fn, (_spec(b, s, d), _spec(d))


def sample_stablehlo_corpus(rng: np.random.Generator, n: int = 64
                            ) -> List[Tuple[str, Dict[str, float]]]:
    """Generate (stablehlo_text, targets) rows by lowering the pool; the
    rng draws are the reference pool's, in its order."""
    rows = []
    makers = [
        lambda: _mlp(int(rng.choice([1, 4, 8])), int(rng.choice([64, 128])),
                     int(rng.choice([128, 256, 512])),
                     int(rng.choice([256, 512, 1024]))),
        lambda: _attn(int(rng.choice([1, 4])), int(rng.choice([64, 128])),
                      int(rng.choice([128, 256])), int(rng.choice([4, 8]))),
        lambda: _conv(int(rng.choice([1, 4])), int(rng.choice([14, 28])),
                      int(rng.choice([16, 32])), int(rng.choice([32, 64]))),
        lambda: _norm_residual(int(rng.choice([1, 8])),
                               int(rng.choice([64, 256])),
                               int(rng.choice([256, 1024]))),
    ]
    for i in range(n):
        fn, args = makers[i % len(makers)]()
        rows.append(lower_fn(fn, *args))
    return rows


# ------------------------------------------- real-architecture subgraphs
def arch_subgraphs(name: str, batch: int = 1, seq: int = 8
                   ) -> List[Tuple[str, Callable, Tuple]]:
    """Per-layer subgraphs of a registered architecture at reduced
    widths: ``(layer_name, fn, arg_specs)`` triples, the specs meta
    tensors (shape and dtype, no storage), so lowering materializes
    nothing."""
    from repro_torch.configs import get_arch
    cfg = get_arch(name).reduced()
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    ff = cfg.d_ff or 4 * d

    def attention(x, wq, wk, wv, wo):
        return _attention_core(x, wq, wk, wv, h) @ wo

    def mlp_swiglu(x, wg, wu, wd):
        return (F.silu(x @ wg) * (x @ wu)) @ wd

    def rmsnorm_residual(x, g):
        var = (x * x).mean(-1, keepdim=True)
        return x + x * torch.rsqrt(var + cfg.norm_eps) * g

    def lm_head(x, w):
        return F.log_softmax(x @ w, dim=-1)

    out: List[Tuple[str, Callable, Tuple]] = [
        ("attention", attention,
         (_spec(batch, seq, d), _spec(d, h * hd), _spec(d, h * hd),
          _spec(d, h * hd), _spec(h * hd, d))),
        ("mlp_swiglu", mlp_swiglu,
         (_spec(batch, seq, d), _spec(d, ff), _spec(d, ff), _spec(ff, d))),
        ("rmsnorm_residual", rmsnorm_residual,
         (_spec(batch, seq, d), _spec(d))),
        ("lm_head", lm_head, (_spec(batch, seq, d), _spec(d, cfg.vocab))),
    ]
    if cfg.moe is not None:
        def moe_router(x, wr):
            probs = torch.softmax(x @ wr, dim=-1)
            top = torch.topk(probs, cfg.moe.top_k).values
            return top / top.sum(-1, keepdim=True)
        out.append(("moe_router", moe_router,
                    (_spec(batch, seq, d), _spec(d, cfg.moe.n_experts))))
    return out


def lower_arch_corpus(names: Optional[List[str]] = None, batch: int = 1,
                      seq: int = 8) -> List[Tuple[str, str, str]]:
    """Lower every per-layer subgraph of the given architectures ->
    ``(arch, layer, stablehlo_text)`` rows. ``names=None`` lowers all
    registered archs."""
    from repro_torch.configs import ARCHS
    rows: List[Tuple[str, str, str]] = []
    for name in (names if names is not None else sorted(ARCHS)):
        for layer, fn, specs in arch_subgraphs(name, batch=batch, seq=seq):
            rows.append((name, layer, _lower(fn, specs)[0]))
    return rows
