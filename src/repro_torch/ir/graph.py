"""Dataflow-graph IR: SSA ops over tensors, the `xpu` dialect's substrate.

Mirrors the paper's Fig. 2: a function embodies the (sub)graph, operators are
`xpu.*` opcodes, data dependencies are SSA use-def chains, and values are
tensors with shape + element dtype.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Shape = Tuple[int, ...]

# Incremental structural hashing (see Graph.struct_key): rewrite-derived
# graphs inherit the per-value hashes of ops copied verbatim from their
# parent, so only the rewrite's dirty cone is re-hashed. Disable to force
# every struct_key() call back to the full from-scratch Merkle walk (the
# pre-incremental behavior) — the flag-switchable baseline the
# ``search_fleet`` benchmark measures against.
_INCREMENTAL_HASHING = True


def set_incremental_hashing(enabled: bool) -> bool:
    """Toggle incremental struct_key hashing; returns the previous value."""
    global _INCREMENTAL_HASHING
    prev = _INCREMENTAL_HASHING
    _INCREMENTAL_HASHING = bool(enabled)
    return prev


def incremental_hashing_enabled() -> bool:
    return _INCREMENTAL_HASHING


@dataclass(frozen=True)
class Tensor:
    shape: Shape
    dtype: str = "f32"

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def bytes(self) -> int:
        # ingested MLIR can carry any element type (i64, f64, i1, ...);
        # unknown widths default to 4 rather than KeyError mid-analysis
        width = {"f32": 4, "bf16": 2, "f16": 2, "i8": 1, "i32": 4,
                 "f64": 8, "i64": 8, "i16": 2, "i1": 1}.get(self.dtype, 4)
        return self.numel * width

    def mlir(self) -> str:
        dims = "x".join(str(d) for d in self.shape)
        return f"tensor<{dims}x{self.dtype}>" if self.shape else \
            f"tensor<{self.dtype}>"

    def shape_token(self) -> str:
        """The paper tokenizes a full shape as a single entity."""
        dims = "x".join(str(d) for d in self.shape)
        return f"{dims}x{self.dtype}" if self.shape else self.dtype


@dataclass
class Op:
    opcode: str                 # e.g. "mult", "matmul", "conv2d", "relu"
    operands: List[int]         # SSA value ids (graph.values indices)
    result: int                 # SSA id of the produced value
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class Graph:
    """SSA graph. values[i] is the Tensor type of SSA id i; ids < n_args are
    function arguments (%arg0..); the rest are op results (%0..)."""
    values: List[Tensor] = field(default_factory=list)
    n_args: int = 0
    ops: List[Op] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)
    name: str = "graph"
    # --- struct_key memoization (never part of graph identity/equality) ---
    # value id -> structural hash, filled lazily by value_hashes()
    _vhash: Optional[Dict[int, str]] = field(
        default=None, repr=False, compare=False)
    # value id -> hash inherited from a parent graph (adopt_hashes)
    _inherited: Optional[Dict[int, str]] = field(
        default=None, repr=False, compare=False)
    # ((n_ops, n_args, outputs), key): finished-key cache, invalidated
    # when the cheap shape token no longer matches
    _key_cache: Optional[Tuple[Tuple, str]] = field(
        default=None, repr=False, compare=False)
    # ops-mode token-splice hint set by adopt_hashes:
    # (parent struct key, {child op index: parent op index})
    _tok_delta: Optional[Tuple[str, Dict[int, int]]] = field(
        default=None, repr=False, compare=False)

    def add_arg(self, t: Tensor) -> int:
        assert not self.ops, "args must precede ops"
        self.values.append(t)
        self.n_args += 1
        return len(self.values) - 1

    def add_op(self, opcode: str, operands: Sequence[int], out: Tensor,
               **attrs) -> int:
        self.values.append(out)
        vid = len(self.values) - 1
        self.ops.append(Op(opcode, list(operands), vid, attrs))
        return vid

    def ssa_name(self, vid: int) -> str:
        if vid < self.n_args:
            return f"%arg{vid}"
        return f"%{vid - self.n_args}"

    def validate(self) -> None:
        defined = set(range(self.n_args))
        for op in self.ops:
            for o in op.operands:
                assert o in defined, f"use before def: {o} in {op.opcode}"
            assert op.result not in defined
            defined.add(op.result)
        for o in self.outputs:
            assert o in defined

    def toposort_is_program_order(self) -> bool:
        try:
            self.validate()
            return True
        except AssertionError:
            return False

    def _compute_hashes(self, inherited: Dict[int, str]) -> Dict[int, str]:
        """Merkle walk: args by position, op results by opcode + operand
        hashes + attrs + result type. Values present in ``inherited``
        skip payload construction and SHA-1 entirely."""
        memo: Dict[int, str] = {}
        for i in range(self.n_args):
            h = inherited.get(i)
            if h is None:
                t = self.values[i]
                h = hashlib.sha1(
                    f"arg{i}:{t.shape}:{t.dtype}".encode()).hexdigest()
            memo[i] = h
        for op in self.ops:
            h = inherited.get(op.result)
            if h is None:
                t = self.values[op.result]
                attrs = ",".join(f"{k}={op.attrs[k]!r}"
                                 for k in sorted(op.attrs))
                payload = (f"{op.opcode}"
                           f"({','.join(memo[o] for o in op.operands)})"
                           f"[{attrs}]->{t.shape}:{t.dtype}")
                h = hashlib.sha1(payload.encode()).hexdigest()
            memo[op.result] = h
        return memo

    def _combine_key(self, memo: Dict[int, str]) -> str:
        """Op-hash *multiset* + output tuple -> the canonical key."""
        body = ",".join(sorted(memo[op.result] for op in self.ops))
        outs = ",".join(memo[o] for o in self.outputs)
        return hashlib.sha1(
            f"{self.n_args}|{body}|{outs}".encode()).hexdigest()

    def value_hashes(self) -> Dict[int, str]:
        """Per-value structural hashes, memoized on the graph (recomputed
        if values were appended since), honoring inherited hashes."""
        memo = self._vhash
        if memo is None or len(memo) != len(self.values):
            memo = self._compute_hashes(self._inherited or {})
            self._vhash = memo
        return memo

    def adopt_hashes(self, parent: "Graph", copied: Dict[int, int],
                     tok_copied: Optional[Dict[int, int]] = None) -> None:
        """Declare values copied verbatim from ``parent`` (child value id
        -> parent value id): their structural hashes are inherited, so
        the first struct_key() re-hashes only the rewrite's dirty cone.
        Callers (the repro_torch.opt rewrite builder) guarantee that a declared
        copy has the same opcode/attrs/result type AND that every operand
        is itself a declared copy — the property tests hold incremental
        keys equal to from-scratch keys across all rule families.

        Also records the ops-mode token-splice hint consumed by
        CostModelService's parent-delta tokenization path. ``tok_copied``
        is the (usually broader) set of ops whose *token pair* (opcode +
        result shape) is unchanged: ops downstream of a rewrite must
        re-hash (their operand hashes changed) but still tokenize
        identically, so they splice. No reference to ``parent`` is kept
        — hashes resolve eagerly and the token hint is keyed by the
        parent's struct key."""
        if not _INCREMENTAL_HASHING:
            return
        ph = parent.value_hashes()
        self._inherited = {cv: ph[pv] for cv, pv in copied.items()}
        self._vhash = None
        self._key_cache = None
        if self.n_args == parent.n_args:
            # op j's result id is n_args + j for add_op-built graphs
            self._tok_delta = (parent.struct_key(), {
                cv - self.n_args: pv - parent.n_args
                for cv, pv in (tok_copied or copied).items()
                if cv >= self.n_args})

    def struct_key(self) -> str:
        """Canonical structural hash of the dataflow graph.

        Merkle-hashes every value through the use-def chains and combines
        the op-hash *multiset* with the output tuple. The key is
        therefore invariant under SSA id renumbering and under reordering
        of independent ops (any topological re-schedule), but
        distinguishes any change to an opcode, operand wiring, attribute,
        or tensor type. It is the canonical identity used by the
        CostModelService LRU, the server's in-flight dedup, and the
        opt.search frontier dedup.

        The finished key is cached on the graph; appending ops/args or
        reassigning ``outputs`` invalidates it (in-place edits to an
        existing Op after the first call do not — build-then-hash is the
        contract, and every rewrite builds a fresh graph). Rewrite-derived
        graphs inherit per-value hashes for verbatim-copied ops
        (:meth:`adopt_hashes`), so only the dirty cone is re-hashed."""
        if not _INCREMENTAL_HASHING:
            return self.struct_key_fresh()
        token = (len(self.ops), self.n_args, tuple(self.outputs))
        if self._key_cache is not None and self._key_cache[0] == token:
            return self._key_cache[1]
        key = self._combine_key(self.value_hashes())
        self._key_cache = (token, key)
        return key

    def struct_key_fresh(self) -> str:
        """From-scratch reference walk: ignores every memo and inherited
        hash (and caches nothing). The invariant incremental hashing must
        preserve — property tests compare against this — and the whole
        behavior when ``set_incremental_hashing(False)``."""
        return self._combine_key(self._compute_hashes({}))


# Op categories used by the analyzers (vector-ALU vs MXU vs memory ops).
# The opt rewrites additionally emit the synthetic FUSED_OP ("fused", with
# an n_fused attr counting its constituent elementwise ops); it is kept out
# of these sets so category membership stays paper-faithful — the analyzers
# model it explicitly.
FUSED_OP = "fused"
ELEMENTWISE = {"add", "sub", "mult", "div", "relu", "gelu", "silu", "tanh",
               "sigmoid", "exp", "neg", "abs", "maximum", "minimum", "rsqrt"}
REDUCTION = {"softmax", "layernorm", "batchnorm", "reduce_sum", "reduce_max",
             "reduce_mean"}
CONTRACTION = {"matmul", "conv2d", "depthwise_conv2d", "attention"}
DATA_MOVEMENT = {"reshape", "transpose", "concat", "slice", "broadcast",
                 "pool_max", "pool_avg", "upsample", "pad"}
ALL_OPCODES = sorted(ELEMENTWISE | REDUCTION | CONTRACTION | DATA_MOVEMENT)
