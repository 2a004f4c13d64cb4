"""Rewrite-rule registry over the ``xpu`` dataflow IR.

Each rule implements the uniform :class:`Rewrite` interface —
``applicable(g) -> [Site]`` enumerates every location the rule can fire,
``apply(g, site) -> Graph`` fires it at one location — and every ``apply``
passes through :func:`check_legal`: the result must be ``validate()``-clean
with output shapes (and, unless the rule is an explicit precision
tradeoff, dtypes) preserved, plus an optional oracle-equivalence hook for
stronger semantic checks.

Shipped rules (the paper's §1 graph-level optimizations):

* ``fuse_elementwise`` — producer→consumer elementwise chains collapse
  into ONE ``xpu.fused`` op carrying ``n_fused``/``chain`` attrs, so the
  tokenizer emits visibly different IR for fused programs and the
  analyzers charge one HBM round trip instead of one per constituent.
* ``cse``       — dedup structurally-identical ops (same opcode, operands,
  attrs, result type), rewiring uses onto the first occurrence.
* ``dce``       — drop ops whose result is never used (and not an output).
* ``recompute`` — duplicate a cheap (elementwise) multi-consumer producer
  per consumer: recompute-vs-materialize, the enabling move for fusion
  across what used to be a fan-out point.
* ``dtype_narrow`` — narrow f32 *intermediates* to bf16 (graph outputs
  keep their dtype): halves the HBM traffic the roofline oracle charges.
* ``unroll``    — replicate the body (shared args) as an unrolled inner
  loop would look to the cost model; output count scales by the factor,
  so this rule alone opts out of exact output preservation.

Sites discovered on a graph are only valid on that exact graph — a
search applies one site, then re-enumerates on the rewritten result.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.ir.graph import ELEMENTWISE, FUSED_OP, Graph, Op, Tensor


class Site:
    """One applicable rewrite location.

    ``detail`` is rule-specific (op indices, factors); ``weight`` is the
    objective's latency divisor (an unroll by f does f iterations' work,
    so its per-iteration latency is latency/f)."""

    __slots__ = ("rule", "detail", "weight")

    def __init__(self, rule: str, detail: Tuple = (), weight: float = 1.0):
        self.rule = rule
        self.detail = tuple(detail)
        self.weight = float(weight)

    def __repr__(self) -> str:
        return f"{self.rule}{self.detail}"


def use_counts(g: Graph) -> Dict[int, int]:
    """SSA id -> number of uses (operand slots + graph outputs)."""
    uses: Dict[int, int] = {}
    for op in g.ops:
        for o in op.operands:
            uses[o] = uses.get(o, 0) + 1
    for o in g.outputs:
        uses[o] = uses.get(o, 0) + 1
    return uses


def producers(g: Graph) -> Dict[int, int]:
    """SSA id -> index of the op producing it (args absent)."""
    return {op.result: i for i, op in enumerate(g.ops)}


def _clone_args(g: Graph, name: str) -> Tuple[Graph, Dict[int, int]]:
    new = Graph(name=name)
    new.values = list(g.values[:g.n_args])
    new.n_args = g.n_args
    return new, {i: i for i in range(g.n_args)}


def _seq_layout(g: Graph) -> bool:
    """True when op ``i`` produces value ``n_args + i`` — the layout every
    ``add_op``/``_Derive``-built graph has. Checked once and memoized on
    the graph; the bulk prefix-sharing fast path below requires it."""
    v = getattr(g, "_seq_layout_ok", None)
    if v is None:
        na = g.n_args
        v = all(op.result == na + i for i, op in enumerate(g.ops))
        g._seq_layout_ok = v
    return v


class _Derive:
    """Build a graph derived from a parent while tracking which new ops
    are *verbatim copies* of parent ops (same opcode/attrs/result type,
    operands remapped onto values that are themselves verbatim copies).

    On :meth:`finish` the copy map is handed to ``Graph.adopt_hashes``,
    so the child's ``struct_key()`` inherits the parent's per-value
    hashes and re-hashes only the rewrite's dirty cone — the incremental
    hot path a beam search over candidates lives on. The same map feeds
    the serving layer's parent-delta tokenization (unchanged op token
    spans are sliced from the parent's cached ids, not re-lexed)."""

    __slots__ = ("parent", "new", "id_map", "copied", "tok_copied")

    def __init__(self, g: Graph, name: Optional[str] = None):
        self.parent = g
        self.new, self.id_map = _clone_args(
            g, g.name if name is None else name)
        # child value id -> parent value id with identical structural hash
        self.copied: Dict[int, int] = {i: i for i in range(g.n_args)}
        # child value id -> parent value id with identical ops-mode token
        # pair (opcode + result shape): a superset of ``copied`` — ops
        # downstream of a rewrite re-hash but still tokenize identically
        self.tok_copied: Dict[int, int] = dict(self.copied)

    def copy(self, op, remap: bool = True) -> int:
        """Emit a verbatim copy of a parent op. ``remap=False`` leaves
        ``id_map`` alone (recompute's private duplicate clones).

        This is the single hottest loop of the whole search (it runs
        once per surviving op per candidate), so it bypasses
        ``Graph.add_op`` — no operand re-copy, no kwargs splat — and
        SHARES the parent op's attrs dict: ops are immutable once built
        (the ``struct_key`` contract), so aliasing is safe."""
        id_map, new, copied = self.id_map, self.new, self.copied
        new.values.append(self.parent.values[op.result])
        nid = len(new.values) - 1
        # hash-clean only if every operand is itself a clean copy of the
        # SAME parent value — otherwise the op re-hashes (conservative)
        clean = True
        operands = []
        for o in op.operands:
            m = id_map[o]
            operands.append(m)
            if clean and copied.get(m) != o:
                clean = False
        new.ops.append(Op(op.opcode, operands, nid, op.attrs))
        if clean:
            copied[nid] = op.result
        self.tok_copied[nid] = op.result
        if remap:
            id_map[op.result] = nid
        return nid

    def copy_prefix(self, k: int) -> None:
        """Bulk-share the first *k* parent ops verbatim.

        Until the first rewrite site, the copy map is the identity — a
        per-op :meth:`copy` would append the same value, remap every
        operand to itself, and rebuild an identical ``Op``. When the
        parent has the sequential ``add_op`` layout and nothing has been
        emitted yet, the whole prefix can instead be list-sliced in and
        the parent ``Op`` objects SHARED outright (ops are immutable once
        built — the ``struct_key`` contract — so aliasing whole ops is as
        safe as aliasing their attrs). Profiles put per-op copying at
        ~half of steady-state search time; this turns the untouched
        prefix into a few C-level slice/update calls."""
        if k <= 0:
            return
        p, new = self.parent, self.new
        na = p.n_args
        if new.ops or not _seq_layout(p):
            for op in p.ops[:k]:           # rare fallback: odd layouts
                self.copy(op)
            return
        new.values.extend(p.values[na:na + k])
        new.ops.extend(p.ops[:k])
        ids = range(na, na + k)
        ident = dict(zip(ids, ids))
        self.id_map.update(ident)
        self.copied.update(ident)
        self.tok_copied.update(ident)

    def emit(self, opcode: str, operands, out, **attrs) -> int:
        """Emit a fresh (rewritten) op; its hash is always recomputed.
        Inlines ``Graph.add_op`` (same layout) — emit runs once per
        rewritten op per candidate, so the extra call + kwargs re-splat
        showed up in search profiles."""
        new = self.new
        new.values.append(out)
        nid = len(new.values) - 1
        new.ops.append(Op(opcode, list(operands), nid, attrs))
        return nid

    def alias(self, parent_vid: int, child_vid: int) -> None:
        """Map a parent value onto an existing child value (CSE dedup)."""
        self.id_map[parent_vid] = child_vid

    def finish(self, *, preserve_outputs: bool = True,
               oracle_check=None) -> Graph:
        self.new.outputs = [self.id_map[o] for o in self.parent.outputs]
        self.new.adopt_hashes(self.parent, self.copied, self.tok_copied)
        return check_legal(self.parent, self.new,
                           preserve_outputs=preserve_outputs,
                           oracle_check=oracle_check)


def check_legal(old: Graph, new: Graph, *, preserve_outputs: bool = True,
                oracle_check: Optional[Callable[[Graph, Graph], bool]]
                = None) -> Graph:
    """Legality gate every ``apply`` returns through: SSA-valid, and (for
    output-preserving rules) the same number of outputs with unchanged
    shape and dtype. ``oracle_check(old, new)`` is the pluggable
    equivalence hook — e.g. analyzer-target non-increase for CSE/DCE, or
    a numeric executor when one exists."""
    new.validate()
    if preserve_outputs:
        assert len(new.outputs) == len(old.outputs), \
            f"output arity changed: {len(old.outputs)}->{len(new.outputs)}"
        for a, b in zip(old.outputs, new.outputs):
            ta, tb = old.values[a], new.values[b]
            assert ta.shape == tb.shape, f"output shape {ta}->{tb}"
            assert ta.dtype == tb.dtype, f"output dtype {ta}->{tb}"
    if oracle_check is not None:
        assert oracle_check(old, new), "oracle-equivalence check failed"
    return new


class Rewrite:
    """Uniform rewrite interface; subclasses are stateless and shared."""

    name: str = "rewrite"
    # False: the rule changes intermediate dtypes (precision tradeoff)
    preserves_dtypes: bool = True
    # False: the rule may change output arity (unroll replicates outputs)
    preserves_outputs: bool = True

    def applicable(self, g: Graph) -> List[Site]:
        raise NotImplementedError

    def apply(self, g: Graph, site: Site) -> Graph:
        raise NotImplementedError


REGISTRY: Dict[str, Rewrite] = {}


def register(cls):
    """Class decorator: instantiate (default construction) and register."""
    inst = cls()
    REGISTRY[inst.name] = inst
    return cls


def default_rules() -> List[Rewrite]:
    """Every registered rule, in stable (name) order."""
    return [REGISTRY[k] for k in sorted(REGISTRY)]


# ------------------------------------------------------------------ fusion
def _fusable(op) -> bool:
    return op.opcode in ELEMENTWISE or op.opcode == FUSED_OP


def _chain_parts(op) -> List[str]:
    if op.opcode == FUSED_OP:
        return str(op.attrs.get("chain", FUSED_OP)).split("|")
    return [op.opcode]


@register
class FuseElementwise(Rewrite):
    """Collapse a producer→consumer elementwise chain into one ``fused``
    op. A chain extends through unary elementwise/fused consumers whose
    operand has exactly one use; the head may be any elementwise op (its
    operands become the fused op's operands)."""

    name = "fuse_elementwise"

    def chains(self, g: Graph) -> List[List[int]]:
        uses, prod = use_counts(g), producers(g)
        chains: List[List[int]] = []
        chain_of: Dict[int, List[int]] = {}
        for i, op in enumerate(g.ops):
            if not (_fusable(op) and len(op.operands) == 1):
                continue
            src = op.operands[0]
            j = prod.get(src)
            if j is None or not _fusable(g.ops[j]) or uses.get(src) != 1:
                continue
            ch = chain_of.get(j)
            if ch is None:
                ch = [j]
                chains.append(ch)
                chain_of[j] = ch
            ch.append(i)
            chain_of[i] = ch
        return chains

    def applicable(self, g: Graph) -> List[Site]:
        return [Site(self.name, tuple(ch)) for ch in self.chains(g)]

    def apply(self, g: Graph, site: Site) -> Graph:
        return _fuse(g, [list(site.detail)])


def _fuse(g: Graph, chains: List[List[int]]) -> Graph:
    members = {i for ch in chains for i in ch}
    last = {ch[-1]: ch for ch in chains}
    b = _Derive(g, g.name if g.name.endswith("_fused")
                else g.name + "_fused")
    first = min(members)
    b.copy_prefix(first)
    for i in range(first, len(g.ops)):
        op = g.ops[i]
        if i in members and i not in last:
            continue
        if i in last:
            ch = last[i]
            head = g.ops[ch[0]]
            parts = [p for j in ch for p in _chain_parts(g.ops[j])]
            nid = b.emit(FUSED_OP,
                         [b.id_map[o] for o in head.operands],
                         g.values[op.result],
                         n_fused=len(parts), chain="|".join(parts))
            b.id_map[op.result] = nid
        else:
            b.copy(op)
    return b.finish()


def fuse_elementwise(g: Graph) -> Graph:
    """Fuse every producer→consumer elementwise chain into single
    ``xpu.fused`` ops (each carrying ``n_fused`` + ``chain`` attrs), the
    graph-level operator-fusion transform. Runs to fixpoint; a graph with
    no chains is returned as a (renamed) structural copy."""
    rule: FuseElementwise = REGISTRY["fuse_elementwise"]  # type: ignore
    out = g
    for _ in range(4):                 # chains are maximal; 1 pass + slack
        chains = rule.chains(out)
        if not chains:
            break
        out = _fuse(out, chains)
    return out


# --------------------------------------------------------------------- CSE
def _op_signature(g: Graph, op) -> Tuple:
    return (op.opcode, tuple(op.operands),
            tuple(sorted(op.attrs.items())), g.values[op.result])


@register
class CommonSubexpression(Rewrite):
    """Dedup structurally-identical ops: same opcode, same operand ids,
    same attrs, same result type. Transitively-equal subtrees converge
    under repeated application (each merge makes the parents' operand
    lists equal)."""

    name = "cse"

    def applicable(self, g: Graph) -> List[Site]:
        seen: Dict[Tuple, int] = {}
        sites = []
        for i, op in enumerate(g.ops):
            sig = _op_signature(g, op)
            if sig in seen:
                sites.append(Site(self.name, (i, seen[sig])))
            else:
                seen[sig] = i
        return sites

    def apply(self, g: Graph, site: Site) -> Graph:
        dup, canon = site.detail
        assert _op_signature(g, g.ops[dup]) == \
            _op_signature(g, g.ops[canon]), "stale CSE site"
        b = _Derive(g)
        b.copy_prefix(dup)
        b.alias(g.ops[dup].result, b.id_map[g.ops[canon].result])
        for op in g.ops[dup + 1:]:
            b.copy(op)
        return b.finish()


# --------------------------------------------------------------------- DCE
@register
class DeadOpElimination(Rewrite):
    """Drop an op whose result has no uses and is not a graph output."""

    name = "dce"

    def applicable(self, g: Graph) -> List[Site]:
        uses = use_counts(g)
        return [Site(self.name, (i,)) for i, op in enumerate(g.ops)
                if uses.get(op.result, 0) == 0]

    def apply(self, g: Graph, site: Site) -> Graph:
        (dead,) = site.detail
        b = _Derive(g)
        b.copy_prefix(dead)
        for op in g.ops[dead + 1:]:
            b.copy(op)
        return b.finish()


# --------------------------------------------------- recompute vs materialize
@register
class RecomputeCheapProducer(Rewrite):
    """Give each consumer of a cheap (elementwise) fan-out producer its
    own private copy. Alone this adds arithmetic; its value is that each
    copy is single-use, so fusion can then swallow it into its consumer
    — the classic recompute-instead-of-materialize tradeoff, discovered
    by the *search over sequences* rather than any one-shot advisor."""

    name = "recompute"

    def applicable(self, g: Graph) -> List[Site]:
        # one pass over operand slots (distinct consumer OPS per value),
        # not a per-op rescan of the whole op list — applicable() runs
        # for every frontier parent on every expansion, so the old
        # O(n_ops^2) walk was a measurable share of search wall time
        consumers: Dict[int, set] = {}
        for j, c in enumerate(g.ops):
            for o in c.operands:
                consumers.setdefault(o, set()).add(j)
        return [Site(self.name, (i,)) for i, op in enumerate(g.ops)
                if _fusable(op) and len(consumers.get(op.result, ())) >= 2]

    def apply(self, g: Graph, site: Site) -> Graph:
        (pi,) = site.detail
        prod = g.ops[pi]
        consumers = [j for j, c in enumerate(g.ops)
                     if prod.result in c.operands]
        assert len(consumers) >= 2, "stale recompute site"
        b = _Derive(g)
        dup_consumers = set(consumers[1:])
        first = consumers[1]
        b.copy_prefix(first)
        for i in range(first, len(g.ops)):
            op = g.ops[i]
            if i in dup_consumers:
                # the private clone is itself a verbatim copy of the
                # producer (hash-identical); the consumer re-hashes
                clone = b.copy(prod, remap=False)
                operands = [clone if o == prod.result else b.id_map[o]
                            for o in op.operands]
                b.id_map[op.result] = b.emit(
                    op.opcode, operands, g.values[op.result], **op.attrs)
            else:
                b.copy(op)
        return b.finish()


# ---------------------------------------------------------- dtype narrowing
@register
class DtypeNarrow(Rewrite):
    """Narrow every f32 *intermediate* (op results that are not graph
    outputs) to bf16. Graph outputs keep their shape AND dtype, so the
    interface is preserved; the tokenizer emits ``...xbf16`` shape tokens
    for the narrowed values, and the roofline oracle charges half the
    HBM bytes for them."""

    name = "dtype_narrow"
    preserves_dtypes = False

    def applicable(self, g: Graph) -> List[Site]:
        outs = set(g.outputs)
        if any(op.result not in outs
               and g.values[op.result].dtype == "f32" for op in g.ops):
            return [Site(self.name)]
        return []

    def apply(self, g: Graph, site: Site) -> Graph:
        outs = set(g.outputs)
        b = _Derive(g)
        ops, n = g.ops, len(g.ops)
        first = 0
        while first < n:
            t = g.values[ops[first].result]
            if ops[first].result not in outs and t.dtype == "f32":
                break
            first += 1
        b.copy_prefix(first)
        for op in ops[first:]:
            t = g.values[op.result]
            if op.result not in outs and t.dtype == "f32":
                b.id_map[op.result] = b.emit(
                    op.opcode, [b.id_map[o] for o in op.operands],
                    Tensor(t.shape, "bf16"), **op.attrs)
            else:
                b.copy(op)
        return b.finish()


# ------------------------------------------------------------------ unroll
def unroll_graph(g: Graph, factor: int) -> Graph:
    """Model loop unrolling of the graph body: replicate ops with renamed
    SSA ids (shared args), as an unrolled inner loop would look to the
    cost model. Every replica op is a verbatim copy of its original, so
    the unrolled graph's struct_key inherits all per-value hashes and
    re-hashes nothing."""
    new = Graph(name=f"{g.name}_u{factor}")
    new.values = list(g.values[:g.n_args])
    new.n_args = g.n_args
    copied = {i: i for i in range(g.n_args)}
    outs = []
    na, k = g.n_args, len(g.values) - g.n_args
    seq = _seq_layout(g)
    for rep in range(factor):
        if seq and rep == 0:
            # replica 0 is an identity copy: bulk-share the parent ops
            # (immutable) instead of re-building them one by one
            new.values.extend(g.values[na:])
            new.ops.extend(g.ops)
            ids = range(na, len(g.values))
            copied.update(zip(ids, ids))
            outs.extend(g.outputs)
            continue
        if seq:
            # replica r's ids are the parent's shifted by a constant
            # rep*k (op i yields value na+i), so operand renaming is
            # arithmetic — no per-op id_map dict
            off = rep * k
            new.values.extend(g.values[na:])
            new.ops.extend(
                Op(op.opcode,
                   [o if o < na else o + off for o in op.operands],
                   op.result + off, op.attrs)
                for op in g.ops)
            copied.update(zip(range(na + off, na + off + k),
                              range(na, na + k)))
            outs.extend(o if o < na else o + off for o in g.outputs)
            continue
        id_map = {i: i for i in range(na)}
        for op in g.ops:
            # fast verbatim copy (see _Derive.copy): attrs dict shared,
            # no add_op overhead — every replica op is a clean copy
            new.values.append(g.values[op.result])
            nid = len(new.values) - 1
            new.ops.append(Op(op.opcode,
                              [id_map[o] for o in op.operands], nid,
                              op.attrs))
            id_map[op.result] = nid
            copied[nid] = op.result
        outs.extend(id_map[o] for o in g.outputs)
    new.outputs = outs
    new.adopt_hashes(g, copied)
    new.validate()
    return new


@register
class Unroll(Rewrite):
    """Unroll the body by a factor; per-replica outputs keep the original
    shapes, so Site.weight = factor lets an objective judge per-iteration
    cost. ``max_ops`` bounds the unrolled size (None disables)."""

    name = "unroll"
    preserves_outputs = False

    def __init__(self, factors: Tuple[int, ...] = (2, 4),
                 max_ops: Optional[int] = 64):
        self.factors = tuple(factors)
        self.max_ops = max_ops

    def applicable(self, g: Graph) -> List[Site]:
        return [Site(self.name, (f,), weight=f) for f in self.factors
                if g.ops and (self.max_ops is None
                              or len(g.ops) * f <= self.max_ops)]

    def apply(self, g: Graph, site: Site) -> Graph:
        (factor,) = site.detail
        return check_legal(g, unroll_graph(g, factor),
                           preserve_outputs=False)


# ------------------------------------------------------- corpus augmentation
def random_rewrite(g: Graph, rng, rules: Optional[List[Rewrite]] = None,
                   max_steps: int = 3) -> Graph:
    """Apply 1..max_steps randomly-chosen legal rewrites (uniform over
    *rules* first, then over that rule's sites, so rare rules stay
    represented). Deterministic given the rng state — the dataset
    builder's two-pass count-then-encode contract — and the way fused /
    bf16 IR text gets into training corpora (and hence the vocab)."""
    rules = list(rules) if rules is not None else default_rules()
    out = g
    for _ in range(int(rng.integers(1, max_steps + 1))):
        firing = [(r, s) for r in rules
                  for s in [r.applicable(out)] if s]
        if not firing:
            break
        rule, sites = firing[int(rng.integers(0, len(firing)))]
        out = rule.apply(out, sites[int(rng.integers(0, len(sites)))])
    return out
