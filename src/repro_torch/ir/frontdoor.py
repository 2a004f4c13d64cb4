"""Real-MLIR front door: tolerant ingestion of lowered MLIR text.

This is the layer that lets the served cost model eat programs it did
not generate: StableHLO a framework lowered from a traced function,
affine/scf loop nests, arith, or the repo's own ``xpu`` printer output. Design
contract (the whole point of the module):

* **never raises on input.** Every entry point returns either a parsed
  :class:`IngestResult` or a structured :class:`IngestError` naming the
  stage that failed — malformed, truncated, or adversarial text is an
  expected input, not an exception path (the fuzz corpus in tests holds
  this property under hypothesis as well).
* **best-effort structural parse.** A line-oriented parser maps SSA ops
  onto the internal :class:`~repro_torch.ir.graph.Graph` (opcode-mapped into
  the ``xpu`` dialect where known, name-preserved otherwise). When no
  structure is recoverable but the text still lexes, ingestion degrades
  to the raw :func:`~repro_torch.core.tokenizer.tokenize_text` token stream —
  predictions still flow, keyed by a content hash of the tokens.
* **cache-compatible keys.** A parsed graph is keyed by its canonical
  ``struct_key()`` (so an ingested program and the same program built
  through the Graph API share LRU entries across the service, server,
  and replicated tier); the degraded path uses ``"text:" + sha1`` of
  the token stream, namespaced so it can never collide with a struct
  key (struct keys are 40 hex chars).

The serving integration (``predict_text`` on CostModelService /
CostModelServer) lives with each serving layer; this module owns
parsing, the error/result types, and the seeded fuzz-corpus generator
used by the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tokenizer as TOK
from repro_torch.ir.graph import Graph, Tensor


# ------------------------------------------------------------ result types
@dataclass
class IngestError:
    """Structured ingestion failure; returned, never raised.

    ``stage`` says how far the text got: ``empty`` (no input), ``lex``
    (nothing tokenizable), ``parse`` (reserved for callers that require
    a structural graph), ``encode`` / ``predict`` (set by the serving
    layers when vocabulary or forward-pass handling fails)."""

    stage: str
    reason: str
    detail: str = ""

    def __repr__(self) -> str:  # compact: shows up in bench/CLI output
        d = f" ({self.detail})" if self.detail else ""
        return f"IngestError[{self.stage}] {self.reason}{d}"


@dataclass
class IngestResult:
    """A successfully ingested text: either a structural graph (with
    its canonical struct key) or the degraded token-stream form."""

    key: str                     # struct_key or "text:"+sha1(tokens)
    tokens: List[str]            # raw lexed tokens (fallback stream)
    graph: Optional[Graph]       # None -> token-stream-only ingestion
    dialects: Tuple[str, ...]    # dialect prefixes seen (sorted)
    n_ops: int                   # structural ops recovered (0 if none)


@dataclass
class TextEntry:
    """A featurized text: the ids-first batch entry plus ingest stats.

    Produced by ``CostModelService.ingest_text`` — ``(key, ids)`` slots
    straight into ``predict_entries`` / ``submit_entry`` / the replica
    wire format, so every cache layer treats ingested text exactly like
    a Graph submit."""

    key: str
    ids: "np.ndarray"
    n_tokens: int
    oov_rate: float              # fraction of tokens outside the vocab
    unk_rate: float              # fraction of ids collapsed to <unk>
    dialects: Tuple[str, ...] = ()
    n_ops: int = 0               # 0 -> token-stream fallback path


@dataclass
class TextPrediction:
    """predict_text() payload: denormalized predictions + ingest stats."""

    predictions: Dict[str, float]
    key: str
    n_tokens: int
    oov_rate: float              # fraction of tokens outside the vocab
    unk_rate: float              # fraction of ids collapsed to <unk>
    dialects: Tuple[str, ...] = ()
    n_ops: int = 0               # 0 -> token-stream fallback path


def prediction_from(entry: TextEntry,
                    predictions: Dict[str, float]) -> TextPrediction:
    """Attach denormalized head predictions to a featurized entry —
    shared by the service, the async server, and the replica client so
    all three tiers return identical payload shapes."""
    return TextPrediction(predictions=predictions, key=entry.key,
                          n_tokens=entry.n_tokens,
                          oov_rate=entry.oov_rate,
                          unk_rate=entry.unk_rate,
                          dialects=entry.dialects, n_ops=entry.n_ops)


# ------------------------------------------------------------- the parser
# `%out = "dialect.op"(...)` (generic) or `%out = dialect.op ...`
# (pretty). Multi-result ops (`%0:2 = ...`) keep one result value.
_OP_RE = re.compile(
    r'^\s*%([A-Za-z0-9_]+)(?::\d+)?\s*=\s*'
    r'(?:"([A-Za-z_][\w$.]*)"|([A-Za-z_]\w*\.[\w.]+))\s*(.*)$')
_TYPE_RE = re.compile(r"(?:tensor|memref|vector)<([^>]*)>")
_OPERAND_RE = re.compile(r"%([A-Za-z0-9_]+)")
_RETURN_RE = re.compile(r"^\s*(?:func\.)?return\b(.*)$")
_SCALAR_DTYPES = ("bf16", "f64", "f32", "f16",
                  "i64", "i32", "i16", "i8", "i1")

# Known op-name -> xpu opcode translations (StableHLO / arith / math /
# the repo's own printer). Unknown names keep their bare op name, which
# the OOV-extended tokenizer resolves to shard/byte ids instead of a
# single <unk>.
OPCODE_MAP = {
    "dot_general": "matmul", "dot": "matmul", "einsum": "matmul",
    "convolution": "conv2d", "conv": "conv2d",
    "add": "add", "addf": "add", "addi": "add",
    "subtract": "sub", "subf": "sub", "subi": "sub",
    "multiply": "mult", "mulf": "mult", "muli": "mult",
    "divide": "div", "divf": "div", "divi": "div",
    "maximum": "maximum", "maxf": "maximum", "maximumf": "maximum",
    "minimum": "minimum", "minf": "minimum",
    "exponential": "exp", "exp": "exp", "negate": "neg", "abs": "abs",
    "tanh": "tanh", "logistic": "sigmoid", "rsqrt": "rsqrt",
    "sqrt": "rsqrt", "power": "exp",
    "reduce": "reduce_sum", "reduce_sum": "reduce_sum",
    "reduce_max": "reduce_max", "reduce_window": "pool_max",
    "broadcast_in_dim": "broadcast", "broadcast": "broadcast",
    "reshape": "reshape", "transpose": "transpose",
    "concatenate": "concat", "slice": "slice",
    "dynamic_slice": "slice", "pad": "pad", "select": "maximum",
    "load": "slice", "store": "pad",      # affine/memref data movement
}


def _parse_type(txt: str) -> Tensor:
    """Best-effort Tensor from one MLIR type spelling. Dynamic dims
    (``?``) become 1; unknown element types ride through as-is (the
    Graph layer is dtype-string tolerant)."""
    m = _TYPE_RE.search(txt)
    if m:
        parts = [p for p in m.group(1).split("x") if p]
        dims: List[int] = []
        dtype = "f32"
        for p in parts:
            if p.isdigit():
                dims.append(int(p))
            elif p == "?":
                dims.append(1)
            else:
                dtype = p.split(" ")[0].strip()
        return Tensor(tuple(dims), dtype)
    for d in _SCALAR_DTYPES:
        if re.search(rf"\b{d}\b", txt):
            return Tensor((), d)
    return Tensor((), "f32")


def _xpu_opcode(raw: str) -> str:
    """Map ``dialect.op`` onto an xpu opcode; unknown names keep the
    sanitized op name (OOV-safe downstream)."""
    name = raw.rsplit(".", 1)[-1]
    return OPCODE_MAP.get(name, name)


def _signature_args(text: str) -> List[Tuple[str, Tensor]]:
    """(%name, type) pairs from func.func signatures (possibly spanning
    lines). Tolerant: a missing/garbled signature just yields []."""
    args: List[Tuple[str, Tensor]] = []
    for m in re.finditer(r"func\.func[^{]*", text):
        sig = m.group(0)
        for am in re.finditer(
                r"%([A-Za-z0-9_]+):\s*((?:tensor|memref|vector)<[^>]*>"
                r"|[a-z]\w*)", sig):
            args.append((am.group(1), _parse_type(am.group(2))))
    return args


def parse_mlir(text: str) -> Optional[Graph]:
    """Best-effort structural parse of MLIR text into a Graph.

    Returns None when no SSA ops are recoverable (callers fall back to
    the token stream). Never raises: unparsable lines are skipped,
    unknown operand references are dropped from the op's operand list,
    and region ops (reduce bodies etc.) flatten into the op sequence.
    """
    try:
        g = Graph(name="ingested")
        env: Dict[str, int] = {}
        for name, t in _signature_args(text):
            if name not in env:
                env[name] = g.add_arg(t)
        returns: List[str] = []
        for line in text.splitlines():
            rm = _RETURN_RE.match(line)
            if rm:
                returns.extend(_OPERAND_RE.findall(rm.group(1)))
                continue
            m = _OP_RE.match(line)
            if m is None:
                continue
            out_name = m.group(1)
            raw_op = m.group(2) or m.group(3)
            rest = m.group(4)
            # operands: %refs before the trailing type annotation
            head = rest.split(" : ")[0]
            operands = [env[r] for r in _OPERAND_RE.findall(head)
                        if r in env]
            # result type: prefer the type after ->, else the last
            # type in the line, else scalar f32
            arrow = rest.rsplit("->", 1)
            t = _parse_type(arrow[1] if len(arrow) == 2 else rest)
            if out_name in env:          # redefinition (regions): skip
                continue
            env[out_name] = g.add_op(_xpu_opcode(raw_op), operands, t)
        if not g.ops:
            return None
        outs = [env[r] for r in returns if r in env]
        g.outputs = outs or [g.ops[-1].result]
        g.validate()
        return g
    except Exception:
        return None


def _dialects(text: str) -> Tuple[str, ...]:
    seen = set(re.findall(
        r"\b(stablehlo|mhlo|affine|scf|arith|math|func|memref|linalg"
        r"|xpu|chlo|vhlo)\.", text))
    return tuple(sorted(seen))


def text_key(tokens: Sequence[str]) -> str:
    """Cache key for token-stream-only ingestion: content hash of the
    lexed stream (whitespace/formatting mutations collapse onto one
    entry), namespaced so it can't collide with 40-hex struct keys."""
    h = hashlib.sha1("\x00".join(tokens).encode("utf-8")).hexdigest()
    return f"text:{h}"


def ingest(text) -> "IngestResult | IngestError":
    """Parse arbitrary MLIR-ish text. Never raises.

    Structural parse first; token-stream fallback second; only inputs
    with no lexable content at all come back as an IngestError."""
    try:
        if not isinstance(text, str):
            if isinstance(text, (bytes, bytearray)):
                text = bytes(text).decode("utf-8", "replace")
            else:
                return IngestError("empty", "input is not text",
                                   type(text).__name__)
        if not text.strip():
            return IngestError("empty", "no input text")
        tokens = TOK.tokenize_text(text)
        # tokenize_text always adds BOS/EOS; anything else is content
        if len(tokens) <= 2:
            return IngestError("lex", "no tokenizable content",
                               f"{len(text)} chars")
        g = parse_mlir(text)
        if g is not None:
            return IngestResult(key=g.struct_key(), tokens=tokens,
                                graph=g, dialects=_dialects(text),
                                n_ops=len(g.ops))
        return IngestResult(key=text_key(tokens), tokens=tokens,
                            graph=None, dialects=_dialects(text),
                            n_ops=0)
    except Exception as e:      # absolute backstop: still structured
        return IngestError("lex", type(e).__name__, str(e)[:200])


# --------------------------------------------------------- example corpus
# A hand-written affine/scf loop nest: parser coverage for the paper's
# "lower-level dialects produce much larger sequences" scenario and a
# seed for dialect-mixing fuzz (nothing in the jnp pool lowers to
# affine, so this keeps that dialect exercised honestly).
AFFINE_EXAMPLE = """\
module {
  func.func @saxpy(%arg0: memref<256xf32>, %arg1: memref<256xf32>,
                   %arg2: f32) {
    affine.for %i = 0 to 256 {
      %0 = affine.load %arg0[%i] : memref<256xf32>
      %1 = affine.load %arg1[%i] : memref<256xf32>
      %2 = arith.mulf %0, %arg2 : f32
      %3 = arith.addf %2, %1 : f32
      affine.store %3, %arg1[%i] : memref<256xf32>
    }
    return
  }
  func.func @tile(%arg0: memref<64x64xf32>, %arg1: memref<64x64xf32>) {
    %c0 = arith.constant 0 : index
    scf.for %i = %c0 to %c0 step %c0 {
      %0 = affine.load %arg0[%i, %i] : memref<64x64xf32>
      %1 = arith.mulf %0, %0 : f32
      %2 = math.tanh %1 : f32
      affine.store %2, %arg1[%i, %i] : memref<64x64xf32>
    }
    return
  }
}
"""


# ------------------------------------------------------------ fuzz corpus
def mutate_text(text: str, rng: np.random.Generator) -> str:
    """One random mutation: truncation, byte substitution, line
    shuffling, char deletion, garbage injection, or dialect splicing."""
    kind = int(rng.integers(0, 7))
    if not text:
        return text
    if kind == 0:                               # hard truncation
        return text[: int(rng.integers(0, len(text)))]
    if kind == 1:                               # byte substitutions
        b = bytearray(text.encode("utf-8"))
        for _ in range(int(rng.integers(1, 8))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        return b.decode("utf-8", "replace")
    if kind == 2:                               # shuffle lines
        lines = text.splitlines()
        rng.shuffle(lines)
        return "\n".join(lines)
    if kind == 3:                               # delete a char span
        i = int(rng.integers(0, len(text)))
        j = min(len(text), i + int(rng.integers(1, 64)))
        return text[:i] + text[j:]
    if kind == 4:                               # garbage injection
        junk = "".join(chr(int(c)) for c in rng.integers(1, 0x2FF, 16))
        i = int(rng.integers(0, len(text)))
        return text[:i] + junk + text[i:]
    if kind == 5:                               # dialect mixing
        lines = text.splitlines()
        extra = AFFINE_EXAMPLE.splitlines()
        i = int(rng.integers(0, len(lines) + 1))
        return "\n".join(lines[:i] + extra + lines[i:])
    return text + text[: int(rng.integers(0, len(text)))]  # duplication


def fuzz_corpus(seed_texts: Sequence[str], n: int,
                rng: np.random.Generator) -> List[str]:
    """``n`` mutated inputs from ``seed_texts``: every mutation kind
    above, stacked 1-3 deep, plus the degenerate empties. Deterministic
    given the rng state — tests and the bench share seeds."""
    out: List[str] = ["", " \n\t ", "\x00\xff\xfe", "%"]
    seeds = [s for s in seed_texts if s] or [AFFINE_EXAMPLE]
    while len(out) < n:
        t = seeds[int(rng.integers(0, len(seeds)))]
        for _ in range(int(rng.integers(1, 4))):
            t = mutate_text(t, rng)
        out.append(t)
    return out[:n]
