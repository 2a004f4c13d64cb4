"""Divisibility-aware logical-axis sharding resolver over a DeviceMesh.

Logical tensor axes (``"batch"``, ``"vocab"``, ``"heads"``, ``"ffn"``,
``"experts"``, ``"seq"``, ``"embed"``, ...) are mapped to mesh axes by a
rule table. A mesh axis is *dropped* (falls back to replication for that
dim) when the dimension size is not divisible by the mesh axis size: one
rule table then serves every architecture (e.g. 40 attention heads cannot
shard over a 16-way ``model`` axis; the resolver drops it and the
context-parallel ``seq`` rule picks up the parallelism instead).

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names``. :meth:`ShardingRules.spec` gives the reference's
per-tensor-dim answer as a plain tuple (``None``, a mesh axis name, or a
tuple of names for a dim split over several axes);
:meth:`ShardingRules.placements` turns it into DTensor placements, one per
mesh dim: a mesh dim that a tensor dim claims is ``Shard(d)``, an
unclaimed one ``Replicate()``.

A dim split over several mesh axes is split by DTensor in mesh-dim order
(the first mesh dim outermost), while the reference splits it in the
order its spec lists the axes. The two agree only when the spec lists
the axes in mesh order, so :meth:`placements` raises otherwise instead of
placing the tensor another way.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

AxisRule = Union[None, str, Tuple[str, ...]]

# Default logical->mesh rules. 'pod' composes with 'data' for the batch dim
# so the same table serves single-pod (no 'pod' axis) and multi-pod meshes.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # batch spreads over the model axis too when divisible (wide DP): the
    # §Perf hillclimb showed per-layer TP activation collectives dominate
    # train steps at every model size (0.6B..52B), while weight gathers
    # (FSDP, from the 2D param sharding below) are smaller and overlappable.
    # Smaller batches (prefill 32, decode 128) gracefully fall back to
    # data-only sharding via the divisibility resolver.
    "batch":   ("pod", "data", "model"),
    "vocab":   ("model",),
    "heads":   ("model",),      # q heads
    "kv_heads": ("model",),     # usually dropped (kv < 16) -> replicated
    "ffn":     ("model",),
    "experts": ("model",),
    "embed":   ("data",),       # d_model dim of PARAMS: FSDP-style 2D
                                # sharding (model x data) so 30-50B param
                                # + optimizer states fit 16 GB/chip; on
                                # activations the batch dim claims "data"
                                # first, so h stays batch-sharded
    "seq":     (),              # train/prefill seq: context-parallel override
    "cache_seq": ("model",),    # decode KV-cache sequence dim
    "qseq":    ("model",),      # query-seq context parallelism: picks up the
                                # model axis when head sharding can't (the
                                # attention layer gates this on divisibility)
    "conv_seq": (),
    "stack":   (),              # scanned-layer leading dim: never sharded
}

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


class ShardingRules:
    """Resolves logical axis names to per-dim specs and DTensor placements
    on a concrete mesh."""

    def __init__(self, mesh, overrides: Optional[Dict[str, AxisRule]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if overrides:
            for k, v in overrides.items():
                if v is None:
                    self.rules[k] = ()
                elif isinstance(v, str):
                    self.rules[k] = (v,)
                else:
                    self.rules[k] = tuple(v)
        if mesh.mesh_dim_names is None:
            raise ValueError("ShardingRules needs a DeviceMesh with "
                             "mesh_dim_names")
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.axis_sizes = dict(zip(self.axis_names, mesh.shape))
        # zero-pad attention heads up to a multiple of the model axis
        # (the attention layer reads this; see layers.attention_apply)
        self.pad_attention_heads = False

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes.values():
            n *= s
        return n

    def _axes_for(self, logical: Optional[str],
                  dim: int) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        axes = [a for a in self.rules.get(logical, ()) if a in self.axis_sizes]
        kept = []
        remaining = dim
        for a in axes:
            n = self.axis_sizes[a]
            if remaining % n == 0 and n > 1:
                kept.append(a)
                remaining //= n
        if not kept:
            return None
        return tuple(kept)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
        """The reference's PartitionSpec entries, one per tensor dim."""
        assert len(logical_axes) == len(shape), (logical_axes, shape)
        used: set = set()
        parts = []
        for name, dim in zip(logical_axes, shape):
            axes = self._axes_for(name, dim)
            if axes is None:
                parts.append(None)
                continue
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def placements(self, logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int]):
        """DTensor placements (one per mesh dim) for :meth:`spec`."""
        out = [Replicate() for _ in self.axis_names]
        for d, part in enumerate(self.spec(logical_axes, shape)):
            if part is None:
                continue
            axes = (part,) if isinstance(part, str) else part
            idx = [self.axis_names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"tensor dim {d} of shape {tuple(shape)} is split over "
                    f"mesh axes {axes} in that order, but DTensor splits a "
                    f"dim in mesh-dim order {self.axis_names}; list the "
                    f"axes in mesh order in the rule for "
                    f"{logical_axes[d]!r}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int]):
        """``(mesh, placements)``: what ``distribute_tensor`` takes."""
        return self.mesh, self.placements(logical_axes, shape)

    def constrain(self, x, *logical_axes):
        """Redistribute a DTensor to the placements of ``logical_axes``.

        A plain tensor passes unchanged on a mesh of one (every placement
        there is ``Replicate``); on a larger mesh it raises, since its
        layout across ranks is unknown."""
        if isinstance(x, DTensor):
            want = self.placements(logical_axes, x.shape)
            if tuple(x.placements) == want:
                return x
            return x.redistribute(self.mesh, want)
        if self.size == 1:
            return x
        raise TypeError(
            f"constrain{tuple(logical_axes)} got a plain tensor of shape "
            f"{tuple(x.shape)} on a mesh of {self.size} ranks; place the "
            f"inputs as DTensors (tree_shardings + place_tree)")

    def divisible(self, dim: int, axis: str) -> bool:
        n = self.axis_sizes.get(axis, 1)
        return n > 1 and dim % n == 0


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_axes(fn, axes, other):
    """Map ``fn(axes_leaf, other_leaf)`` over a tree of logical-axis tuples
    and a matching tree (dicts, lists)."""
    if _is_axes(axes):
        return fn(axes, other)
    if axes is None and other is None:
        return None
    if isinstance(axes, dict):
        return {k: map_axes(fn, axes[k], other[k]) for k in axes}
    if isinstance(axes, (list, tuple)):
        return type(axes)(map_axes(fn, a, o) for a, o in zip(axes, other))
    raise TypeError(f"not an axes tree: {axes!r}")


def tree_shardings(rules: ShardingRules, tree_axes, tree_shapes):
    """Map a tree of logical-axis tuples + matching shapes (or tensors) to
    ``(mesh, placements)`` pairs."""
    return map_axes(lambda axes, s: rules.sharding(
        axes, s.shape if hasattr(s, "shape") else s), tree_axes, tree_shapes)


def _is_sharding(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[1], tuple) and len(x[1]) > 0 and \
        all(isinstance(p, Placement) for p in x[1])


def sharding_leaves(shardings):
    """The ``(mesh, placements)`` leaves of a shardings tree in the
    params' flatten order (dict keys sorted, lists in order, ``None``
    giving no leaf), so they pair with ``params.tree_flatten``."""
    if shardings is None:
        return []
    if _is_sharding(shardings):
        return [shardings]
    if isinstance(shardings, dict):
        return [s for k in sorted(shardings)
                for s in sharding_leaves(shardings[k])]
    if isinstance(shardings, (list, tuple)):
        return [s for x in shardings for s in sharding_leaves(x)]
    raise TypeError(f"not a shardings tree: {type(shardings).__name__}")


def place(x: torch.Tensor, sharding) -> torch.Tensor:
    """A tensor that every rank holds in full, as a DTensor placed by
    ``sharding`` (each rank keeps its own shard; nothing is sent)."""
    mesh, placements = sharding
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return DTensor.from_local(_local_shard(x, mesh, placements), mesh,
                              placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _local_shard(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of a full tensor ``x`` under ``placements``,
    split in mesh-dim order (as DTensor splits)."""
    coord = mesh.get_coordinate()
    out = x
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(md)
            out = out.chunk(n, dim=p.dim)[coord[md]]
    return out.contiguous()


def place_tree(tree, shardings):
    """:func:`place` over a tree and a matching tree of shardings."""
    if _is_sharding(shardings):
        return place(tree, shardings)
    if tree is None and shardings is None:
        return None
    if isinstance(tree, dict):
        return {k: place_tree(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(t, s) for t, s in zip(tree, shardings))
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def batch_axes(x) -> Tuple[Optional[str], ...]:
    """A batch leaf's logical axes: its leading dim is the batch."""
    return ("batch",) + (None,) * (x.ndim - 1)


def place_batch(rules: Optional[ShardingRules], batch: Dict):
    """Plain batch tensors (every rank holding the whole batch) as
    DTensors placed by :func:`batch_axes`; DTensors pass unchanged, and
    without rules the batch does."""
    if rules is None:
        return batch
    return {k: v if isinstance(v, DTensor) else
            place(v, rules.sharding(batch_axes(v), v.shape))
            for k, v in batch.items()}


def like(grads, params):
    """Each gradient redistributed to its param's placements (a list of
    each; plain tensors pass unchanged), so the optimizer's elementwise
    update pairs shards that match."""
    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(p, DTensor) else g
            for g, p in zip(grads, params)]


def reduce_to(mesh, placements, grad):
    """``grad`` redistributed to ``placements`` (a gradient hook: its
    pending sums reduced now, each rank keeping its own shard)."""
    if tuple(grad.placements) == tuple(placements):
        return grad
    return grad.redistribute(mesh, placements)


def replicated(fn, *args):
    """``fn(*args)`` for an op with no DTensor sharding strategy: DTensor
    arguments are redistributed to ``Replicate()`` and ``fn`` runs on
    each rank's full local copy; tensor results come back as replicated
    DTensors on the first DTensor argument's mesh (gradients pass through
    both ways). With no DTensor argument this is ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    local = [a.redistribute(mesh, rep).to_local()
             if isinstance(a, DTensor) else a for a in args]
    out = fn(*local)

    def wrap(t):
        return DTensor.from_local(t, mesh, rep, run_check=False) \
            if isinstance(t, torch.Tensor) else t
    if isinstance(out, tuple):
        return tuple(wrap(t) for t in out)
    return wrap(out)


def rowwise(fn, x, *weights):
    """``fn(x, *weights)`` for a row-by-row op (each row of ``x``'s first
    dim independent of the others) that has no usable DTensor strategy:
    ``x`` keeps its ``Shard(0)`` placements (any other split is gathered),
    the weights are gathered whole, ``fn`` runs on each rank's local
    rows, and the result is placed as ``x`` is. With a plain ``x`` this
    is ``fn(x, *weights)``."""
    if not isinstance(x, DTensor):
        return fn(x, *weights)
    return _on_local(fn, x, weights, 1)


def by_token(fn, x, *weights, tokens: int = 2):
    """``fn(x, *weights)`` for an op on each token of ``x`` (each position
    of its first ``tokens`` dims independent of the others), such as a
    projection. Where a DTensor ``x`` is split on a token dim past the
    first (the sequence, under context parallelism), ``fn`` runs as in
    :func:`rowwise`, keeping every split of the token dims: torch 2.11's
    DTensor refuses to flatten a split sequence dim into a product's
    rows. Elsewhere this is ``fn(x, *weights)`` under DTensor's own
    strategy."""
    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and 0 < p.dim < tokens
            for p in x.placements):
        return _on_local(fn, x, weights, tokens)
    return fn(x, *weights)


def join_tokens(x, tokens: int = 2):
    """``x`` with its token dims past the first (the sequence) whole:
    redistributed where a DTensor is split on one, else ``x``."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if isinstance(p, Shard) and 0 < p.dim < tokens
                 else p for p in x.placements)
    return x if want == tuple(x.placements) else \
        x.redistribute(x.device_mesh, want)


def settle(x):
    """A DTensor's pending sums (``Partial`` placements) reduced now, the
    rest unchanged; a plain tensor as it is."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def local_attention(fn, q, k, v, q_offset: int = 0):
    """``fn(q, k, v, q_offset=...)``, an attention over (B, S, H, D)
    tensors, on each rank's own part: q keeps its splits of batch,
    sequence and heads; k and v are split as q on batch and heads and
    whole on the sequence; each rank's q offset is its shard's place in
    the sequence. k's and v's gradients are partial sums over the mesh
    dims that split q's sequence. The per-(batch, head) products then
    run on local tensors (torch 2.11's DTensor cannot flatten a split
    heads dim into a batched product). With a plain q this is ``fn(q,
    k, v, q_offset=q_offset)``."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, q_offset=q_offset)
    mesh = q.device_mesh
    qp = tuple(p if isinstance(p, Shard) and p.dim < 3 else Replicate()
               for p in q.placements)
    kp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in qp)
    kgrad = tuple(Partial() if isinstance(p, Shard) and p.dim == 1 else k_
                  for p, k_ in zip(qp, kp))
    _, offset = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    out = fn(q.redistribute(mesh, qp).to_local(),
             *[t.redistribute(mesh, kp).to_local(grad_placements=kgrad)
               for t in (k, v)], q_offset=q_offset + offset[1])
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _on_local(fn, x, weights, n: int):
    """``fn`` on each rank's local ``x``, whose splits of its first ``n``
    dims are kept (any other is gathered), with the weights gathered
    whole; the result placed as ``x``'s kept splits."""
    mesh = x.device_mesh
    keep = tuple(p if isinstance(p, Shard) and p.dim < n else Replicate()
                 for p in x.placements)
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    # a weight's gradient from this rank's part of x is a partial sum
    # over the mesh dims that split x
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in keep)
    local = fn(x.redistribute(mesh, keep).to_local(),
               *[w.redistribute(mesh, rep).to_local(grad_placements=grad)
                 if isinstance(w, DTensor) else w for w in weights])
    return DTensor.from_local(local, mesh, keep, run_check=False)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. On a mesh the table keeps its split of the rows
    (the vocabulary), as the reference's does: ids are gathered whole on
    the mesh dims that split the rows, each rank looks up the rows it
    holds (zeros for the others), and those partial rows are summed into
    ids' split. A split of the row width (FSDP) is gathered first.
    (DTensor's own lookup gathers the whole table to every rank.)"""
    if not isinstance(table, DTensor):
        return rowwise(_take, ids, table)
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = place(ids, (mesh, tuple(Replicate() for _ in range(mesh.ndim))))
    rows = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    tp = tuple(Shard(0) if r else Replicate() for r in rows)
    ip = tuple(Replicate() if r else p for r, p in zip(rows, ids.placements))
    # a rank's table gradient: whole for its rows, a partial sum over
    # the mesh dims that split ids
    grad = tuple(Shard(0) if r else Partial() if isinstance(p, Shard)
                 else Replicate() for r, p in zip(rows, ip))
    t = table.redistribute(mesh, tp).to_local(grad_placements=grad)
    i = ids.redistribute(mesh, ip).to_local()
    if not any(rows):
        return DTensor.from_local(t[i], mesh, ip, run_check=False)
    (n, _), (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, tp)
    own = (i >= lo) & (i < lo + n)
    out = t[torch.where(own, i - lo, 0)] * own[..., None].to(t.dtype)
    out = DTensor.from_local(out, mesh, tuple(
        Partial() if r else p for r, p in zip(rows, ip)), run_check=False)
    return out.redistribute(mesh, ids.placements)


def _take(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[ids]


def write_slice(dst: torch.Tensor, src: torch.Tensor, dim: int,
                start: int) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim``, in place
    (n = ``src.shape[dim]``). For a DTensor ``dst`` each rank writes the
    part of the window that falls in its own shard (a slice assignment
    through DTensor would write into a redistributed copy instead)."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    mesh, want = dst.device_mesh, list(dst.placements)
    # src is split as dst on every dim but the window's
    src_pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
              for p in want]
    if isinstance(src, DTensor):
        src = src.redistribute(mesh, src_pl)
    else:
        src = place(src, (mesh, tuple(src_pl)))
    src = src.to_local()
    local = dst.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, want)
    lo, hi = max(start, offset[dim]), min(start + n, offset[dim] + shape[dim])
    if lo < hi:
        local.narrow(dim, lo - offset[dim], hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


def step_scope(rules):
    """The context a step with ``rules`` runs in, entered once at the
    step's boundary: plain tensors made inside it (positions, masks,
    zeros) mix with DTensors as replicated (``implicit_replication``,
    which does not nest); without rules, nothing."""
    return implicit_replication() if rules is not None \
        else contextlib.nullcontext()
