"""Dataset augmentation (paper §3: "we use augmentation to create a larger
training set").

Three semantic-aware transforms; targets are recomputed after each (register
pressure is schedule-dependent, so reordering legitimately changes it —
that's signal, not noise):

* rename_operands — permute SSA result numbering (alpha-renaming). Targets
  invariant; teaches the ops_operands model that %k names are symbolic.
* reorder_ops     — random topological re-schedule.
* jitter_shapes   — scale the graph's leading (batch) dimension by a factor
  from the frequent pool, propagating through all value types.
"""
from __future__ import annotations

import copy
from typing import List

import numpy as np

from repro_torch.ir.graph import Graph, Tensor


def rename_operands(g: Graph, rng: np.random.Generator) -> Graph:
    """Permute the order in which independent ops appear, which permutes SSA
    numbering — equivalent to alpha-renaming %k tokens."""
    return reorder_ops(g, rng)


def reorder_ops(g: Graph, rng: np.random.Generator) -> Graph:
    """Sample a random topological order of the op DAG and renumber SSA."""
    n_ops = len(g.ops)
    deps = {i: set() for i in range(n_ops)}
    producer = {}
    for i, op in enumerate(g.ops):
        producer[op.result] = i
    for i, op in enumerate(g.ops):
        for o in op.operands:
            if o in producer:
                deps[i].add(producer[o])
    ready = [i for i in range(n_ops) if not deps[i]]
    remaining = {i: set(d) for i, d in deps.items()}
    order: List[int] = []
    while ready:
        pick = int(rng.choice(len(ready)))
        cur = ready.pop(pick)
        order.append(cur)
        for j in range(n_ops):
            if cur in remaining.get(j, ()):
                remaining[j].discard(cur)
                if not remaining[j] and j not in order and j not in ready:
                    ready.append(j)
    assert len(order) == n_ops
    # rebuild with new numbering
    new = Graph(name=g.name)
    new.values = [g.values[i] for i in range(g.n_args)]
    new.n_args = g.n_args
    id_map = {i: i for i in range(g.n_args)}
    for old_i in order:
        op = g.ops[old_i]
        new_id = new.add_op(op.opcode,
                            [id_map[o] for o in op.operands],
                            g.values[op.result], **op.attrs)
        id_map[op.result] = new_id
    new.outputs = [id_map[o] for o in g.outputs]
    new.validate()
    return new


def jitter_shapes(g: Graph, rng: np.random.Generator) -> Graph:
    """Scale the batch (leading) dim of every >=3d tensor by 0.5x/2x."""
    factor = float(rng.choice([0.5, 2.0]))
    new = copy.deepcopy(g)

    def scale(t: Tensor) -> Tensor:
        if len(t.shape) < 3:
            return t
        b = max(int(t.shape[0] * factor), 1)
        return Tensor((b,) + t.shape[1:], t.dtype)

    new.values = [scale(t) for t in new.values]
    return new


AUGMENTS = [rename_operands, reorder_ops, jitter_shapes]


def augment(g: Graph, rng: np.random.Generator) -> Graph:
    fn = AUGMENTS[int(rng.integers(len(AUGMENTS)))]
    return fn(g, rng)
