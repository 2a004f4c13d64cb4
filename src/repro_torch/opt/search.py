"""Batched beam search over rewrite sequences, guided by the cost model.

The consumer the whole serving stack exists for: every frontier expansion
gathers ALL candidate graphs from every beam state × rule × site and
costs them in ONE ``service.predict_all`` call — which, when ``service``
is the async :class:`~repro_torch.core.server.CostModelServer`, rides the
bucketed micro-batching, in-flight dedup, and shared LRU for free (a
graph costed while optimizing one function is a cache hit while
optimizing the next).

Search state is deduplicated by :meth:`Graph.struct_key`, so re-deriving
an already-visited program through a different rewrite order costs
nothing. A per-search candidate budget bounds total model queries.

``Objective`` is the composite scoring knob: minimize a latency target
subject to a register-pressure constraint (pluggable target names per
deploy target; candidates over budget score ``inf``, so the constraint
is hard while the incumbent stays the fallback).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ir.graph import Graph
from repro_torch.opt import rewrites as RW


@dataclass
class Objective:
    """Minimize ``latency_target``; constrain ``pressure_target``.

    With an infinite budget (default) or a service that does not serve
    the pressure head, scoring is pure latency. ``Site.weight`` divides
    latency (an unroll by f does f iterations' work)."""

    latency_target: str = "latency_us"
    pressure_target: Optional[str] = "register_pressure"
    register_budget: float = float("inf")

    def bind(self, service) -> "BoundObjective":
        lat = service.resolve_target(self.latency_target)
        reg = None
        if self.pressure_target is not None and \
                np.isfinite(self.register_budget):
            try:
                reg = service.resolve_target(self.pressure_target)
            except (KeyError, ValueError) as e:
                raise ValueError(
                    f"register_budget={self.register_budget} needs a "
                    f"service with a {self.pressure_target!r} head; "
                    f"got heads={list(service.heads)}") from e
            if reg == lat:
                # a single-head service would silently judge feasibility
                # on latency numbers — refuse instead (same policy as
                # UnrollAdvisor)
                raise ValueError(
                    f"register_budget={self.register_budget} needs "
                    f"distinct {self.latency_target!r} and "
                    f"{self.pressure_target!r} heads; "
                    f"got heads={list(service.heads)}")
        return BoundObjective(self, lat, reg)


@dataclass
class BoundObjective:
    """Objective resolved against one service's heads."""

    spec: Objective
    lat_t: str
    reg_t: Optional[str]

    def scores(self, preds: Dict[str, np.ndarray],
               weights: Optional[Sequence[float]] = None) -> np.ndarray:
        lat = np.asarray(preds[self.lat_t], np.float64)
        if weights is not None:
            lat = lat / np.asarray(weights, np.float64)
        if self.reg_t is None:
            return lat
        reg = np.asarray(preds[self.reg_t], np.float64)
        return np.where(reg > self.spec.register_budget, np.inf, lat)


def cost_graphs(service, graphs: Sequence[Graph],
                objective: BoundObjective,
                weights: Optional[Sequence[float]] = None
                ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Score a candidate set with ONE batched ``predict_all`` through the
    serving stack. Returns (scores, denormalized per-target rows)."""
    preds = service.predict_all(list(graphs))
    return objective.scores(preds, weights), preds


@dataclass
class _State:
    graph: Graph
    key: str
    seq: List[Tuple[str, RW.Site]]
    score: float
    preds: Dict[str, float]


@dataclass
class SearchResult:
    root: Graph
    best: Graph
    best_seq: List[Tuple[str, RW.Site]]
    root_score: float
    best_score: float
    root_preds: Dict[str, float]
    best_preds: Dict[str, float]
    expansions: int = 0
    evaluated: int = 0               # candidates costed (root excluded)
    predict_calls: int = 0           # == 1 (root) + expansions
    # populated when record_candidates=True: (graph, predicted latency)
    candidates: Optional[List[Tuple[Graph, float]]] = None
    trace: List[Dict] = field(default_factory=list)

    @property
    def improved(self) -> bool:
        return bool(self.best_seq)

    def describe(self) -> str:
        if not self.best_seq:
            return "<no-op>"
        return " -> ".join(repr(s) for _, s in self.best_seq)


def _expand_lazy(frontier: List["_State"], rules, visited: set,
                 cap: int) -> List[Tuple]:
    """Round-robin over every parent's rewrite sites, constructing a
    candidate graph (rule.apply + struct_key) only when the cursor
    actually reaches its site under ``cap``.

    The eager version applied and hashed EVERY site's graph just to
    throw most away at the cap — at fleet scale that construction was
    the largest single share of search wall time. Illegal sites and
    already-visited keys don't consume cap slots (same contract as
    before: only candidates actually costed become visited)."""
    per_parent = [[(st, r, s) for r in rules
                   for s in r.applicable(st.graph)] for st in frontier]
    batch: List[Tuple] = []
    proposed = set()                     # this expansion's intra-dedup
    rank = 0
    while len(batch) < cap and any(rank < len(p) for p in per_parent):
        for lst in per_parent:
            if rank >= len(lst) or len(batch) >= cap:
                continue
            st, rule, site = lst[rank]
            try:
                ng = rule.apply(st.graph, site)
            except AssertionError:
                continue                 # illegal here: not a candidate
            key = ng.struct_key()
            if key in visited or key in proposed:
                continue
            proposed.add(key)
            batch.append((st, rule.name, site, ng, key))
        rank += 1
    return batch


def beam_search(service, g: Graph,
                rules: Optional[Sequence[RW.Rewrite]] = None, *,
                objective: Optional[Objective] = None,
                beam_width: int = 4, max_steps: int = 6,
                max_candidates: int = 64, eval_budget: int = 256,
                greedy: bool = False, preserve_outputs: bool = True,
                record_candidates: bool = False) -> SearchResult:
    """Beam search over rewrite sequences from ``g``.

    Per step: expand every frontier state through every rule site, dedup
    candidates against every struct_key visited this search, cost the
    whole set in ONE batched ``predict_all``, keep the ``beam_width``
    best. ``eval_budget`` caps total candidates costed; ``greedy=True``
    is the cheap mode — beam 1, stop at the first non-improving step.

    ``preserve_outputs`` (default) is the legality gate for a search
    whose result *replaces* the input function: rules that change output
    arity (unroll replicates the body's outputs) cannot yield a legal
    replacement — and no later rewrite restores the arity — so their
    sites are pruned up front. Factor-style decisions over such rules
    belong to weight-normalized single-rule searches (UnrollAdvisor);
    ``preserve_outputs=False`` admits them here too.
    """
    rules = list(rules) if rules is not None else RW.default_rules()
    if preserve_outputs:
        rules = [r for r in rules if r.preserves_outputs]
    if greedy:
        beam_width = 1
    obj = (objective or Objective()).bind(service)
    preds0 = service.predict_all([g])
    root_row = {t: float(v[0]) for t, v in preds0.items()}
    root_score = float(obj.scores(preds0)[0])
    root = _State(g, g.struct_key(), [], root_score, root_row)
    visited = {root.key}
    best = root
    frontier = [root]
    res = SearchResult(root=g, best=g, best_seq=[], root_score=root_score,
                       best_score=root_score, root_preds=root_row,
                       best_preds=root_row, predict_calls=1)
    if record_candidates:
        res.candidates = [(g, root_row[obj.lat_t])]
    for _ in range(max_steps):
        cap = min(max_candidates, eval_budget - res.evaluated)
        batch = _expand_lazy(frontier, rules, visited, cap) \
            if cap > 0 else []
        if not batch:
            break
        # only candidates actually costed become visited: states dropped
        # by the cap stay re-derivable by a later (affordable) expansion
        visited.update(c[4] for c in batch)
        # THE one batched model query of this frontier expansion
        preds = service.predict_all([c[3] for c in batch])
        res.predict_calls += 1
        res.expansions += 1
        res.evaluated += len(batch)
        scores = obj.scores(preds)
        states = []
        for i, (parent, rname, site, ng, key) in enumerate(batch):
            row = {t: float(v[i]) for t, v in preds.items()}
            states.append(_State(ng, key, parent.seq + [(rname, site)],
                                 float(scores[i]), row))
            if res.candidates is not None:
                res.candidates.append((ng, row[obj.lat_t]))
        states.sort(key=lambda s: s.score)
        res.trace.append({"candidates": len(batch),
                          "best_score": states[0].score})
        if states[0].score < best.score:
            best = states[0]
        if greedy and states[0].score >= frontier[0].score:
            break
        frontier = states[:beam_width]
        if res.evaluated >= eval_budget:
            break
    res.best = best.graph
    res.best_seq = best.seq
    res.best_score = best.score
    res.best_preds = best.preds
    return res


def greedy_search(service, g: Graph,
                  rules: Optional[Sequence[RW.Rewrite]] = None,
                  **kw) -> SearchResult:
    """Cheap mode: beam of 1, stop as soon as no candidate improves."""
    kw.setdefault("max_steps", 8)
    return beam_search(service, g, rules, greedy=True, **kw)


def search_pool(service, pool: Sequence[Graph], offset: int = 0,
                **search_kw) -> List[SearchResult]:
    """One fleet-worker pass: beam-search every graph in ``pool``,
    rotated by ``offset`` so concurrent workers traverse the same pool
    out of phase (maximizing in-flight coalescing and cross-search LRU
    hits without ever searching the same graph simultaneously).

    ``service`` is anything beam_search can cost through — an in-process
    CostModelService or an async CostModelServer gateway."""
    k = offset % len(pool) if pool else 0
    gs = list(pool[k:]) + list(pool[:k])
    return [beam_search(service, g, **search_kw) for g in gs]
