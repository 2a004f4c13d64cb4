"""Closed-loop evaluation: does the model actually steer the compiler?

The paper's deployment question made measurable. For each input graph
the harness (1) runs the model-guided search, (2) *replays* the chosen
rewrite sequence from scratch — every step re-applied and legality-
checked, and the result must reproduce the search's best graph
struct-key-for-struct-key — and (3) judges the outcome with the
``ir/analyzers`` ground-truth oracle, never the model: predicted vs
oracle improvement, win rate against the one-shot FusionAdvisor
baseline, and Spearman rank correlation between predicted and oracle
latency over every candidate the search costed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.ir import analyzers
from repro_torch.ir.graph import Graph
from repro_torch.opt import rewrites as RW
from repro_torch.opt import search as SE


def _ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share their mean rank)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    vals = x[order]
    i = 0
    while i < len(vals):
        j = i
        while j + 1 < len(vals) and vals[j + 1] == vals[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (0.0 when degenerate)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if len(a) < 2 or np.all(a == a[0]) or np.all(b == b[0]):
        return 0.0
    rho = np.corrcoef(_ranks(a), _ranks(b))[0, 1]
    return float(rho) if math.isfinite(rho) else 0.0


def replay(result: SE.SearchResult,
           rules: Optional[Sequence[RW.Rewrite]] = None) -> Graph:
    """Re-apply the chosen sequence from the root, legality-checked step
    by step; assert it reproduces the search's best graph."""
    by_name = {r.name: r for r in
               (rules if rules is not None else RW.default_rules())}
    g = result.root
    for rname, site in result.best_seq:
        g = by_name[rname].apply(g, site)
    assert g.struct_key() == result.best.struct_key(), \
        "replayed sequence does not reproduce the searched graph"
    return g


def fusion_baseline(service, g: Graph,
                    latency_target: str = "latency_us") -> Graph:
    """The one-shot fusion advisor the search replaced: fully fuse,
    keep the fused graph iff the model predicts it cheaper."""
    fused = RW.fuse_elementwise(g)
    t = service.resolve_target(latency_target)
    c = service.predict_all([g, fused])[t]
    return fused if c[1] < c[0] else g


def evaluate_search(service, graphs: Sequence[Graph], *,
                    rules: Optional[Sequence[RW.Rewrite]] = None,
                    objective: Optional[SE.Objective] = None,
                    beam_width: int = 4, max_steps: int = 5,
                    max_candidates: int = 64, eval_budget: int = 256,
                    greedy: bool = False) -> Dict:
    """Search every graph, replay + oracle-judge every outcome.

    Returns ``{"per_graph": [...], "summary": {...}}``; all latencies are
    oracle (``ir/analyzers``) microseconds except the ``pred_*`` fields.
    """
    rules = list(rules) if rules is not None else RW.default_rules()
    obj = objective or SE.Objective()
    lat_t = service.resolve_target(obj.latency_target)
    per: List[Dict] = []
    pred_lat: List[float] = []
    oracle_lat: List[float] = []
    search_rhos: List[float] = []
    for g in graphs:
        res = SE.beam_search(service, g, rules, objective=obj,
                             beam_width=beam_width, max_steps=max_steps,
                             max_candidates=max_candidates,
                             eval_budget=eval_budget, greedy=greedy,
                             record_candidates=True)
        final = replay(res, rules)
        base = fusion_baseline(service, g, obj.latency_target)
        cand_pred = [pl for _, pl in res.candidates]
        cand_oracle = [analyzers.latency_us(cg)
                       for cg, _ in res.candidates]
        pred_lat.extend(cand_pred)
        oracle_lat.extend(cand_oracle)
        rho = spearman(cand_pred, cand_oracle) \
            if len(cand_pred) >= 3 else None
        if rho is not None:
            # within-search ranking is what beam selection depends on
            search_rhos.append(rho)
        per.append({
            "spearman_candidates": rho,
            "graph": g.name,
            "n_ops": len(g.ops),
            "oracle_root": analyzers.latency_us(g),
            "oracle_best": analyzers.latency_us(final),
            "oracle_fuse_baseline": analyzers.latency_us(base),
            "pred_root": res.root_preds[lat_t],
            "pred_best": res.best_preds[lat_t],
            "steps": len(res.best_seq),
            "evaluated": res.evaluated,
            "expansions": res.expansions,
            "predict_calls": res.predict_calls,
            "seq": [repr(s) for _, s in res.best_seq],
        })
    o_root = np.asarray([r["oracle_root"] for r in per])
    o_best = np.asarray([r["oracle_best"] for r in per])
    o_base = np.asarray([r["oracle_fuse_baseline"] for r in per])
    p_root = np.asarray([r["pred_root"] for r in per])
    p_best = np.asarray([r["pred_best"] for r in per])
    eps = 1e-12
    summary = {
        "n_graphs": len(per),
        "mean_oracle_root_us": float(o_root.mean()),
        "mean_oracle_best_us": float(o_best.mean()),
        "mean_oracle_baseline_us": float(o_base.mean()),
        # improvements are relative to the unoptimized root
        "oracle_improvement_mean": float(
            np.mean(1.0 - o_best / np.maximum(o_root, eps))),
        "baseline_oracle_improvement_mean": float(
            np.mean(1.0 - o_base / np.maximum(o_root, eps))),
        "pred_improvement_mean": float(
            np.mean(1.0 - p_best / np.maximum(p_root, eps))),
        "frac_improved_vs_root": float(
            np.mean(o_best < o_root - eps)),
        "frac_strictly_better_than_baseline": float(
            np.mean(o_best < o_base - eps)),
        # mean WITHIN-search rank correlation over each search's costed
        # candidates — the ranking beam selection actually relies on.
        # The pooled variant mixes graphs of very different sizes, so a
        # model that only ranked big-vs-small would score high on it;
        # kept for reference, labeled as such.
        "spearman_pred_oracle": float(np.mean(search_rhos))
        if search_rhos else 0.0,
        "spearman_pred_oracle_pooled": spearman(pred_lat, oracle_lat),
        "candidates_costed": int(sum(r["evaluated"] for r in per)),
        "predict_calls": int(sum(r["predict_calls"] for r in per)),
    }
    return {"per_graph": per, "summary": summary}
