"""repro_torch.opt — the cost-model-guided graph optimization engine.

The paper trains the cost model so the DL compiler can "make the best
decisions" during graph-level optimization. This package is that
compiler-in-the-loop consumer, as a first-class subsystem:

* :mod:`repro_torch.opt.rewrites` — a registry of legality-checked rewrite
  rules over the ``xpu`` dataflow IR (fusion, CSE, DCE, recompute,
  dtype narrowing, unrolling).
* :mod:`repro_torch.opt.search` — batched beam/greedy search over rewrite
  *sequences*; every frontier expansion costs all candidates in ONE
  ``predict_all`` call through the micro-batching serving stack.
* :mod:`repro_torch.opt.evaluate` — closed-loop harness replaying chosen
  sequences against the ``ir/analyzers`` ground-truth oracle
  (predicted-vs-oracle improvement + rank correlation).
"""
from repro_torch.opt import evaluate, rewrites, search  # noqa: F401
from repro_torch.opt.rewrites import (  # noqa: F401
    REGISTRY, Rewrite, Site, default_rules, fuse_elementwise,
    random_rewrite, unroll_graph)
from repro_torch.opt.search import (  # noqa: F401
    Objective, SearchResult, beam_search, cost_graphs, greedy_search)
from repro_torch.opt.evaluate import evaluate_search, replay  # noqa: F401
