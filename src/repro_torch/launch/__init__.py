"""Command-line drivers over the port, each ``python -m
repro_torch.launch.<name>`` with a ``main(argv=None)``:

* :mod:`~repro_torch.launch.train` — train (or resume, or evaluate) a
  cost model of any family;
* :mod:`~repro_torch.launch.serve` — train a small multi-target model and
  serve it through the async server or a replicated tier;
* :mod:`~repro_torch.launch.optimize` — train or resume a model, serve
  it and beam-search rewrite sequences;
* :mod:`~repro_torch.launch.ingest` — lower real architectures' layers
  to StableHLO, feed them (and fuzzed or user texts) through the
  front door, and print the cost predictions;
* :mod:`~repro_torch.launch.obs` — read the telemetry JSONL that
  ``--obs`` runs write.

Each runs on the card unless given ``--device cpu``.
"""
