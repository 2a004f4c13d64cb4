"""One module a model kind, found by the ``kind`` of a configuration
file: ``bench/models/<kind>.py``. Each has ``param_shapes(cfg)`` (the
leaves the benchmark draws from the seed), ``row_flops(cfg, seq)`` and
``weight_bytes(cfg)`` (the counts of the roofline and ``mfu`` shares)
and ``port_config(cfg)`` (the port's config object). The plain
reference of the kind is ``bench/reference/<kind>.py``."""
