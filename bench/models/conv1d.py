"""The conv1d cost model (paper Figs. 5 and 6) as the benchmark draws,
counts and configures it.

The leaves follow ``chip_smoke.py``'s ``seeded_params`` recipe: the
port's ``conv_init`` shapes and scales (embedding N(0, 0.02), conv taps
N(0, 1/(fs*Cin)), FC and head weights N(0, 1/fan_in)), the embedding
scaled x100 and every bias drawn N(0, 0.1). With the default init the
outputs are so small that a TF32 forward lands inside any limit a
float32 forward needs; with these a lower precision shows.

The counts are ``chip_smoke.py``'s ``bound_ms`` counts, frozen here.
"""
from __future__ import annotations

from typing import List

import numpy as np

EMB_SCALE = 100.0
BIAS_STD = 0.1
F32 = 4


def param_shapes(cfg: dict) -> List[tuple]:
    """(path, shape, std) of every leaf, in a fixed order; a path's
    int keys index lists, its str keys dicts (the port's layout)."""
    out = [(("emb",), (cfg["vocab_size"], cfg["embed_dim"]),
            0.02 * EMB_SCALE)]
    c_in = cfg["embed_dim"]
    for i, (fs, c_out) in enumerate(zip(cfg["conv_filters"],
                                        cfg["conv_channels"])):
        out.append((("convs", i, "w"), (fs, c_in, c_out),
                    1.0 / float(np.sqrt(fs * c_in))))
        out.append((("convs", i, "b"), (c_out,), BIAS_STD))
        c_in = c_out
    for i, f_out in enumerate(cfg["fc_dims"]):
        out.append((("fc", i, "w"), (c_in, f_out),
                    1.0 / float(np.sqrt(c_in))))
        out.append((("fc", i, "b"), (f_out,), BIAS_STD))
        c_in = f_out
    for t in cfg["heads"]:
        out.append((("heads", t, "w"), (c_in, 1), 1.0 / float(np.sqrt(c_in))))
        out.append((("heads", t, "b"), (1,), BIAS_STD))
    return out


def row_flops(cfg: dict, seq: int) -> int:
    """Operations of one row's forward at bucket width ``seq``."""
    flops, c_in = 0, cfg["embed_dim"]
    for fs, c_out in zip(cfg["conv_filters"], cfg["conv_channels"]):
        flops += 2 * seq * fs * c_in * c_out
        c_in = c_out
    for f_out in cfg["fc_dims"]:
        flops += 2 * c_in * f_out
        c_in = f_out
    return flops + 2 * c_in * len(cfg["heads"])


def weight_bytes(cfg: dict) -> int:
    """Every weight but the embedding, once."""
    n, c_in = 0, cfg["embed_dim"]
    for fs, c_out in zip(cfg["conv_filters"], cfg["conv_channels"]):
        n += fs * c_in * c_out + c_out
        c_in = c_out
    for f_out in cfg["fc_dims"]:
        n += c_in * f_out + f_out
        c_in = f_out
    return (n + (c_in + 1) * len(cfg["heads"])) * F32


def port_config(cfg: dict):
    """The port's ``CostModelConfig`` of a configuration file."""
    from repro_torch.configs.costmodel import CostModelConfig
    return CostModelConfig(
        name=cfg["name"], vocab_size=cfg["vocab_size"],
        max_seq=cfg["max_seq"], embed_dim=cfg["embed_dim"],
        conv_filters=tuple(cfg["conv_filters"]),
        conv_channels=tuple(cfg["conv_channels"]),
        fc_dims=tuple(cfg["fc_dims"]))
