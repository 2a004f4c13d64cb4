"""AI21-Jamba2-3B as the benchmark draws, counts and configures it: the
configuration file holds HF's ``config.json`` keys (the catalog entry's
``config``), one period of ``attn_layer_period`` layers.

The leaves are the port's param tree for one period (``models/model.py``
and ``models/mamba.py``), each drawn N(0, std) at the port's init scales
(1/sqrt(fan_in); the conv taps 0.5); then :func:`finish` puts each
gain, ``D``, ``A_log`` and ``dt_bias`` where the port's init puts it:
every RMSNorm weight and ``D`` 1 + N(0, 0.1), ``A_log`` log(1..N) +
N(0, 0.1), ``dt_bias`` the softplus inverse of a dt drawn log-uniform
in [1e-3, 0.1] (through the normal CDF of the drawn value); the conv
bias N(0, 0.1), so a dropped bias shows.

The counts: a training step's model operations (three forwards: the
matrix products, the conv taps and the causal attention's two products;
the scan's elementwise work left out) against the card's dense BF16
peak, and the bytes the scan's forward and backward have to move.
"""
from __future__ import annotations

import math
from typing import List

import torch

F32 = 4
# NVIDIA H100 SXM5 data sheet, dense BF16 tensor-core rate at 700 W
PEAK_BF16_FLOPS = 989e12


def dims(cfg: dict) -> dict:
    """The widths the plain reference reads."""
    d, nq = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"eps": cfg["rms_norm_eps"], "n_heads": nq,
            "n_kv_heads": cfg["num_key_value_heads"], "head_dim": d // nq,
            "dt_rank": cfg["mamba_dt_rank"], "d_state": cfg["mamba_d_state"],
            "period": cfg["attn_layer_period"],
            "attn_index": cfg["attn_layer_offset"]}


def _widths(cfg: dict):
    d = cfg["hidden_size"]
    return (d, cfg["mamba_expand"] * d, cfg["mamba_dt_rank"],
            cfg["mamba_d_state"], cfg["mamba_d_conv"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            d // cfg["num_attention_heads"], cfg["intermediate_size"])


def _periods(cfg: dict) -> int:
    return cfg["num_hidden_layers"] // cfg["attn_layer_period"]


def param_shapes(cfg: dict) -> List[tuple]:
    """(path, shape, std) of every leaf of the port's tree (stacked:
    periods first, then the period's mamba or FFN slots)."""
    d, di, R, N, k, nq, nkv, hd, ff = _widths(cfg)
    P, n = _periods(cfg), cfg["attn_layer_period"]
    m = n - 1
    per = ("periods",)
    att = per + ("attn",)
    mam = per + ("mamba",)
    ffn = per + ("ffn",)
    return [
        (("embed", "table"), (cfg["vocab_size"], d), 0.02),
        (("final_norm",), (d,), 0.1),
        (att + ("wq",), (P, d, nq, hd), d ** -0.5),
        (att + ("wk",), (P, d, nkv, hd), d ** -0.5),
        (att + ("wv",), (P, d, nkv, hd), d ** -0.5),
        (att + ("wo",), (P, nq, hd, d), (nq * hd) ** -0.5),
        (mam + ("in_proj",), (P, m, d, 2 * di), d ** -0.5),
        (mam + ("conv_w",), (P, m, k, di), 0.5),
        (mam + ("conv_b",), (P, m, di), 0.1),
        (mam + ("x_proj",), (P, m, di, R + 2 * N), di ** -0.5),
        (mam + ("dt_proj",), (P, m, R, di), R ** -0.5),
        (mam + ("dt_bias",), (P, m, di), 1.0),
        (mam + ("A_log",), (P, m, di, N), 0.1),
        (mam + ("D",), (P, m, di), 0.1),
        (mam + ("out_proj",), (P, m, di, d), di ** -0.5),
        (mam + ("dt_norm",), (P, m, R), 0.1),
        (mam + ("b_norm",), (P, m, N), 0.1),
        (mam + ("c_norm",), (P, m, N), 0.1),
        (ffn + ("w_up",), (P, n, d, ff), d ** -0.5),
        (ffn + ("w_down",), (P, n, ff, d), ff ** -0.5),
        (ffn + ("w_gate",), (P, n, d, ff), d ** -0.5),
        (per + ("ln1",), (P, n, d), 0.1),
        (per + ("ln2",), (P, n, d), 0.1),
    ]


@torch.no_grad()
def finish(params: dict) -> None:
    """Move the drawn gains, ``D``, ``A_log`` and ``dt_bias`` where the
    port's init puts them (in place)."""
    per = params["periods"]
    mb = per["mamba"]
    for w in (params["final_norm"], per["ln1"], per["ln2"], mb["D"],
              mb["dt_norm"], mb["b_norm"], mb["c_norm"]):
        w.add_(1.0)
    N = mb["A_log"].shape[-1]
    mb["A_log"].add_(torch.log(torch.arange(
        1, N + 1, dtype=torch.float32, device=mb["A_log"].device)))
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = 0.5 * (1 + torch.erf(mb["dt_bias"] / math.sqrt(2)))
    dt = torch.exp(lo + (hi - lo) * u)
    mb["dt_bias"].copy_(torch.log(torch.expm1(dt)))


def port_config(cfg: dict):
    """The port's ``ArchConfig`` of a configuration file: the registered
    ``jamba2-3b`` with the file's widths and depth. Raises for a setting
    the port's Jamba does not have."""
    import dataclasses
    from repro_torch.configs import get_arch
    arch = get_arch("jamba2-3b")
    d = cfg["hidden_size"]
    fixed = {"mamba_dt_rank": d // 16, "num_experts": 1,
             "mamba_proj_bias": False, "mamba_conv_bias": True,
             "hidden_act": "silu",
             "tie_word_embeddings": arch.tie_embeddings}
    bad = {k: (cfg[k], v) for k, v in fixed.items() if cfg[k] != v}
    if bad or cfg["num_hidden_layers"] % cfg["attn_layer_period"]:
        raise ValueError(f"not the port's Jamba: {bad}")
    return dataclasses.replace(
        arch, n_layers=cfg["num_hidden_layers"], d_model=d,
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        norm_eps=cfg["rms_norm_eps"],
        hybrid=dataclasses.replace(
            arch.hybrid, period=cfg["attn_layer_period"],
            attn_index=cfg["attn_layer_offset"],
            d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
            expand=cfg["mamba_expand"]))


def step_flops(cfg: dict, rows: int, seq: int) -> int:
    """Model operations of one training step over ``rows`` sequences of
    ``seq`` tokens: three forwards."""
    d, di, R, N, k, nq, nkv, hd, ff = _widths(cfg)
    P, n = _periods(cfg), cfg["attn_layer_period"]
    mamba = d * 2 * di + di * (R + 2 * N) + R * di + di * d + k * di
    attn = 2 * d * nq * hd + 2 * d * nkv * hd
    per_token = P * ((n - 1) * mamba + attn + n * 3 * d * ff) \
        + cfg["vocab_size"] * d
    causal = P * 2 * seq * seq * nq * hd        # q k and p v, causal half
    return 3 * rows * (2 * seq * per_token + causal)


def scan_bytes(rows: int, L: int, D: int, N: int) -> tuple:
    """(forward, backward) bytes of one launch of each of the scan's
    entries, the function's own inputs read once and its outputs written
    once: x, dt, B, C, A, D in and y out; then those and dy in, and dx,
    ddt, dB, dC, dA, dD out. What a design keeps between the two (the
    kernel's states at chunk boundaries) is its own choice, not counted."""
    seq_d, seq_n = rows * L * D, rows * L * N
    small = D * N + D
    fwd = 3 * seq_d + 2 * seq_n + small
    bwd = 5 * seq_d + 4 * seq_n + 2 * small
    return fwd * F32, bwd * F32
