"""The plain conv1d cost model (paper Figs. 5 and 6), forward and loss.

Token embedding with the PAD rows zeroed; each conv a "same"
cross-correlation, ``(fs - 1) // 2`` zeros on the left and ``fs // 2``
on the right, plus its bias, then ReLU; the max over every position of
the bucket, pads included; the hidden FC layers with ReLU; one linear
head a target. A conv is one matrix product over the windows of its
input, so a single precision switch governs every product:
``precision="ieee"`` runs them in IEEE float32 (TF32 off), and
``"tf32"`` runs them in TF32, on the card through PyTorch's matmul
precision and on the CPU by rounding both operands of each forward
product to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (1 + 10 mantissa bits),
    ties away from zero, kept in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    """Float32 products in ``precision`` ("ieee" or "tf32") inside."""
    if precision not in ("ieee", "tf32"):
        raise ValueError(f"precision {precision!r}")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(
        "high" if precision == "tf32" and device.type == "cuda"
        else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 going forward; the gradient passes as is."""
    return x + (tf32_round(x.detach()) - x.detach())


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32" and a.device.type != "cuda":
        a, b = _tf32(a), _tf32(b)
    return a @ b


def conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              precision: str) -> torch.Tensor:
    """x (B, S, Cin), w (fs, Cin, Cout), b (Cout,) -> (B, S, Cout)."""
    fs = w.shape[0]
    B, S, c_in = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, (fs - 1) // 2, fs // 2))
    win = xp.unfold(1, fs, 1)                      # (B, S, Cin, fs)
    win = win.permute(0, 1, 3, 2).reshape(B * S, fs * c_in)
    out = _mm(win, w.reshape(fs * c_in, -1), precision)
    return out.view(B, S, -1) + b


def forward(params: Dict, ids: torch.Tensor,
            precision: str = "ieee") -> torch.Tensor:
    """(B, S) int ids -> (B, n_heads) normalized predictions, the heads
    in ``params["heads"]`` order."""
    with matmul_precision(precision, ids.device):
        x = params["emb"][ids] * (ids != 0)[..., None].to(torch.float32)
        for layer in params["convs"]:
            x = torch.relu(conv_same(x, layer["w"], layer["b"], precision))
        h = x.amax(dim=1)
        for layer in params["fc"]:
            h = torch.relu(_mm(h, layer["w"], precision) + layer["b"])
        heads = params["heads"]
        w = torch.cat([heads[t]["w"] for t in heads], dim=1)
        b = torch.cat([heads[t]["b"] for t in heads])
        return _mm(h, w, precision) + b


def denormalize(rows: torch.Tensor, stats: Dict, heads) -> torch.Tensor:
    """Normalized rows -> predictions: expm1(row * sigma + mu), in
    float64."""
    mu = torch.tensor([stats[t]["mu"] for t in heads], dtype=torch.float64)
    sigma = torch.tensor([stats[t]["sigma"] for t in heads],
                         dtype=torch.float64)
    return torch.expm1(rows.double().cpu() * sigma + mu)
