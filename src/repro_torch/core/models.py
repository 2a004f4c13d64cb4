"""The cost model's regressors in PyTorch: the paper's three families and
the transformer beyond it.

1. FC bag-of-tokens — the masked mean of the embeddings, then the FC
   stack (the paper's worst RMSE).
2. LSTM — a masked recurrence whose final hidden state feeds the heads
   (the middle).
3. Conv1D+MaxPool+FC, the deployed model (paper Figs 5/6): token
   embedding (PAD id 0 masked), N stacked "same" Conv1D + ReLU,
   MaxPool1D over every sequence position, the hidden FC stack, then the
   heads (the best).
4. Transformer (the paper's future work #1): learned positions, 2
   pre-LayerNorm blocks of 4-head attention with an additive key mask
   and a tanh-GELU MLP, then a masked mean-pool.

Every family is split into ``*_encode(params, ids) -> features`` and
the heads. Two head layouts, as in the reference:

* **single-head**: the last layer (``fc[-1]`` for the FC and conv
  models, ``head`` for the LSTM and the transformer) is a ``(F, 1)``
  scalar head and ``*_apply`` returns a ``(B,)`` tensor;
* **multi-head**: ``params["heads"]`` maps each target to a ``(F, 1)``
  linear head over the shared features and ``*_apply`` returns
  ``{target: (B,)}``.

Layouts follow the reference at every public function: activations are
``(B, S, C)``, conv weights ``(fs, Cin, Cout)`` and LSTM weights
``(in, 4H)`` with the gates in i, f, g, o order. Masks, the attention's key
bias and the LSTM's initial state follow the embedding's dtype, so bf16
params run a bf16 network end to end, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import embed_grad as EG
from repro_torch.params import conv_init, fc_init, lstm_init, xformer_init
from repro_torch.runtime import sharding as SH

# Canonical multi-target head set (every analyzer target, in analyzer order).
DEFAULT_HEADS: Tuple[str, ...] = (
    "register_pressure", "valu_utilization", "latency_us")


def _mask(ids: torch.Tensor) -> torch.Tensor:
    return (ids != 0).to(torch.float32)  # PAD id is 0


def scalar_head(head_p: Dict[str, Any], feats: torch.Tensor) -> torch.Tensor:
    """The one {"w": (F, 1), "b": (1,)} linear-readout contract."""
    return (feats @ head_p["w"] + head_p["b"])[..., 0]


def apply_heads(heads_p: Dict[str, Any], feats) -> Dict[str, torch.Tensor]:
    return {t: scalar_head(h, feats) for t, h in heads_p.items()}


def model_heads(params) -> Optional[Tuple[str, ...]]:
    """Head names of a multi-head param tree, or None for single-head."""
    if isinstance(params, dict) and "heads" in params:
        return tuple(params["heads"])
    return None


def fc_stack(p, x: torch.Tensor) -> torch.Tensor:
    """Hidden FC layers -> shared features. In the single-head layout the
    last ``fc`` layer is the scalar head and is excluded here."""
    hidden = p["fc"] if "heads" in p else p["fc"][:-1]
    for layer in hidden:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x


def _finish(p, feats: torch.Tensor, single_head: Dict[str, Any]):
    """Shared features -> the multi-head dict, or the one scalar head."""
    if "heads" in p:
        return apply_heads(p["heads"], feats)
    return scalar_head(single_head, feats)


def fc_finish(p, x: torch.Tensor):
    """Pooled features -> fc_stack -> head outputs, for either layout."""
    return _finish(p, fc_stack(p, x), p["fc"][-1])


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` (B, S, C) over the positions where ``m`` (B, S) is 1;
    a row with none gives zeros (the count is floored at 1)."""
    return (x * m[..., None]).sum(1) / torch.clamp(
        m.sum(1, keepdim=True), min=1.0)


def fc_encode(p, ids: torch.Tensor) -> torch.Tensor:
    """Bag-of-tokens pooling + the hidden FC stack -> shared features.
    The mask is in the embedding's dtype, so bf16 params pool in bf16."""
    emb = p["emb"]
    return fc_stack(p, _masked_mean(SH.gather_rows(emb, ids),
                                    _mask(ids).to(emb.dtype)))


def fc_apply(p, ids: torch.Tensor):
    return _finish(p, fc_encode(p, ids), p["fc"][-1])


_PRECISION_LOCK = threading.Lock()


@contextlib.contextmanager
def ieee_convolutions():
    """cuDNN runs float32 convolutions in IEEE float32 inside, whatever
    the process-wide TF32 switches say, and gets them back on the way
    out. Torch leaves cuDNN's TF32 on by default, which lands a
    COSTMODEL_BASE forward ~3e-4 off (the f32 parity limit is 2e-4).

    The switches are process-wide, so a lock keeps two threads from
    restoring each other's values. Conv's per-op precision is set to
    "ieee" (a parent set to "tf32" cannot override it), and the legacy
    ``allow_tf32`` and RNN's precision move with it, as torch refuses to
    read the legacy switch while the three disagree."""
    cudnn = torch.backends.cudnn
    with _PRECISION_LOCK:
        try:
            prev_legacy = cudnn.allow_tf32
        except RuntimeError:    # the caller mixed the two APIs already
            prev_legacy = None
        prev = (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision)
        cudnn.allow_tf32 = False
        cudnn.conv.fp32_precision = cudnn.rnn.fp32_precision = "ieee"
        try:
            yield
        finally:
            if prev_legacy is not None:
                cudnn.allow_tf32 = prev_legacy
            cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = prev


class _IEEEConv1d(torch.autograd.Function):
    """``F.conv1d`` (no padding, no bias) whose forward AND backward run
    under :func:`ieee_convolutions`. Autograd runs the backward later, on
    its own thread, outside any context around the forward call, so the
    backward sets the switches itself."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with ieee_convolutions():
            return F.conv1d(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with ieee_convolutions():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [1], [0], [1], False, [0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """'same'-padded 1D cross-correlation. x: (B, S, Cin); w: (fs, Cin,
    Cout); b: (Cout,) -> (B, S, Cout).

    The padding is per layer and asymmetric: ``(fs-1)//2`` zeros on the
    left and ``fs//2`` on the right, so ``w[k]`` multiplies
    ``x[t - (fs-1)//2 + k]`` (an even ``fs`` looks right only).
    ``F.conv1d`` wants ``(Cout, Cin, fs)`` weights and channels-first
    activations, hence the permutes. A float32 convolution on the card
    runs in IEEE float32, forward and backward (:class:`_IEEEConv1d`);
    bf16 params keep cuDNN's bf16 path."""
    # DTensor's convolution handler serves only its own sequence-parallel
    # layout: on a mesh each rank convolves its own rows with the whole
    # (gathered) weight
    return SH.rowwise(_conv1d, x, w) + b


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    fs = w.shape[0]
    xc = F.pad(x.transpose(1, 2), ((fs - 1) // 2, fs // 2))
    wc = w.permute(2, 1, 0)
    if xc.is_cuda and xc.dtype == torch.float32:
        out = _IEEEConv1d.apply(xc, wc)
    else:
        out = F.conv1d(xc, wc)
    return out.transpose(1, 2)


def conv_encode(p, ids: torch.Tensor, *,
                pooled_only: bool = False) -> torch.Tensor:
    """Conv tower + MaxPool (+ hidden FC stack) -> shared features.

    The max-pool covers every position, pads included: the service's
    bucket ``pad_slack`` relies on exactly these semantics. The mask
    follows the embedding dtype, so bf16 params run a bf16 tower. A
    plain table's masked lookup is ``kernels/embed_grad.py``'s op, whose
    backward on the card is a kernel; a DTensor table's takes
    ``gather_rows``, which keeps the table's split."""
    emb = p["emb"]
    if isinstance(emb, SH.DTensor) or isinstance(ids, SH.DTensor):
        x = SH.gather_rows(emb, ids) * _mask(ids).to(emb.dtype)[..., None]
    else:
        x = EG.masked_gather(emb, ids)
    for layer in p["convs"]:
        x = torch.relu(conv1d(x, layer["w"], layer["b"]))
    x = x.amax(dim=1)                            # MaxPool1D over sequence
    return x if pooled_only else fc_stack(p, x)


def conv_apply(p, ids: torch.Tensor, *, pooled_feats: bool = False):
    pooled = conv_encode(p, ids, pooled_only=True)
    out = fc_finish(p, pooled)
    return (out, pooled) if pooled_feats else out


def lstm_scan(xw: torch.Tensor, mask: torch.Tensor,
              wh: torch.Tensor) -> torch.Tensor:
    """The masked LSTM recurrence in xw's dtype. xw: (B, S, 4H) input
    gates; mask: (B, S), 1 = valid; wh: (H, 4H). Each step's gates split
    in i, f, g, o order, the forget gate gets +1, and a padded step
    carries (h, c) through unchanged. Returns the final h, (B, H)."""
    h = torch.zeros((xw.shape[0], wh.shape[0]), dtype=xw.dtype,
                    device=xw.device)
    c = h
    for t in range(xw.shape[1]):
        gates = xw[:, t] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        keep = mask[:, t, None]
        h = h_new * keep + h * (1 - keep)
        c = c_new * keep + c * (1 - keep)
    return h


def lstm_encode(p, ids: torch.Tensor) -> torch.Tensor:
    """Masked LSTM scan -> final hidden state as shared features.

    The input projection covers every position (a PAD position gets
    ``emb[0] @ wx + b``, which its mask then skips). The mask and the
    initial state follow the embedding dtype, so bf16 params run a bf16
    scan, as in the reference. ``nn.LSTM`` has neither the forget bias
    nor the masked carry, hence :func:`lstm_scan`."""
    x = SH.gather_rows(p["emb"], ids)            # (B, S, E)
    xw = x @ p["wx"] + p["b"]                    # (B, S, 4H)
    return lstm_scan(xw, _mask(ids).to(x.dtype), p["wh"])


def lstm_apply(p, ids: torch.Tensor):
    return _finish(p, lstm_encode(p, ids), p.get("head"))


# The transformer's attention head count, fixed as in the reference.
XFORMER_HEADS = 4


def _ln(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """LayerNorm without a bias: the biased variance, eps 1e-5, written
    out so that bf16 stays bf16 at every step."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g


def xformer_encode(p, ids: torch.Tensor) -> torch.Tensor:
    """Masked transformer stack -> mean-pooled features. S <= the
    ``pos`` table's length (cfg.max_seq).

    PAD keys get an additive bias of -1e30 in the embedding's dtype
    (bf16 represents it) after the scores are divided by sqrt(dh). A row
    of PAD only thus attends uniformly and stays finite, where a boolean
    mask (or ``scaled_dot_product_attention``) may give NaN; its pooled
    features are 0. The attention is plain matmuls and ``softmax``."""
    emb = p["emb"]
    m = _mask(ids).to(emb.dtype)
    B, S = ids.shape
    d = emb.shape[1]
    h = SH.gather_rows(emb, ids) + p["pos"][:S]
    H = XFORMER_HEADS
    dh = d // H
    neg = ((1.0 - m)[:, None, None, :] * -1e30).to(m.dtype)
    scale = float(np.sqrt(dh))          # a Python float keeps bf16 bf16

    def split_heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)
    for blk in p["blocks"]:
        x = _ln(h, blk["ln1"])
        q, k, v = (x @ blk["wqkv"]).chunk(3, dim=-1)
        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        a = q @ k.transpose(-1, -2) / scale + neg
        o = (torch.softmax(a, dim=-1) @ v).transpose(1, 2)
        h = h + o.reshape(B, S, d) @ blk["wo"]
        x = _ln(h, blk["ln2"])
        h = h + F.gelu(x @ blk["w1"], approximate="tanh") @ blk["w2"]
    return _masked_mean(h, m)


def xformer_apply(p, ids: torch.Tensor):
    return _finish(p, xformer_encode(p, ids), p.get("head"))


# ------------------------------------------------ logical sharding axes
# The reference's trees of logical-axis tuples, one per param leaf (read
# by repro_torch.runtime.sharding when the trainer runs on a mesh).
def heads_axes(heads: Sequence[str]):
    return {t: {"w": (None, None), "b": (None,)} for t in heads}


def fc_axes(cfg, heads: Optional[Sequence[str]] = None):
    n_fc = len(cfg.fc_dims) + (0 if heads else 1)
    ax = {"emb": ("vocab", "embed"),
          "fc": [{"w": ("ffn", None) if i else ("embed", "ffn"),
                  "b": (None,)} for i in range(n_fc)]}
    if heads:
        ax["heads"] = heads_axes(heads)
    return ax


def lstm_axes(cfg, heads: Optional[Sequence[str]] = None):
    ax = {"emb": ("vocab", "embed"), "wx": ("embed", "ffn"),
          "wh": (None, "ffn"), "b": (None,)}
    if heads:
        ax["heads"] = heads_axes(heads)
    else:
        ax["head"] = {"w": (None, None), "b": (None,)}
    return ax


def conv_axes(cfg, heads: Optional[Sequence[str]] = None):
    n_fc = len(cfg.fc_dims) + (0 if heads else 1)
    ax = {"emb": ("vocab", "embed"),
          "convs": [{"w": (None, None, "ffn"), "b": ("ffn",)}
                    for _ in range(cfg.n_conv)],
          "fc": [{"w": ("ffn", None), "b": (None,)}
                 for _ in range(n_fc)]}
    if heads:
        ax["heads"] = heads_axes(heads)
    return ax


def xformer_axes(cfg, heads: Optional[Sequence[str]] = None):
    blk = {"wqkv": ("embed", "ffn"), "wo": (None, "embed"),
           "ln1": (None,), "ln2": (None,),
           "w1": ("embed", "ffn"), "w2": ("ffn", "embed")}
    ax = {"emb": ("vocab", "embed"), "pos": (None, "embed"),
          "blocks": [blk, blk]}
    if heads:
        ax["heads"] = heads_axes(heads)
    else:
        ax["head"] = {"w": (None, None), "b": (None,)}
    return ax


# kind -> (init, apply); the reference's third element, the axes, is
# get_axes(kind)
MODELS = {"fc": (fc_init, fc_apply),
          "lstm": (lstm_init, lstm_apply),
          "conv1d": (conv_init, conv_apply),
          "xformer": (xformer_init, xformer_apply)}

ENCODERS = {"fc": fc_encode,
            "lstm": lstm_encode,
            "conv1d": conv_encode,
            "xformer": xformer_encode}


def get_model(kind: str):
    if kind not in MODELS:
        raise KeyError(f"unknown model {kind!r}; one of {sorted(MODELS)}")
    return MODELS[kind]


AXES = {"fc": fc_axes, "lstm": lstm_axes, "conv1d": conv_axes,
        "xformer": xformer_axes}


def get_axes(kind: str):
    """``axes(cfg, heads=None)`` -> the logical-axis tree of ``kind``'s
    params (the reference's third item of ``get_model``)."""
    if kind not in AXES:
        raise KeyError(f"unknown model {kind!r}; one of {sorted(AXES)}")
    return AXES[kind]


def get_encoder(kind: str):
    if kind not in ENCODERS:
        raise KeyError(f"unknown model {kind!r}; one of {sorted(ENCODERS)}")
    return ENCODERS[kind]
