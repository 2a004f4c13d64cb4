"""Plain PyTorch versions of the kernels (the allclose yardsticks).

On the card, run them as float32 yardsticks with TF32 off
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` both False): cuDNN runs
float32 convolutions in TF32 by default, whose 10-bit mantissa puts
outputs of a few tenths outside the kernels' 2e-4 parity.
"""
from __future__ import annotations

import torch

from repro_torch.core import models as CM
from repro_torch.params import tree_map


# 'same'-padded 1D conv, x: (B, S, Cin); w: (fs, Cin, Cout); b: (Cout,)
conv1d_same = CM.conv1d


def conv1d_stack_ref(x, weights, biases, mask=None):
    """The plain version of kernels/conv1d_stack.py::conv1d_stack_fused:
    L x ("same" conv + bias + ReLU), then the max over the sequence,
    (B, S, C0) -> (B, C_last), in x's dtype. With ``mask`` (B, S), the
    positions where it is 0 never enter the max (they become -inf), and
    the result is floored at 0, so an all-masked row pools to 0."""
    h = x
    for w, b in zip(weights, biases):
        h = torch.relu(conv1d_same(h, w, b))
    if mask is None:
        return h.amax(dim=1)
    h = torch.where(mask[..., None] > 0, h, float("-inf"))
    return torch.clamp_min(h.amax(dim=1), 0.0)


def lstm_scan_ref(xw, mask, wh, head_w=None, head_b=None):
    """The plain version of kernels/lstm_scan.py::lstm_scan_fused: the
    masked LSTM recurrence in float32. xw: (B, S, 4H) input gates
    (``x @ wx + b``); mask: (B, S), 1 = valid; wh: (H, 4H). Gates in
    i, f, g, o order, forget gate +1, a padded step carries (h, c)
    through unchanged. Returns the final h, (B, H) float32, or with
    stacked heads (H, n) + (n,) their (B, n) float32 predictions."""
    h = CM.lstm_scan(xw.float(), mask.float(), wh.float())
    if head_w is None:
        return h
    return h @ head_w.float() + head_b.float()


def lstm_scan_ids_ref(table, ids, wh, head_w=None, head_b=None):
    """The plain version of kernels/lstm_scan.py::lstm_scan_ids: the
    recurrence of :func:`lstm_scan_ref` on the gates ``table[ids]``, with
    a step valid where its id lies in [1, V). For ids in [0, V) that is
    ``lstm_scan_ref(table[ids], (ids != 0).float(), ...)``; an id outside
    the table reads as PAD, as in the kernel."""
    valid = (ids > 0) & (ids < table.shape[0])
    xw = table[torch.where(valid, ids, torch.zeros_like(ids))]
    return lstm_scan_ref(xw, valid.float(), wh, head_w, head_b)


def conv_forward_fused_ref(ids, emb, conv_weights, conv_biases,
                           fc_weights, fc_biases, head_w, head_b):
    """The plain version of kernels/conv1d_stack.py::conv_forward_fused,
    on the same arguments: (B, S) ids -> (B, n_heads) float32. The model
    code itself, on every param widened to float32, with the stacked
    heads as the single-head layout's last FC layer."""
    def layer(w, b):
        return {"w": w.float(), "b": b.float()}
    p = {"emb": emb.float(),
         "convs": [layer(w, b) for w, b in zip(conv_weights, conv_biases)],
         "fc": [layer(w, b) for w, b in zip(fc_weights, fc_biases)]
         + [layer(head_w, head_b)]}
    feats = CM.fc_stack(p, CM.conv_encode(p, ids, pooled_only=True))
    return feats @ p["fc"][-1]["w"] + p["fc"][-1]["b"]


def conv_forward_ref(params, ids: torch.Tensor):
    """Ids-in/predictions-out version of the fused conv forward:
    core/models.py::conv_apply on float32-cast params (the kernel's
    contract is exact conv_apply semantics, unmasked max-pool included,
    with float32 accumulation whatever the param dtype)."""
    p32 = tree_map(lambda a: a.float() if a.is_floating_point() else a,
                   params)
    return CM.conv_apply(p32, ids)


def decode_attention_ref(q, k_cache, v_cache, index):
    """Grouped decode attention oracle. q: (B, nkv, G, D);
    k_cache/v_cache: (B, nkv, S, D); attends positions <= index. float32
    whatever the inputs' dtype. No kernel stands behind it: the LM
    decode path (models/layers.py::attention_apply) runs plain PyTorch."""
    D = q.shape[-1]
    logits = torch.einsum("bhgd,bhsd->bhgs", q.float(),
                          k_cache.float()) / D ** 0.5
    S = k_cache.shape[2]
    valid = torch.arange(S, device=q.device) <= index
    logits = torch.where(valid[None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", w, v_cache.float())
