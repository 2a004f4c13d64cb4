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
