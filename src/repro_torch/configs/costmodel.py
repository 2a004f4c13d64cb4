"""Configs for the paper's cost model (tokenizer + Conv1D/LSTM/FC regressors).

The paper fixes: embedding dim 64; 6 stacked Conv1D (filter size 2 for the
ops-only tokenization; 16,16,8,8,2,1 for ops+operands), one MaxPool1D, 3 FC
layers. Channel widths are not given in the paper; we use 64 throughout for
the base model (matching the embedding width) and note this in DESIGN.md.

``COSTMODEL_100M`` is the scaled config used by the end-to-end training
driver (examples/train_costmodel_100m.py): same topology, wide channels.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CostModelConfig:
    name: str
    vocab_size: int            # filled after tokenizer fit; this is the cap
    max_seq: int               # token sequence length (padded/truncated)
    embed_dim: int = 64
    conv_filters: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)       # ops-only (Fig 5)
    conv_channels: Tuple[int, ...] = (64, 64, 64, 64, 64, 64)
    # two hidden FC; the final scalar head is the 3rd
    fc_dims: Tuple[int, ...] = (256, 64)
    lstm_hidden: int = 128
    dropout: float = 0.0
    dtype: str = "float32"

    @property
    def n_conv(self) -> int:
        return len(self.conv_filters)


# Small config for unit tests.
COSTMODEL_SMALL = CostModelConfig(
    name="costmodel-small", vocab_size=512, max_seq=64,
    embed_dim=16, conv_channels=(16,) * 6, fc_dims=(32, 16), lstm_hidden=16)

# Paper-faithful base: ops-only tokenization, fs=2 x6 (Fig 5).
COSTMODEL_BASE = CostModelConfig(
    name="costmodel-base", vocab_size=8192, max_seq=256)

# Ops+operands variant: fs = 16,16,8,8,2,1 (Fig 6), ~4x longer sequences.
COSTMODEL_OPERAND = CostModelConfig(
    name="costmodel-operand", vocab_size=16384, max_seq=1024,
    conv_filters=(16, 16, 8, 8, 2, 1))

# ~100M-parameter scaled config for the end-to-end distributed driver.
# params: 32768*512 emb (16.8M) + convs (~21M) + fc 2048 (~65M) ~= 103M
COSTMODEL_100M = CostModelConfig(
    name="costmodel-100m", vocab_size=32768, max_seq=1024, embed_dim=512,
    conv_filters=(16, 16, 8, 8, 2, 1),
    conv_channels=(1024, 1024, 1024, 1024, 1024, 1024),
    fc_dims=(2048, 512), lstm_hidden=512)
