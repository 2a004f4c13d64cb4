"""Config registry: ``get_arch(name)`` / ``ARCHS`` / ``SHAPES``."""
from repro_torch.configs.base import (ArchConfig, MoEConfig, HybridConfig,
                                      XLSTMConfig, ShapeConfig, SHAPES,
                                      shape_eligible)

from repro_torch.configs.xlstm_125m import CONFIG as xlstm_125m
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.phi35_moe_42b_a66b import CONFIG as phi35_moe_42b_a66b
from repro_torch.configs.qwen15_32b import CONFIG as qwen15_32b
from repro_torch.configs.qwen3_06b import CONFIG as qwen3_06b
from repro_torch.configs.starcoder2_3b import CONFIG as starcoder2_3b
from repro_torch.configs.qwen3_17b import CONFIG as qwen3_17b
from repro_torch.configs.whisper_small import CONFIG as whisper_small
from repro_torch.configs.llava_next_34b import CONFIG as llava_next_34b
from repro_torch.configs.jamba_v01_52b import CONFIG as jamba_v01_52b
from repro_torch.configs.jamba2_3b import CONFIG as jamba2_3b
from repro_torch.configs.costmodel import (COSTMODEL_SMALL, COSTMODEL_BASE,
                                           COSTMODEL_100M)

ARCHS = {c.name: c for c in [
    xlstm_125m, granite_moe_1b_a400m, phi35_moe_42b_a66b, qwen15_32b,
    qwen3_06b, starcoder2_3b, qwen3_17b, whisper_small, llava_next_34b,
    jamba_v01_52b,
]}

# archs the port runs that the reference package does not have; ARCHS
# stays the reference's list
PORT_ARCHS = {c.name: c for c in [jamba2_3b]}


def get_arch(name: str) -> ArchConfig:
    found = ARCHS.get(name) or PORT_ARCHS.get(name)
    if found is None:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
    return found


__all__ = ["ArchConfig", "MoEConfig", "HybridConfig", "XLSTMConfig",
           "ShapeConfig", "SHAPES", "ARCHS", "get_arch", "shape_eligible",
           "COSTMODEL_SMALL", "COSTMODEL_BASE", "COSTMODEL_100M"]
