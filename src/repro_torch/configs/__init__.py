"""Architecture registry: ``--arch <id>`` resolves here.

The port registers every architecture of `repro.configs`, in its order
and with its fields: the dense `deepseek-67b`, `internlm2-1.8b`,
`nemotron-4-340b` and `yi-9b`, the encoder `hubert-xlarge`, the
pure-SSM `mamba2-130m`, the hybrid `zamba2-2.7b`, the MoE
`qwen3-moe-30b-a3b` and `moonshot-v1-16b-a3b` and the vlm
`phi-3-vision-4.2b`."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401 (re-exported)
    ArchSpec,
    ShapeSpec,
    SHAPES,
    shape_applicable,
    applicable_cells,
    input_specs,
    param_specs,
    train_batch_specs,
    prefill_batch_specs,
    cache_specs,
)


# arch id -> module, in the reference's order
_MODULES = {
    "deepseek-67b": "deepseek_67b",
    "internlm2-1.8b": "internlm2_1_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "yi-9b": "yi_9b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-130m": "mamba2_130m",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> ArchSpec:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    spec: ArchSpec = mod.ARCH
    spec.model.validate()
    return spec


def all_archs() -> dict[str, ArchSpec]:
    return {name: get_arch(name) for name in _MODULES}
