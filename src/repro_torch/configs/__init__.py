"""Architecture registry: ``--arch <id>`` resolves here.

The port registers the architectures whose families it serves: the
dense `internlm2-1.8b`, the MoE `qwen3-moe-30b-a3b`, the hybrid
`zamba2-2.7b` and the pure-SSM `mamba2-130m`; the other architectures
of `repro.configs` arrive with the slices that port their families
(ROADMAP.md queue A item 10)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec  # noqa: F401 (re-exported)


_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-130m": "mamba2_130m",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> ArchSpec:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    spec: ArchSpec = mod.ARCH
    spec.model.validate()
    return spec
