"""Config system: the assigned shapes, per-arch training settings and
the training batch's input specs.

Port of `repro.configs.base` (`ShapeSpec`, `SHAPES`, `ArchSpec`,
`train_batch_specs`).  An input spec is a tensor on the "meta" device,
PyTorch's counterpart of a `jax.ShapeDtypeStruct`: a shape and a dtype,
no storage.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ArchSpec:
    """A registered architecture: its model config, its training settings
    and provenance."""
    model: ModelConfig
    optimizer: str = "adamw"         # adamw | adafactor (340B-class memory)
    train_grad_accum: int = 1        # microbatching for train_4k
    rules: str = "default"           # default | seq_parallel (sharding rules)
    notes: str = ""
    source: str = ""                 # public provenance tag


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encoder":
        return {"frames": _spec((b, s, cfg.frontend_dim), torch.float32),
                "mask": _spec((b, s), torch.bool),
                "labels": _spec((b, s), torch.int32)}
    batch = {"tokens": _spec((b, s), torch.int32),
             "labels": _spec((b, s), torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _spec((b, cfg.num_patches, cfg.frontend_dim),
                                      torch.float32)
    return batch
