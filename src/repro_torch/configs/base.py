"""Config system: assigned shapes, per-arch settings, dry-run input specs.

Port of `repro.configs.base`.  Every assigned architecture is a module
in this package exporting `ARCH: ArchSpec`.  The four assigned input
shapes are global; which (arch x shape) cells exist follows DESIGN.md
§4:

  * long_500k needs sub-quadratic attention -> ssm/hybrid only;
  * decode shapes need an autoregressive decode path -> encoder skips;
  * encoder "prefill" is a plain inference forward (no cache).

An input spec is a tensor on the "meta" device, PyTorch's counterpart
of a `jax.ShapeDtypeStruct`: a shape and a dtype, no storage.
`input_specs` builds them for every cell kind and `param_specs` is the
family's init on "meta": the dry-run traces against these, and nothing
is allocated.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models import registry


# ------------------------------------------------------------------ shapes

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


# ------------------------------------------------------------------- archs

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


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skip) for one (arch, shape) cell."""
    if shape.name == "long_500k":
        if not registry.supports_long_context(cfg):
            return False, "full-attention arch: 500k decode is quadratic (DESIGN.md §4)"
        return True, ""
    if shape.kind == "decode" and not registry.has_decode(cfg):
        return False, "encoder-only arch: no autoregressive decode"
    return True, ""


def applicable_cells(archs: dict[str, "ArchSpec"]):
    """All runnable (arch_name, shape_name) cells + the skip table."""
    cells, skips = [], []
    for aname, spec in archs.items():
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(spec.model, shape)
            (cells if ok else skips).append(
                (aname, sname) if ok else (aname, sname, why))
    return cells, skips


# ------------------------------------------------------------- input specs

def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(shape):
    return _spec(shape, torch.int32)


def _f32(shape):
    return _spec(shape, torch.float32)


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encoder":
        return {"frames": _f32((b, s, cfg.frontend_dim)),
                "mask": _spec((b, s), torch.bool),
                "labels": _i32((b, s))}
    batch = {"tokens": _i32((b, s)), "labels": _i32((b, s))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _f32((b, cfg.num_patches, cfg.frontend_dim))
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encoder":
        return {"frames": _f32((b, s, cfg.frontend_dim))}
    batch = {"tokens": _i32((b, s))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _f32((b, cfg.num_patches, cfg.frontend_dim))
    return batch


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """The family's contiguous cache on "meta"."""
    fam = registry.get_family(cfg)
    return fam.init_cache(cfg, batch, max_seq, device=torch.device("meta"))


def decode_token_specs(shape: ShapeSpec):
    return _i32((shape.global_batch,))


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """All inputs the cell's step function takes (params excluded)."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        specs = {"batch": prefill_batch_specs(cfg, shape)}
        if registry.has_decode(cfg):
            # VLM prefill writes patch + text positions into the cache
            s = shape.seq_len + (cfg.num_patches if cfg.family == "vlm" else 0)
            specs["cache"] = cache_specs(cfg, shape.global_batch, s)
        return specs
    if shape.kind == "decode":
        return {
            "cache": cache_specs(cfg, shape.global_batch, shape.seq_len),
            "tokens": decode_token_specs(shape),
        }
    raise ValueError(shape.kind)


def param_specs(cfg: ModelConfig):
    """The family's parameters on "meta": every leaf's shape and dtype."""
    return registry.get_family(cfg).init(0, cfg, torch.device("meta"))
