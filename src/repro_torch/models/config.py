"""Model configuration — one dataclass drives every architecture.

Field-for-field copy of `repro.models.config.ModelConfig`, so a config
built for the reference converts here with `ModelConfig(**fields)` and
the tests can compare the two.  Dtypes map to torch dtypes.

`attn_pages_per_block` stays as a field for that parity: it sizes the
TPU kernel's sequential grid cell, and the CUDA kernels do not read it
(each block walks its pages in tiles of its own size).  `mem_axis` set
(by `serve/sharded/serve_step.py`) makes the paged hooks walk a sharded
arena's banks and merge their summaries (`models/layers.py`);
`scan_layers` is carried but unused: the port's layer loop is a Python
loop either way.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

# paged-KV storage dtypes (core/unimem.py owns the quantize/dequantize
# contract; fp8 is float8_e4m3fn, clipped to its finite range on write)
KV_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8,
             "fp8": torch.float8_e4m3fn}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    vocab_size: int

    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    causal: bool = True
    attention_impl: str = "flash_xla"    # dense | flash_xla | flash_pallas
    attn_chunk: int = 1024
    attn_pages_per_block: int = 1        # TPU grid knob; unread by CUDA
    mem_axis: str | None = None

    # mlp
    d_ff: int = 0
    activation: str = "silu_glu"         # silu_glu | relu2 | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    moe_dispatch: str = "scatter"        # scatter | grouped | ep | dense

    # ssm (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    ssd_impl: str = "xla"                # xla | pallas (the SSD kernel)
    conv_width: int = 4

    # hybrid (zamba2)
    shared_attn_period: int = 0
    num_shared_blocks: int = 0

    # modality frontend stubs
    frontend: str = "none"               # none | patch | frame
    frontend_dim: int = 0
    num_patches: int = 0

    # numerics / execution
    dtype: str = "float32"
    param_dtype: str = "float32"
    kv_dtype: str | None = None          # None | bf16 | int8 | fp8
    remat: str = "none"
    logits_chunk: int = 0
    scan_layers: bool = True
    max_seq: int = 8192

    # ------------------------------------------------------------ derived

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def params_dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def kv_store_dtype(self) -> torch.dtype:
        """Element dtype of the paged KV page banks."""
        if self.kv_dtype is None:
            return self.compute_dtype
        return KV_DTYPES[self.kv_dtype]

    @property
    def kv_quantized(self) -> bool:
        """True when the arena carries per-page scale leaves (int8/fp8)."""
        return self.kv_dtype in ("int8", "fp8")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    # ssm derived (Mamba-2 conventions)
    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def conv_channels(self) -> int:
        # conv runs over x plus the B and C streams (Mamba-2 layout)
        return self.ssm_inner + 2 * self.ssm_groups * self.ssm_state

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """The reference's checks, raising ValueError where it asserts."""
        def need(ok: bool, what: str) -> None:
            if not ok:
                raise ValueError(f"{self.name}: {what}")
        need(self.kv_dtype in (None, *KV_DTYPES),
             f"kv_dtype must be one of {(None, *KV_DTYPES)}, got "
             f"{self.kv_dtype!r}")
        if self.family in ("dense", "moe", "encoder", "vlm", "hybrid"):
            need(self.num_heads > 0 and self.head_dim > 0
                 and self.num_heads % max(1, self.num_kv_heads) == 0,
                 "bad attention geometry")
        if self.family == "moe":
            need(self.num_experts > 0 and self.experts_per_token > 0,
                 "moe needs num_experts and experts_per_token")
        if self.family in ("ssm", "hybrid"):
            need(self.ssm_state > 0 and self.ssm_inner % self.ssm_head_dim == 0,
                 "bad ssm geometry")
        if self.family == "hybrid":
            need(self.shared_attn_period > 0
                 and self.num_layers % self.shared_attn_period == 0,
                 "num_layers must be a multiple of shared_attn_period")
        if self.family == "vlm":
            need(self.frontend == "patch" and self.num_patches > 0,
                 "vlm needs the patch frontend")
        if self.family == "encoder":
            need(not self.causal, "an encoder is not causal")


def reduced_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink any config to CPU-smoke-test size, same family/topology
    (the reference's rule, field for field)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        vocab_size=min(cfg.vocab_size, 512),
        max_seq=256,
        dtype="float32",
        param_dtype="float32",
        attn_chunk=64,
        ssm_chunk=32,
        logits_chunk=0,
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = min(cfg.num_kv_heads, 4) or 4
        if cfg.num_kv_heads and cfg.num_heads % cfg.num_kv_heads == 0:
            ratio = max(1, min(4, cfg.group_size))
            kw["num_kv_heads"] = max(1, 4 // ratio)
        kw["head_dim"] = 32
    if cfg.d_ff:
        kw["d_ff"] = 256
    if cfg.num_experts:
        kw["num_experts"] = min(cfg.num_experts, 8)
        kw["experts_per_token"] = min(cfg.experts_per_token, 2)
        kw["moe_d_ff"] = 64
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 32)
        kw["ssm_head_dim"] = 32
    if cfg.shared_attn_period:
        kw["num_layers"] = 4
        kw["shared_attn_period"] = 2
    if cfg.frontend == "patch":
        kw["num_patches"] = 16
        kw["frontend_dim"] = 64
    if cfg.frontend == "frame":
        kw["frontend_dim"] = 128
    kw.update(overrides)
    return cfg.replace(**kw)
