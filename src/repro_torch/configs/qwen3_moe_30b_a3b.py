"""qwen3-moe-30b-a3b — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32 heads (GQA kv=4, head_dim=128), per-expert
d_ff=768, vocab=151936.  Same fields as `repro.configs.qwen3_moe_30b_a3b`.
The shipped `moe_dispatch="ep"` serves through the einsum dispatch off a
mesh, as in the reference; `moe_dispatch="grouped"` serves through the
grouped-matmul kernel.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        vocab_size=151_936,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        num_experts=128,
        experts_per_token=8,
        moe_d_ff=768,
        num_shared_experts=0,
        capacity_factor=1.25,
        moe_dispatch="ep",
        activation="silu_glu",
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat="full",
        logits_chunk=512,
        attention_impl="flash_xla",
        attn_chunk=1024,
        max_seq=32_768,
    ),
    optimizer="adamw",
    train_grad_accum=4,
    rules="seq_parallel",
    source="hf Qwen/Qwen3-30B-A3B",
    notes="long_500k skipped: full attention (DESIGN.md §4).",
)
