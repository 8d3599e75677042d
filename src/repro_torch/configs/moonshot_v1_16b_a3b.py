"""moonshot-v1-16b-a3b — MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B].

48L, d_model=2048, 16 heads (kv=16 i.e. MHA, head_dim=128), per-expert
d_ff=1408, vocab=163840, 64 experts top-6 + 2 DeepSeek-style shared
experts (the Moonlight recipe).  16B total / ~3B active.  Same fields as
`repro.configs.moonshot_v1_16b_a3b`.  The shipped `moe_dispatch="ep"`
serves through the einsum dispatch off a mesh, as in the reference;
`moe_dispatch="grouped"` serves through the grouped-matmul kernel.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        vocab_size=163_840,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        num_experts=64,
        experts_per_token=6,
        moe_d_ff=1408,
        num_shared_experts=2,
        capacity_factor=1.25,
        moe_dispatch="ep",
        activation="silu_glu",
        rope_theta=50_000.0,
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
    source="hf moonshotai/Moonlight-16B-A3B",
    notes="long_500k skipped: full attention (DESIGN.md §4).",
)
