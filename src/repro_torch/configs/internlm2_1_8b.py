"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf].

24L, d_model=2048, 16 heads (GQA kv=8, head_dim=128), d_ff=8192,
vocab=92544, SwiGLU.  Same fields as `repro.configs.internlm2_1_8b`.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        vocab_size=92_544,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        activation="silu_glu",
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat="dots",
        logits_chunk=512,
        attention_impl="flash_xla",
        attn_chunk=1024,
        max_seq=32_768,
    ),
    optimizer="adamw",
    train_grad_accum=4,   # the reference's microbatching for train_4k
    source="arXiv:2403.17297; hf internlm/internlm2-1_8b",
    notes="long_500k skipped: full attention (DESIGN.md §4).",
)
