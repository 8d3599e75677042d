"""yi-9b — dense llama-arch GQA [arXiv:2403.04652; hf].

48L, d_model=4096, 32 heads (GQA kv=4, head_dim=128), d_ff=11008,
vocab=64000, SwiGLU.  Same fields as `repro.configs.yi_9b`.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        vocab_size=64_000,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11_008,
        activation="silu_glu",
        rope_theta=10_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat="full",
        logits_chunk=512,
        attention_impl="flash_xla",
        attn_chunk=1024,
        max_seq=32_768,
    ),
    optimizer="adamw",
    train_grad_accum=2,
    rules="seq_parallel",
    source="arXiv:2403.04652; hf 01-ai/Yi-9B",
    notes="long_500k skipped: full attention (DESIGN.md §4).",
)
