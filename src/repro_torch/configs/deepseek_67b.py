"""deepseek-67b — dense llama-arch GQA [arXiv:2401.02954; hf].

95L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=22016,
vocab=102400, SwiGLU.  ~67B params: the FSDP+TP weight-stationary
flagship of the dense family.  Same fields as `repro.configs.deepseek_67b`;
95 layers of bf16 weights (~131 GB) do not fit one 80 GB card, so the
port's card runs serve it at reduced depth.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        vocab_size=102_400,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22_016,
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
    optimizer="adafactor",
    train_grad_accum=2,     # the reference's microbatching for train_4k
    rules="seq_parallel",
    source="arXiv:2401.02954; hf deepseek-ai/deepseek-llm-67b-base",
    notes="long_500k skipped: full attention (DESIGN.md §4).",
)
