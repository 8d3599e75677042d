"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct].

32L, d_model=3072, 32 heads (kv=32 i.e. MHA, head_dim=96), d_ff=8192,
vocab=32064.  The CLIP-L/14 frontend is a STUB per the brief:
`batch["patch_embeds"]` carries 576 precomputed 1024-dim patch
embeddings (336px / patch 14), projected by a 2-layer MLP and prepended
to the text sequence.  Same fields as `repro.configs.phi_3_vision_4_2b`.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        vocab_size=32_064,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        activation="silu_glu",
        rope_theta=10_000.0,
        frontend="patch",
        frontend_dim=1024,
        num_patches=576,
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
    source="hf microsoft/Phi-3-vision-128k-instruct",
    notes="long_500k skipped: full attention. Vision frontend stubbed "
          "(precomputed patch embeddings) per the brief.",
)
