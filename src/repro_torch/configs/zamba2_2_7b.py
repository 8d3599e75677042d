"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; hf].

54 Mamba-2 layers, d_model=2560 (inner 5120, ssm_state=64), with a
shared transformer block applied every 6 layers (9 applications
alternating between 2 shared blocks) at width 2*d_model=5120: 32 heads
(kv=32, head_dim=160), d_ff=10240.  Same fields as
`repro.configs.zamba2_2_7b`.  The shipped `ssd_impl="xla"` takes the
plain SSD; `ssd_impl="pallas"` takes the SSD kernel.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        vocab_size=32_000,
        num_heads=32,
        num_kv_heads=32,
        head_dim=160,
        d_ff=10_240,
        activation="silu_glu",
        rope_theta=10_000.0,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        ssm_chunk=256,
        conv_width=4,
        shared_attn_period=6,
        num_shared_blocks=2,
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat="full",
        logits_chunk=512,
        attention_impl="flash_xla",
        attn_chunk=1024,
        max_seq=524_288,
    ),
    source="arXiv:2411.15242; hf Zyphra/Zamba2-2.7B",
    notes="hybrid: runs long_500k; one shared block's weights serve 9 "
          "layer positions.",
)
