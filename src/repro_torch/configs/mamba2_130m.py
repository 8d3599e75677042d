"""mamba2-130m — SSM, attention-free (SSD) [arXiv:2405.21060].

24 layers, d_model=768, vocab=50280, ssm_state=128, expand=2 (inner
1536, head_dim 64 -> 24 ssm heads), tied embeddings.  Same fields as
`repro.configs.mamba2_130m`.  The ssm family serves from the contiguous
layout; the shipped `ssd_impl="xla"` takes the plain SSD,
`ssd_impl="pallas"` the SSD kernel.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        vocab_size=50_280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        ssm_chunk=256,
        conv_width=4,
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat="full",
        logits_chunk=512,
        tie_embeddings=True,
        max_seq=524_288,
    ),
    optimizer="adamw",
    train_grad_accum=2,
    source="arXiv:2405.21060 (unverified tier); state-spaces/mamba2-130m",
    notes="attention-free: no KV cache; the conv/SSM state is O(1) per "
          "sequence.",
)
