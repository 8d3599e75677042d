"""nemotron-4-340b — dense GQA, squared-ReLU [arXiv:2402.16819].

96L, d_model=18432, 96 heads (GQA kv=8, head_dim=192), d_ff=73728,
vocab=256000, squared-ReLU MLP (no GLU).  The 340B-class memory
stress test: adafactor moments + full remat + heavy grad accumulation.
Same fields as `repro.configs.nemotron_4_340b`; one layer is ~6.9 GB of
bf16 weights and the embedding and head ~18.9 GB, so the port's card
runs serve it at reduced depth.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18_432,
        vocab_size=256_000,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73_728,
        activation="relu2",
        rope_theta=10_000.0,
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat="full",
        logits_chunk=256,
        attention_impl="flash_xla",
        attn_chunk=1024,
        max_seq=32_768,
    ),
    optimizer="adafactor",
    train_grad_accum=1,
    rules="seq_parallel",
    source="arXiv:2402.16819 (unverified tier)",
    notes="long_500k skipped: full attention (DESIGN.md §4).",
)
