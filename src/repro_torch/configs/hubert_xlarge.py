"""hubert-xlarge — audio encoder-only [arXiv:2106.07447].

48L, d_model=1280, 16 heads (kv=16 i.e. MHA, head_dim=80), d_ff=5120,
vocab=504 (masked-prediction codebook targets).  The modality frontend is
a STUB per the brief: `batch["frames"]` carries precomputed 512-dim conv
features (the wav2vec2/HuBERT conv stem output width).

Encoder-only: no decode shapes; "prefill_32k" lowers a plain inference
forward.  Same fields as `repro.configs.hubert_xlarge`; the port trains
it (`models/encoder.py`) and refuses to serve it.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        num_layers=48,
        d_model=1280,
        vocab_size=504,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        activation="gelu",
        causal=False,
        rope_theta=0.0,            # HuBERT uses conv rel-pos; stubbed out
        frontend="frame",
        frontend_dim=512,
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat="full",
        attention_impl="flash_xla",
        attn_chunk=1024,
        max_seq=32_768,
    ),
    optimizer="adamw",
    train_grad_accum=2,  # the reference's microbatching for train_4k
    source="arXiv:2106.07447 (unverified tier)",
    notes="decode/long shapes skipped: encoder-only (DESIGN.md §4).",
)
