"""The kernel route's traces on the card (`launch/trace.py`,
`serve_step.lowered_paged_hlo`, `serve/sharded` `lowered_sharded_hlo`):
the paged steps hold none of `bulk_attn_shapes`, each layer's kernel
launch is in the trace with its output and its FLOPs, the combine
kernel merges a sharded arena's banks, only int32 tokens leave the
step, and `serve_throughput`'s `attention_hlo` record holds the kernel
route's bulk bytes at 0.  Every test needs a CUDA card and skips without one; this file
imports neither JAX nor the reference:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_trace_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.launch import trace as T
from repro_torch.launch.mesh import make_mem_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.serve.serve_step import (HLO_PROBE_GEOM, bulk_attn_shapes,
                                          lowered_paged_hlo)
from repro_torch.serve.sharded import lowered_sharded_hlo

# the reference tests' TINY["dense"], in bf16
CFG = ModelConfig(name="tiny-dense", family="dense", num_layers=2,
                  d_model=64, vocab_size=128, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, attn_chunk=32, max_seq=64,
                  dtype="bfloat16", param_dtype="bfloat16")


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_the_kernel_route_ships_no_bulk_buffer_on_card(cuda_device, which):
    name = {"decode": "paged_decode_attention",
            "prefill": "paged_prefill_attention"}[which]
    tr = lowered_paged_hlo(CFG, which, device=cuda_device, **HLO_PROBE_GEOM)
    types = tr.result_types()
    assert not set(bulk_attn_shapes(CFG, **HLO_PROBE_GEOM)) & types
    launches = [k for k in tr.kernels if k.name == name]
    assert len(launches) == CFG.num_layers
    assert all(k.outputs[0] in types for k in launches)
    _, tokens = tr.output
    assert T.tensor_type(tokens) == f"s32[{HLO_PROBE_GEOM['max_batch']}]"
    assert all(t[2] != "cpu" for t in tr.transfers)


@pytest.mark.cuda
def test_the_banks_merge_through_the_combine_kernel_on_card(cuda_device):
    mesh = make_mem_mesh(4)
    tr = lowered_sharded_hlo(CFG, mesh, "decode", device=cuda_device,
                             max_batch=2, max_seq=512, page_size=32)
    names = [k.name for k in tr.kernels]
    assert names.count("combine_splits") == CFG.num_layers
    assert names.count("paged_decode_attention") == 4 * CFG.num_layers
    assert all(k.flops > 0 for k in tr.kernels
               if k.name == "paged_decode_attention")
    bank = (2 * 512 // 32 // 4 + 1) * 32 * CFG.num_kv_heads \
        * CFG.head_dim * 2
    assert max(c.result_bytes for c in tr.collectives) < bank / 2


@pytest.mark.cuda
def test_serve_throughput_attention_hlo_on_card(cuda_device):
    from repro_torch.benchmarks import serve_throughput as ST
    h = ST.attention_hlo(cuda_device)
    assert h["ok"] and h["backend"] == "cuda"
    for which in ("decode", "prefill"):
        assert h[f"{which}_bulk_attn_bytes_before"] > 0
        assert h[f"{which}_bulk_attn_bytes_after"] == 0
        assert h[f"{which}_hbm_bytes_after"] > 0
