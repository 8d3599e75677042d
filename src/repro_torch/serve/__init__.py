"""Paged-native serving on the UniMem arena (PyTorch port).

    core/unimem.py           host control plane: page pool, refcounts,
                             per-sequence page tables, copy-on-write
    serve/kv_cache.py        device arena (+ null page), in-place copies
    kernels/paged_*          hand-written CUDA paged attention (decode,
                             chunk prefill) + plain PyTorch versions
    models/transformer.py    dense paged hooks: init_paged_cache /
                             paged_prefill / paged_decode_step
    serve/serve_step.py      step closures: one host->device transfer in,
                             int32 tokens out (prefill, decode, verify);
                             decode_many, a fixed N-step decode loop
    serve/sampling.py        SamplingParams -> per-slot SamplingState;
                             greedy/temperature/top-k/top-p in the step
    serve/prefix_store.py    refcounted prompt-page sharing: donor lifetime,
                             or a persistent cache with host-DRAM spill
    serve/engine.py          continuous batching: lazy allocation,
                             chunked prefill, prefix sharing, preemption,
                             the TokenEvent/FinishEvent stream
    serve/speculative.py     DraftModel: draft proposals for speculative
                             decode, judged by the paged verify step
    serve/api.py             LLMServer.generate -> GenerationStream
"""
from repro_torch.serve.kv_cache import (
    PagedKVArena,
    paged_write,
    paged_decode_attention,
    gather_pages,
    insert_slot,
    clear_slot,
)
from repro_torch.serve.serve_step import (
    make_serve_fns, make_paged_serve_fns, make_paged_verify_fn,
    sample_logits, init_cache)
from repro_torch.serve.sampling import (
    SamplingParams, SamplingState, sample_tokens, state_for_slots,
    greedy_state, expand_state, verify_tokens)
from repro_torch.serve.speculative import DraftModel
from repro_torch.serve.prefix_store import PrefixStore, PrefixEntry
from repro_torch.serve.engine import (FinishEvent, Request, Result,
                                      ServingEngine, TokenEvent)
from repro_torch.serve.api import GenerationStream, LLMServer
