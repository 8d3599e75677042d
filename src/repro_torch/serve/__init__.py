"""Paged-native serving on the UniMem arena (PyTorch port).

    core/unimem.py           host control plane: page pool, refcounts,
                             per-sequence page tables, copy-on-write
    serve/kv_cache.py        device arena (+ null page), in-place copies
    kernels/paged_*          hand-written CUDA paged attention (decode,
                             chunk prefill) + plain PyTorch versions
    models/transformer.py    dense paged hooks: init_paged_cache /
                             paged_prefill / paged_decode_step
    serve/serve_step.py      step closures: one host->device transfer in,
                             int32 tokens out
    serve/sampling.py        SamplingParams -> per-slot SamplingState;
                             greedy/temperature/top-k/top-p in the step
    serve/prefix_store.py    refcounted prompt-page sharing (donor lifetime)
    serve/engine.py          continuous batching: lazy allocation,
                             chunked prefill, prefix sharing, preemption,
                             the TokenEvent/FinishEvent stream
    serve/api.py             LLMServer.generate -> GenerationStream
"""
