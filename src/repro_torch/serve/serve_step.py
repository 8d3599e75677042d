"""Serving steps: paged prefill and decode with in-step sampling.

Port of `repro.serve.serve_step.make_paged_serve_fns`.  The reference
jits two closures and donates the arena so XLA updates it in place; here
the closures run eagerly under `torch.inference_mode()` and the paged
hooks update the arena tensors in place (`index_put_`).

Per call, the engine's host-built numpy tables (tokens, positions or
start/chunk_len, block table), and the sampling knobs when a row
samples, cross to the device in ONE transfer, and
the step returns int32 tokens on the device: reading them is the only
synchronisation of a tick (DESIGN.md §6 — logits never leave the step).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve.sampling import (SamplingState, device_knobs,
                                        host_knobs, sample_tokens)


def to_device(device, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Copy int32 host arrays to `device` in one transfer; returns
    contiguous views of the one device buffer, in the arrays' shapes."""
    flat = np.concatenate([np.asarray(a, np.int32).reshape(-1)
                           for a in arrays])
    buf = torch.from_numpy(flat).to(device)
    out, o = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a), dtype=np.int64))
        out.append(buf[o:o + n].view(np.shape(a)))
        o += n
    return out


def make_paged_serve_fns(cfg: ModelConfig, device):
    """Closures over the family's paged hooks.

    prefill_chunk(params, chunk, arena, block_table, start (b,),
                  chunk_len (b,), sampling) -> (arena, next_tokens (b,))
        `chunk` is {"tokens": (b, c)}: ONE bucketed width c serves every
        admitting row; chunk_len ragged-masks each row (0 = inert).  The
        returned tokens are sampled at each row's LAST VALID position.
    decode(params, arena, block_table, positions, tokens, sampling)
        -> (arena, next_tokens)

    Tables arrive as host numpy int32; the returned tokens are an int32
    device tensor."""
    fam = registry.get_family(cfg)
    if not registry.has_paged(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged serving path")
    device = torch.device(device)

    @torch.inference_mode()
    def prefill_chunk(params, chunk, arena, block_table, start, chunk_len,
                      sampling: SamplingState):
        tokens, bt, st, cl, *knobs = to_device(
            device, chunk["tokens"], block_table, start, chunk_len,
            *host_knobs(sampling))
        arena, logits = fam.paged_prefill(params, cfg, {"tokens": tokens},
                                          arena, bt, st, cl)
        return arena, sample_tokens(logits, sampling, device_knobs(knobs))

    @torch.inference_mode()
    def decode(params, arena, block_table, positions, tokens,
               sampling: SamplingState):
        bt, pos, tok, *knobs = to_device(device, block_table, positions,
                                         tokens, *host_knobs(sampling))
        arena, logits = fam.paged_decode_step(params, cfg, arena, bt, pos,
                                              tok)
        return arena, sample_tokens(logits, sampling, device_knobs(knobs))

    return prefill_chunk, decode
