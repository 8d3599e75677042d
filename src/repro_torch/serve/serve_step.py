"""Serving steps: prefill and decode with in-step sampling, over the
contiguous cache (`make_serve_fns`) or the paged arena
(`make_paged_serve_fns`), and the speculative verify step over the
arena (`make_paged_verify_fn`).

Port of `repro.serve.serve_step`.  The reference jits the closures and
donates the cache so XLA updates it in place; here the closures run
eagerly under `torch.inference_mode()` and the family hooks update the
cache or arena tensors in place.  `decode_many` (a fixed-schedule loop
the engine does not use, the reference's one-dispatch scan) keeps its
tokens and key on the device for the whole loop: reading the tokens it
returns is its one synchronisation.

Per call, the engine's host-built numpy tables (tokens, positions or
start/chunk_len, block table), the vlm's f32 patch rows, and the
sampling knobs when a row samples, cross to the device in ONE transfer,
and
the step returns int32 tokens on the device: reading them is the only
synchronisation of a tick (DESIGN.md §6 — logits never leave the step).

`lowered_paged_hlo` is the counterpart of the reference's compiled-HLO
probe: the `launch/trace.py` Trace of one paged step call, whose result
types carry the reference's HLO type strings (`bulk_attn_shapes`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import trace as T
from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve import prng
from repro_torch.serve.sampling import (SamplingState, device_knobs,
                                        expand_state, greedy_state,
                                        host_knobs, sample_tokens,
                                        verify_tokens)
from repro_torch.utils.device import resolve_device


def to_device(device, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Copy host arrays to `device` in one transfer; returns contiguous
    views of the one device buffer, in the arrays' shapes.  float32
    arrays cross as their bits and come back float32; everything else
    comes back int32."""
    f32 = [np.asarray(a).dtype == np.float32 for a in arrays]
    flat = np.concatenate([
        (np.ascontiguousarray(a, np.float32).view(np.int32) if f
         else np.asarray(a, np.int32)).reshape(-1)
        for a, f in zip(arrays, f32)])
    buf = torch.from_numpy(flat).to(device)
    out, o = [], 0
    for a, f in zip(arrays, f32):
        n = int(np.prod(np.shape(a), dtype=np.int64))
        part = buf[o:o + n]
        out.append((part.view(torch.float32) if f else part)
                   .view(np.shape(a)))
        o += n
    return out


def _host_batch(batch: dict) -> tuple[list[str], list[np.ndarray]]:
    """A step's host inputs in a fixed order: "tokens", then the vlm's
    patch rows ("patch_embeds" or "patches", f32) when present."""
    keys = [k for k in ("tokens", "patch_embeds", "patches") if k in batch]
    return keys, [batch[k] for k in keys]


def sample_logits(logits, key, temperature: float):
    """logits: (b, V) -> tokens (b,) int32.  The reference's legacy
    single-temperature sampler, kept for `decode_many` (the engine
    samples per request through `SamplingState`): the argmax at
    temperature 0, else `jax.random.categorical(key, logits /
    temperature)` over the whole (b, V) plane, one key of (2,) words
    (`prng.key`), bit for bit in its uniforms."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    b, v = scaled.shape
    noise = prng.gumbel(key[0:1], key[1:2], b * v).reshape(b, v)
    return torch.argmax(noise + scaled, dim=-1).to(torch.int32)


def make_serve_fns(cfg: ModelConfig, device, *, temperature: float = 0.0):
    """Closures over the family's contiguous-cache hooks.

    prefill(params, batch, cache) -> (cache, logits (b, vocab))
        `batch` is {"tokens": (b, s)} host int32 (and the vlm's
        "patch_embeds" (b, num_patches, frontend_dim) f32): whole
        prompts of one length from position 0.  The engine samples the first token
        from the logits on the device.
    decode(params, cache, tokens, sampling) -> (cache, next_tokens (b,))
        Every row advances; only int32 tokens leave the step.
    decode_many(params, cache, tokens, key, num_steps)
        -> (cache, tokens (b, num_steps), key)
        `num_steps` decode steps from `tokens` ((b,) int32, host or
        device), each sampled by `sample_logits` at `temperature` with
        a subkey split from `key` ((2,) words, `prng.key`) as the
        reference's scan body splits it.  The tokens and the key stay
        on the device between steps: nothing in the loop reads them.

    The returned tokens are an int32 device tensor."""
    fam = registry.get_family(cfg)
    device = torch.device(device)

    @torch.inference_mode()
    def prefill(params, batch, cache):
        keys, arrays = _host_batch(batch)
        return fam.prefill(params, cfg,
                           dict(zip(keys, to_device(device, *arrays))), cache)

    @torch.inference_mode()
    def decode(params, cache, tokens, sampling: SamplingState):
        tok, *knobs = to_device(device, tokens, *host_knobs(sampling))
        cache, logits = fam.decode_step(params, cfg, cache, tok)
        return cache, sample_tokens(logits, sampling, device_knobs(knobs))

    @torch.inference_mode()
    def decode_many(params, cache, tokens, key, num_steps: int):
        tok = torch.as_tensor(tokens).to(device, torch.int32)
        k0, k1 = torch.as_tensor(key).to(device, torch.int64)
        out = []
        for _ in range(num_steps):
            cache, logits = fam.decode_step(params, cfg, cache, tok)
            y0, y1 = prng.split(k0, k1)          # key, sub = split(key)
            k0, k1 = y0[0], y1[0]
            tok = sample_logits(logits, torch.stack([y0[1], y1[1]]),
                                temperature)
            out.append(tok)
        return cache, torch.stack(out, dim=1), torch.stack([k0, k1])

    return prefill, decode, decode_many


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device):
    """The family's contiguous cache for `batch` rows of `max_seq`."""
    return registry.get_family(cfg).init_cache(cfg, batch, max_seq,
                                               device=device)


def make_paged_serve_fns(cfg: ModelConfig, device):
    """Closures over the family's paged hooks.

    prefill_chunk(params, chunk, arena, block_table, start (b,),
                  chunk_len (b,), sampling) -> (arena, next_tokens (b,))
        `chunk` is {"tokens": (b, c)} (and the vlm's "patches" (b, c,
        frontend_dim) f32 plane): ONE bucketed width c serves every
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
        keys, arrays = _host_batch(chunk)
        n = len(arrays)
        got = to_device(device, *arrays, block_table, start, chunk_len,
                        *host_knobs(sampling))
        (bt, st, cl), knobs = got[n:n + 3], got[n + 3:]
        arena, logits = fam.paged_prefill(params, cfg, dict(zip(keys, got)),
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


def make_paged_verify_fn(cfg: ModelConfig, device):
    """The speculative verify step over the family's `paged_verify`
    hook: ONE ragged paged-prefill walk judges a k-token draft window
    per slot.

    verify(params, chunk, arena, block_table, start (b,), chunk_len (b,),
           draft (b, k), sampling) -> (arena, target (b, k+1), accept (b,))

    `chunk` is {"tokens": (b, k+1)}: row i's candidates [last_emitted,
    draft_0..draft_{k-1}] written at positions start[i]..start[i]+k
    (chunk_len k+1 active, 0 inert).  The tables, the draft and the
    window's sampling knobs (`expand_state`) cross in one transfer;
    `target` and `accept` come back as int32 device tensors
    (`sampling.verify_tokens`) and the logits never leave the step."""
    fam = registry.get_family(cfg)
    if not registry.has_verify(cfg):
        raise ValueError(f"family {cfg.family!r} has no speculative-verify "
                         f"path")
    device = torch.device(device)

    @torch.inference_mode()
    def verify(params, chunk, arena, block_table, start, chunk_len, draft,
               sampling: SamplingState):
        r = np.shape(chunk["tokens"])[1]
        tokens, bt, st, cl, dr, *knobs = to_device(
            device, chunk["tokens"], block_table, start, chunk_len, draft,
            *host_knobs(expand_state(sampling, r)))
        arena, logits = fam.paged_verify(params, cfg, {"tokens": tokens},
                                         arena, bt, st, cl)
        target, accept = verify_tokens(logits, dr, sampling,
                                       device_knobs(knobs))
        return arena, target, accept

    return verify


# one probe geometry shared by the step-structure checks and the
# serve_throughput --json gate (prefill_chunk != max_pages keeps the
# query tile shape from colliding with the decode-partials shape)
HLO_PROBE_GEOM = dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=4)


def bulk_attn_shapes(cfg: ModelConfig, *, max_batch: int, max_seq: int,
                     page_size: int, **_ignored) -> list[str]:
    """HLO result-type strings of the bulk attention buffers the paged
    kernels must never materialize: the gathered contiguous KV copy (its
    (b, mp, page, hkv, hd) gather form and the flat (b, mp*page, hkv, hd)
    view) and the (b, hkv, mp, group, hd) f32 per-page decode partials
    of the reference's pre-fusion two-pass kernel; the reference's f32
    strings, and where the arena holds another dtype (bf16, int8, fp8)
    the gathered forms in that dtype too."""
    mp = max_seq // page_size
    hkv, g, hd = cfg.num_kv_heads, cfg.group_size, cfg.head_dim
    out = [f"f32[{max_batch},{mp},{page_size},{hkv},{hd}]",
           f"f32[{max_batch},{max_seq},{hkv},{hd}]",
           f"f32[{max_batch},{hkv},{mp},{g},{hd}]"]
    kv = T.dtype_name(cfg.kv_store_dtype)
    if kv != "f32":
        out += [f"{kv}[{max_batch},{mp},{page_size},{hkv},{hd}]",
                f"{kv}[{max_batch},{max_seq},{hkv},{hd}]"]
    return out


def lowered_paged_hlo(cfg: ModelConfig, which: str = "decode", *,
                      max_batch: int = 2, max_seq: int = 64,
                      page_size: int = 8, prefill_chunk: int = 8,
                      params=None, sampling: SamplingState | None = None,
                      device=None) -> T.Trace:
    """The Trace (`launch/trace.py`) of one call of the paged serving
    step (`which` in {"decode", "prefill"}) made by
    `make_paged_serve_fns` on a fresh arena, on `device` (the card
    unless "cpu" is named; without a card it raises).

    The structure checks read it, as the reference's read its compiled
    HLO: on the card the kernels walk the table, so no
    `bulk_attn_shapes` buffer exists and each kernel launch is in
    `Trace.kernels` with its output; the plain route (the CPU) gathers
    the K/V.  The traced call is the second: a first call grows the
    split scratch of the bf16 decode kernel (`paged_attention/ops.py`
    `_scratch`) to the size every later call reuses.  `Trace.output` is
    (arena, tokens): only the (b,) int32 tokens leave the step, and
    `Trace.transfers` shows what crossed between the host and the
    card."""
    device = resolve_device(device)
    fam = registry.get_family(cfg)
    num_pages = max_batch * max_seq // page_size
    arena = fam.init_paged_cache(cfg, num_pages + 1, page_size, max_batch,
                                 device=device)
    return trace_second_call(
        cfg, which, make_paged_serve_fns(cfg, device), arena, device,
        params=params, sampling=sampling, max_batch=max_batch,
        max_seq=max_seq, page_size=page_size, prefill_chunk=prefill_chunk)


def trace_second_call(cfg: ModelConfig, which: str, fns, arena, device, *,
                      params, sampling, max_batch: int, max_seq: int,
                      page_size: int, prefill_chunk: int) -> T.Trace:
    """The Trace of the second call of one paged step (`which`: "decode"
    or "prefill" of `fns`, a (prefill, decode) pair) on `arena` with an
    empty table and zero positions, after a first, untraced call; seeded
    weights when `params` is None, greedy rows when `sampling` is."""
    if params is None:
        params = registry.get_family(cfg).init(0, cfg, device)
    if sampling is None:
        sampling = greedy_state(max_batch)
    bt = np.zeros((max_batch, max_seq // page_size), np.int32)
    zeros_b = np.zeros((max_batch,), np.int32)
    prefill_fn, decode_fn = fns
    if which == "decode":
        def call():
            return decode_fn(params, arena, bt, zeros_b, zeros_b, sampling)
    elif which == "prefill":
        chunk = {"tokens": np.zeros((max_batch, prefill_chunk), np.int32)}
        if cfg.frontend == "patch":
            chunk["patches"] = np.zeros(
                (max_batch, prefill_chunk, cfg.frontend_dim), np.float32)

        def call():
            return prefill_fn(params, chunk, arena, bt, zeros_b, zeros_b,
                              sampling)
    else:
        raise ValueError(which)
    call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _, tr = T.trace_call(call)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tr
