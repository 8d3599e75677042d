"""Beyond-paper: contiguous vs UniMem-paged serving, measured end-to-end.

Port of the reference's `benchmarks/serve_throughput.py`.  Runs the
SAME request stream through both engine layouts and reports tokens/s
plus peak KV bytes — for a dense batch/seq sweep AND a `--family` sweep
over the paged-native model zoo (dense, moe, hybrid, vlm; vlm requests
carry patch embeddings, hybrid pages its attention KV share while
conv/SSM state stays contiguous per slot).  The paper's claim,
serving-shaped: a single pooled page arena makes KV memory proportional
to tokens in flight while the contiguous layout pins `max_batch *
max_seq` regardless of load.  PASS requires (a) both layouts emit
identical greedy tokens on every row and (b) paged peak KV bytes never
exceed contiguous (wall-clock is reported, not judged).

On a CUDA device the engines run the hand-written kernels (paged decode
and prefill on the arena, split-KV decode and flash attention on the
contiguous cache); on the CPU their plain versions.  `--impl
flash_pallas` keeps its CPU meaning (the contiguous attention takes the
kernels' plain versions, `models/layers.py`); the card launches the
kernels whatever the impl.  `--ppb` stays a config field the CUDA
kernels do not read.  `--sampling` adds the IN-STEP sampling sweep (the
same dense stream rerun with per-request temperature + top-p + seeds,
gated on seed-replay determinism and on diverging from greedy).
`--kv-dtype int8|fp8` stores the paged side QUANTIZED; `--quant` adds
the capacity sweep gating the int8 arena at <= 0.55x bf16 page bytes
with identical greedy tokens, and `--host-tier` the forced-watermark
spill smoke (gated on nonzero spill+restore traffic and token identity
with an all-HBM run).  `--prefix-trace` adds the SHARED SYSTEM PROMPT
trace through the persistent prefix store (gated on cross-request hits,
fewer prompt tokens computed, steady-state TTFT below the cold run, and
identical greedy tokens).  `--speculate K [--draft SPEC]` adds the
SPECULATIVE DECODE sweep (byte-identical streams, greedy AND sampled,
at tokens/s ratio > 1).  `--json PATH` writes the record (`"schema":
6`) with the reference's attention statistics (`attention_hlo`, its
keys): the bulk attention bytes of the paged steps, read from traces
of the serving closures (`serve_step.lowered_paged_hlo`), "before" on
the plain route (the step on the CPU, where every wrapper takes its
plain version and gathers the K/V) and "after" on the kernel route (the
card); without a card "after" is None and the record says why.
`--shards N` serves the paged side (and every sweep)
from the near-memory SHARDED arena (`serve/sharded/`): N banks, on the
run's device when it is the CPU, else round-robin over the visible
cards; `shard_topology` reports the shards, the axis and each bank's
device, and each row the per-bank peak pages and bytes.

`run` keeps the reference's arguments and adds `device` (CUDA unless
"cpu" is given) and `params_for`, a `cfg -> params` hook (default: the
port's seeded `init(0, cfg, device)`, drawn on the device).

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_throughput \\
        [--family dense,moe,hybrid,vlm] [--impl flash_pallas] \\
        [--sampling] [--kv-dtype int8] [--quant] [--host-tier] \\
        [--prefix-trace] [--speculate 4] [--draft self:1] \\
        [--json BENCH_serve.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models import registry
from repro_torch.serve import (ServingEngine, Request, SamplingParams,
                               TokenEvent)
from repro_torch.utils.device import resolve_device

# machine-readable result schema, the reference's (6: tokens/s, peak KV
# bytes per tier, kv_dtype, shard topology, the sampling sweep, the
# quantized-arena and host-tier sweeps, the prefix trace, the
# speculative sweep)
SCHEMA = 6

CFG = ModelConfig(
    name="bench-dense", family="dense", num_layers=2, d_model=64,
    vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    attn_chunk=32, max_seq=256)

# quantized-arena sweep point: head_dim 64 so the int8 payload
# amortizes the f32 per-token-per-head scale column — the page-bytes
# ratio is (hd + 4) / (2 hd) = 0.53 at hd=64 (0.625 at hd=16, which
# would never clear the 0.55 gate)
QUANT_CFG = ModelConfig(
    name="bench-quant", family="dense", num_layers=2, d_model=128,
    vocab_size=128, num_heads=2, num_kv_heads=1, head_dim=64, d_ff=128,
    attn_chunk=32, max_seq=256)

FAMILY_CFGS = {
    "dense": CFG,
    "moe": ModelConfig(
        name="bench-moe", family="moe", num_layers=2, d_model=64,
        vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16,
        num_experts=4, experts_per_token=2, moe_d_ff=32,
        num_shared_experts=1, attn_chunk=32, max_seq=256),
    "hybrid": ModelConfig(
        name="bench-hybrid", family="hybrid", num_layers=4, d_model=64,
        vocab_size=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128,
        ssm_state=16, ssm_head_dim=32, ssm_chunk=16, shared_attn_period=2,
        num_shared_blocks=2, attn_chunk=32, max_seq=256),
    "vlm": ModelConfig(
        name="bench-vlm", family="vlm", num_layers=2, d_model=64,
        vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        frontend="patch", frontend_dim=32, num_patches=8,
        attn_chunk=32, max_seq=256),
}

# dense-only scaling sweep: (max_batch, max_seq, requests, prompt_hi, max_new)
SWEEP = [
    (2, 64, 6, 20, 6),
    (4, 128, 8, 48, 8),
    (4, 256, 8, 96, 8),
]

# family sweep point (tiny: CI smoke runs this on CPU)
FAM_POINT = dict(mb=2, ms=64, n=4, phi=24, mnew=5)


def _params_for(params_for, device):
    """The `cfg -> params` hook: the given one, or the port's seeded init
    on `device`."""
    if params_for is not None:
        return params_for
    return lambda cfg: registry.get_family(cfg).init(0, cfg, device)


def _stream(rng, cfg, n, prompt_hi, max_new):
    reqs = []
    for i in range(n):
        pe = (rng.standard_normal((cfg.num_patches, cfg.frontend_dim))
              .astype(np.float32) if cfg.frontend == "patch" else None)
        reqs.append(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                int(rng.integers(4, prompt_hi))
                                ).astype(np.int32),
            max_new_tokens=max_new, patch_embeds=pe))
    return reqs


def _run(cfg, params, layout, reqs, mb, ms, device=None, mesh=None,
         **eng_kw):
    eng = ServingEngine(cfg, params, device=device, max_batch=mb,
                        max_seq=ms, page_size=16, layout=layout,
                        mesh=mesh if layout == "paged" else None, **eng_kw)
    for r in reqs:
        eng.submit(Request(uid=r.uid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens,
                           patch_embeds=r.patch_embeds))
    t0 = time.perf_counter()
    results = eng.run()
    dt = time.perf_counter() - t0
    toks = {r.uid: tuple(r.tokens) for r in results}
    out = dict(tok_s=sum(len(t) for t in toks.values()) / dt,
               peak_kv_bytes=eng.peak_kv_bytes(), tokens=toks,
               shared=eng.pool.stats().shared_pages,
               prefill_shapes=len(eng.prefill_shapes))
    if eng.mesh is not None:
        out["per_shard_peak_pages"] = [
            s["peak_allocated_pages"] for s in eng.pool.shard_stats()]
        out["per_shard_kv_bytes"] = eng.arena.shard_kv_bytes()
    if eng.host_tier is not None:
        out["host_tier"] = eng.stats()["host_tier"]
    return out


def _row(cfg, params, reqs, mb, ms, oracle_cfg=None, device=None,
         mesh=None):
    """paged side runs `cfg` (possibly --impl/--kv-dtype/--shards
    overridden); the contiguous reference stays on `oracle_cfg`, one
    arena, so the parity gate is paged-vs-oracle."""
    contig = _run(oracle_cfg or cfg, params, "contiguous", reqs, mb, ms,
                  device)
    paged = _run(cfg, params, "paged", reqs, mb, ms, device, mesh)
    same = contig["tokens"] == paged["tokens"]
    row = dict(
        family=cfg.family, batch=mb, max_seq=ms, requests=len(reqs),
        contig_tok_s=contig["tok_s"], paged_tok_s=paged["tok_s"],
        contig_kv_mb=contig["peak_kv_bytes"] / 1e6,
        paged_kv_mb=paged["peak_kv_bytes"] / 1e6,
        kv_ratio=paged["peak_kv_bytes"] / contig["peak_kv_bytes"],
        prefill_shapes=paged["prefill_shapes"],
        tokens_match=same,
        ok=same and paged["peak_kv_bytes"] <= contig["peak_kv_bytes"],
    )
    if mesh is not None:
        row["per_shard_peak_pages"] = paged["per_shard_peak_pages"]
        row["per_shard_kv_bytes"] = paged["per_shard_kv_bytes"]
    return row


def _attention_hlo_stats(cfg, device) -> dict:
    """The attention traffic of the paged steps, before (the plain
    route: per-layer gathered K/V copies) vs after (the kernel route:
    the block-table walk in the kernel).  Bytes come from
    `launch/trace.py` shape accounting over the ACTUAL serving closures
    (`serve_step.lowered_paged_hlo` at `HLO_PROBE_GEOM`); the bulk keys
    are the buffers the kernels exist to kill.  "before" runs on the
    CPU, where every wrapper takes its plain version; "after" needs the
    card (None without one: never a copy of "before")."""
    from repro_torch.serve.serve_step import (HLO_PROBE_GEOM,
                                              bulk_attn_shapes,
                                              lowered_paged_hlo)

    bulk_shapes = bulk_attn_shapes(cfg, **HLO_PROBE_GEOM)
    on_card = device.type == "cuda"
    out = {"bulk_attn_shapes": bulk_shapes,
           "backend": device.type,
           "before_device": "cpu",
           "after_device": str(device) if on_card else None,
           # eager traffic: every op that is not a view reads its
           # operands and writes its result; a kernel counts what it
           # reports
           "hbm_bytes_note": ("whole-step totals are eager-traffic "
                              "proxies from the trace; only the "
                              "bulk_attn_bytes_* keys compare before/"
                              "after meaningfully")}
    if not on_card:
        out["after"] = ("needs a CUDA card: the kernel route runs only "
                        "there")
    routes = [("before", torch.device("cpu"))]
    if on_card:
        routes.append(("after", device))
    for tag, dev in routes:
        params = registry.get_family(cfg).init(0, cfg, dev)
        for which in ("decode", "prefill"):
            s = lowered_paged_hlo(cfg, which, params=params, device=dev,
                                  **HLO_PROBE_GEOM).summary()
            bulk = sum(s.bytes_by_shape.get(k, 0.0) for k in bulk_shapes)
            out[f"{which}_bulk_attn_bytes_{tag}"] = bulk
            out[f"{which}_hbm_bytes_{tag}"] = s.hbm_bytes
    if not on_card:
        for which in ("decode", "prefill"):
            out[f"{which}_bulk_attn_bytes_after"] = None
            out[f"{which}_hbm_bytes_after"] = None
    return out


def _sampling_sweep(cfg, params, device=None, mesh=None) -> dict:
    """Greedy vs per-request-sampled serving on the SAME stream.

    Every request carries its own SamplingParams (temperature ramp,
    top-p nucleus, top-k on odd uids, per-request seed) drawn inside
    the step.  PASS requires (a) a seed replay reproduces the sampled
    tokens byte-for-byte and (b) the sampled run diverges from greedy
    somewhere.  Reported tokens/s tracks the in-step sampling overhead."""
    mb, ms, mnew = 4, 128, 8
    rng = np.random.default_rng(12345)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 48)))
               .astype(np.int32) for _ in range(8)]

    def params_for(uid):
        return SamplingParams(temperature=0.7 + 0.05 * uid,
                              top_k=8 if uid % 2 else 0, top_p=0.9,
                              seed=uid, max_new_tokens=mnew)

    def serve(sampled):
        eng = ServingEngine(cfg, params, device=device, max_batch=mb,
                            max_seq=ms, page_size=16, mesh=mesh)
        for uid, p in enumerate(prompts):
            eng.submit(Request(
                uid=uid, prompt=p.copy(),
                sampling=params_for(uid) if sampled
                else SamplingParams(max_new_tokens=mnew)))
        t0 = time.perf_counter()
        toks = {r.uid: tuple(r.tokens) for r in eng.run()}
        dt = time.perf_counter() - t0
        return toks, sum(len(t) for t in toks.values()) / dt

    greedy, greedy_tok_s = serve(sampled=False)
    sampled, sampled_tok_s = serve(sampled=True)
    replay, _ = serve(sampled=True)
    deterministic = sampled == replay
    diverged = sampled != greedy
    return dict(mode="per-request temperature + top-p (+ top-k odd uids)",
                requests=len(prompts),
                greedy_tok_s=greedy_tok_s, sampled_tok_s=sampled_tok_s,
                sampled_over_greedy=sampled_tok_s / greedy_tok_s,
                deterministic=deterministic, diverged_from_greedy=diverged,
                ok=deterministic and diverged)


def _quant_sweep(impl=None, ppb=1, device=None, params_for=None,
                 mesh=None) -> dict:
    """int8 page arena vs bf16 on the SAME greedy stream: the int8
    payload + f32 scale column must hold the paged KV high-water to
    <= 0.55x the bf16 arena's AND the greedy tokens must stay
    identical."""
    mb, ms, n, phi, mnew = 4, 128, 8, 48, 8
    params_for = _params_for(params_for, device)
    base = QUANT_CFG
    if impl:
        base = base.replace(attention_impl=impl)
    base = base.replace(attn_pages_per_block=ppb)
    rng = np.random.default_rng(777)
    reqs = _stream(rng, base, n, phi, mnew)
    runs = {}
    for tag in ("bf16", "int8"):
        # pin the baseline to bf16 STORAGE explicitly — the default
        # arena stores the compute dtype (f32 here), which would
        # overstate the int8 win
        cfg = base.replace(kv_dtype=tag)
        runs[tag] = _run(cfg, params_for(cfg), "paged", reqs, mb, ms, device,
                         mesh)
    ratio = runs["int8"]["peak_kv_bytes"] / runs["bf16"]["peak_kv_bytes"]
    same = runs["bf16"]["tokens"] == runs["int8"]["tokens"]
    return dict(head_dim=base.head_dim, requests=n,
                bf16_kv_mb=runs["bf16"]["peak_kv_bytes"] / 1e6,
                int8_kv_mb=runs["int8"]["peak_kv_bytes"] / 1e6,
                bytes_ratio=ratio,
                bf16_tok_s=runs["bf16"]["tok_s"],
                int8_tok_s=runs["int8"]["tok_s"],
                tokens_match=same,
                ok=same and ratio <= 0.55)


def _tier_sweep(device=None, params_for=None, mesh=None) -> dict:
    """Forced-watermark host-tier smoke: a pool deliberately sized PAST
    by the workload, with the host-DRAM tier behind it.  The shedder
    preempts under the high watermark, preempted slots SPILL to host,
    readmissions RESTORE (through the prefetch) — and the stream must
    finish with tokens identical to an all-HBM run.  PASS requires
    nonzero spill AND restore traffic plus token identity."""
    mb, ms, n, phi, mnew = 4, 128, 8, 48, 10
    rng = np.random.default_rng(4242)
    reqs = _stream(rng, CFG, n, phi, mnew)
    params = _params_for(params_for, device)(CFG)
    base = _run(CFG, params, "paged", reqs, mb, ms, device, mesh,
                pool_pages=64)
    # limit = 0.5 * 16 = 8 pages vs ~4 pages per active sequence: the
    # shedder MUST preempt, so the tier MUST see spill traffic
    tiered = _run(CFG, params, "paged", reqs, mb, ms, device, mesh,
                  pool_pages=16, high_watermark=0.5, host_tier_pages=64)
    ht = tiered["host_tier"]
    same = base["tokens"] == tiered["tokens"]
    spilled = ht["spills"] > 0 and ht["restores"] > 0
    return dict(requests=n, pool_pages=16, high_watermark=0.5,
                host_tier_pages=64,
                all_hbm_kv_mb=base["peak_kv_bytes"] / 1e6,
                tiered_hbm_kv_mb=tiered["peak_kv_bytes"] / 1e6,
                host_tier_peak_mb=ht["peak_bytes"] / 1e6,
                spills=ht["spills"], spilled_pages=ht["spilled_pages"],
                prefetches=ht["prefetches"], restores=ht["restores"],
                restored_pages=ht["restored_pages"],
                evictions=ht["evictions"],
                all_hbm_tok_s=base["tok_s"], tiered_tok_s=tiered["tok_s"],
                tokens_match=same,
                ok=same and spilled)


def _prefix_sweep(device=None, params_for=None, mesh=None) -> dict:
    """--prefix-trace: N requests sharing one SYSTEM PROMPT, served
    strictly sequentially — every donor retires before the next request
    arrives, so any page reuse crosses request lifetimes through the
    persistent prefix store.

    The cached run must (a) hit — nonzero cross-request store hits and
    strictly fewer prompt tokens computed than the cold run, (b) stay
    byte-identical to the cold run, and (c) beat the cold run on
    steady-state TTFT (median over requests >= 2)."""
    n, sys_len, tail_len, mnew = 8, 96, 8, 6
    rng = np.random.default_rng(909)
    system = rng.integers(0, CFG.vocab_size, sys_len).astype(np.int32)
    prompts = [np.concatenate(
        [system, rng.integers(0, CFG.vocab_size, tail_len).astype(np.int32)])
        for _ in range(n)]
    params = _params_for(params_for, device)(CFG)

    def serve(cached):
        eng = ServingEngine(CFG, params, device=device, max_batch=2,
                            max_seq=256, page_size=16, prefill_chunk=16,
                            pool_pages=64, prefix_cache=cached, mesh=mesh)
        ttft = {}
        for uid, p in enumerate(prompts):
            t0 = time.perf_counter()
            eng.submit(Request(uid=uid, prompt=p.copy(),
                               max_new_tokens=mnew))
            for ev in eng.stream():     # runs this request to retirement
                if (isinstance(ev, TokenEvent) and ev.uid == uid
                        and ev.index == 0):
                    ttft[uid] = time.perf_counter() - t0
        toks = {r.uid: tuple(r.tokens) for r in eng.results}
        steady = float(np.median([ttft[u] for u in range(2, n)]))
        return dict(tokens=toks, ttft=ttft, steady_ttft_s=steady,
                    prefill_tokens=eng.prefill_tokens,
                    store=eng.prefix_store.stats())

    cold = serve(cached=False)
    warm = serve(cached=True)
    st = warm["store"]
    hit_rate = st["reused_pages"] / max(1, st["reused_pages"]
                                        + st["registered_pages"])
    same = cold["tokens"] == warm["tokens"]
    faster = warm["steady_ttft_s"] < cold["steady_ttft_s"]
    return dict(requests=n, system_tokens=sys_len, page_size=16,
                prefill_chunk=16,
                cross_request_hits=st["cross_request_hits"],
                pages_reused=st["reused_pages"],
                pages_prefilled=st["registered_pages"],
                prefix_hit_rate=hit_rate,
                prefill_tokens_cached=warm["prefill_tokens"],
                prefill_tokens_cold=cold["prefill_tokens"],
                steady_ttft_cached_s=warm["steady_ttft_s"],
                steady_ttft_cold_s=cold["steady_ttft_s"],
                ttft_speedup=cold["steady_ttft_s"] / warm["steady_ttft_s"],
                tokens_match=same,
                ok=(same and faster and st["cross_request_hits"] > 0
                    and warm["prefill_tokens"] < cold["prefill_tokens"]))


def _high_agreement(params):
    """Zero the residual output projections of every layer past the
    first, making layers 1..L-1 exact identities on the residual
    stream.  A `self:1` draft (layer 0 + the shared final norm/head)
    then computes logits IDENTICAL to the target's, so the accept rate
    is exactly 1.0 — the trace measures the speculation MACHINERY's
    ceiling rather than a random-init draft's agreement.  The port's
    layers are a list of per-layer dicts; the input is not modified."""
    layers = [dict(p) for p in params["layers"]]
    for p in layers[1:]:
        for mod in ("attn", "mlp"):
            p[mod] = {**p[mod], "wo": torch.zeros_like(p[mod]["wo"])}
    return {**params, "layers": layers}


def _speculate_sweep(k: int, draft: str, device=None,
                     params_for=None, mesh=None) -> dict:
    """--speculate K: draft-propose / batched-verify decode vs plain
    one-token decode on the SAME decode-heavy stream.

    Acceptance is an exact match against the target's own counter-keyed
    draw, so the speculative stream must be BYTE-IDENTICAL to plain
    decode — greedy and sampled — and the gate enforces exactly that,
    plus a tokens/s ratio > 1.  The target is CFG deepened to 8 layers
    with `_high_agreement` params (accept rate 1.0, draft = 1/8 of the
    target)."""
    mb, ms, n, phi, mnew = 4, 256, 8, 16, 64
    cfg = dataclasses.replace(CFG, num_layers=8)
    rng = np.random.default_rng(31337)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, phi)))
               .astype(np.int32) for _ in range(n)]
    params = _high_agreement(_params_for(params_for, device)(cfg))

    def serve(spec_k, sampled):
        # ONE engine per mode, warmup batch first: the timed batch
        # reuses the warm engine (requests are independent streams;
        # warmup never changes the timed tokens)
        eng = ServingEngine(cfg, params, device=device, max_batch=mb,
                            max_seq=ms, page_size=16, speculate_k=spec_k,
                            draft=draft if spec_k else None, mesh=mesh)

        def batch(base_uid):
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid=base_uid + uid, prompt=p.copy(),
                                   sampling=SamplingParams(
                                       temperature=0.7 if sampled and uid % 2
                                       else 0.0, seed=uid,
                                       max_new_tokens=mnew)))
            t0 = time.perf_counter()
            results = eng.run()                  # accumulates across batches
            dt = time.perf_counter() - t0
            return {r.uid - base_uid: tuple(r.tokens) for r in results
                    if r.uid >= base_uid}, dt

        batch(0)                                 # warmup
        toks, dt = batch(1000)
        return (toks, sum(len(t) for t in toks.values()) / dt,
                eng.stats().get("speculative"))

    plain, plain_tok_s, _ = serve(0, sampled=False)
    spec, spec_tok_s, st = serve(k, sampled=False)
    plain_s, _, _ = serve(0, sampled=True)
    spec_s, _, _ = serve(k, sampled=True)
    ratio = spec_tok_s / plain_tok_s
    same = plain == spec
    same_sampled = plain_s == spec_s
    return dict(k=k, draft=draft, requests=n, max_new_tokens=mnew,
                plain_tok_s=plain_tok_s, speculative_tok_s=spec_tok_s,
                speedup=ratio,
                accept_rate=st["accept_rate"],
                windows=st["windows"], verify_calls=st["verify_calls"],
                draft_tokens=st["draft_tokens"],
                accepted_tokens=st["accepted_tokens"],
                emitted_tokens=st["emitted_tokens"],
                tokens_match=same, tokens_match_sampled=same_sampled,
                # the ratio gate is one arena's only: on a mesh the run
                # is a byte-identity check of the sharded verify path
                # (propose, verify, rollback), not a speed claim
                ok=same and same_sampled
                and (mesh is not None or ratio > 1.0))


def run(families=None, impl=None, ppb=1, attn_hlo=False,
        shards: int = 1, sampling: bool = False, kv_dtype: str | None = None,
        quant: bool = False, host_tier: bool = False,
        prefix_trace: bool = False, speculate: int = 0,
        draft: str = "self:1", device=None, params_for=None) -> dict:
    device = resolve_device(device)
    mesh = None
    if shards > 1:
        from repro_torch.launch.mesh import make_mem_mesh
        mesh = make_mem_mesh(shards, devices=None if device.type == "cuda"
                             else [device])
    params_for = _params_for(params_for, device)
    families = families or list(FAMILY_CFGS)

    def cfg_of(fam):
        cfg = FAMILY_CFGS[fam]
        if impl:
            cfg = cfg.replace(attention_impl=impl)
        if kv_dtype:
            # paged side only — the contiguous oracle keeps the default
            # cache dtype, so a quantized run is gated quant-vs-oracle
            cfg = cfg.replace(kv_dtype=kv_dtype)
        return cfg.replace(attn_pages_per_block=ppb)

    rows, ok = [], True
    # dense batch/seq scaling sweep (covers the dense family point too)
    if "dense" in families:
        cfg = cfg_of("dense")
        params = params_for(cfg)
        for mb, ms, n, phi, mnew in SWEEP:
            rng = np.random.default_rng(hash((mb, ms)) % 2**32)
            r = _row(cfg, params, _stream(rng, cfg, n, phi, mnew), mb, ms,
                     oracle_cfg=FAMILY_CFGS["dense"], device=device,
                     mesh=mesh)
            ok &= r["ok"]
            rows.append(r)
    # family sweep: the rest of the zoo paged-native at one tiny point
    for fam in families:
        if fam == "dense":
            continue
        cfg = cfg_of(fam)
        params = params_for(cfg)
        rng = np.random.default_rng(1000 + sum(map(ord, fam)))
        p = FAM_POINT
        r = _row(cfg, params, _stream(rng, cfg, p["n"], p["phi"], p["mnew"]),
                 p["mb"], p["ms"], oracle_cfg=FAMILY_CFGS[fam], device=device,
                 mesh=mesh)
        ok &= r["ok"]
        rows.append(r)
    result = {"name": "serve_throughput", "schema": SCHEMA, "ok": ok,
              "rows": rows,
              "attention_impl": impl or CFG.attention_impl,
              "pages_per_block": ppb,
              "kv_dtype": kv_dtype or "bf16",
              "shard_topology": {"shards": shards,
                                 "mesh_axis": "mem" if mesh is not None
                                 else None,
                                 "devices": (torch.cuda.device_count()
                                             if device.type == "cuda"
                                             else 1),
                                 "bank_devices": ([str(d) for d in
                                                   mesh.devices]
                                                  if mesh is not None
                                                  else None),
                                 "backend": device.type}}
    if quant:
        result["quant"] = _quant_sweep(impl=impl, ppb=ppb, device=device,
                                       params_for=params_for, mesh=mesh)
        ok = ok and result["quant"]["ok"]
        result["ok"] = ok
    if host_tier:
        result["host_tier"] = _tier_sweep(device, params_for, mesh)
        ok = ok and result["host_tier"]["ok"]
        result["ok"] = ok
    if prefix_trace:
        result["prefix"] = _prefix_sweep(device, params_for, mesh)
        ok = ok and result["prefix"]["ok"]
        result["ok"] = ok
    if sampling:
        cfg = cfg_of("dense")
        result["sampling"] = _sampling_sweep(cfg, params_for(cfg), device,
                                             mesh)
        result["ok"] = ok = ok and result["sampling"]["ok"]
    if speculate > 0:
        result["speculative"] = _speculate_sweep(speculate, draft, device,
                                                 params_for, mesh)
        result["ok"] = ok = ok and result["speculative"]["ok"]
    if attn_hlo:
        result["attention_hlo"] = h = attention_hlo(device)
        result["ok"] = ok and h["ok"]
    return result


def attention_hlo(device) -> dict:
    """`_attention_hlo_stats` of the dense config, with its verdict
    "ok": the plain route shows the gather (the check is not empty) and,
    on the card, the kernel route ships ZERO bulk attention bytes."""
    h = _attention_hlo_stats(FAMILY_CFGS["dense"], device)
    ok = (h["decode_bulk_attn_bytes_before"] > 0
          and h["prefill_bulk_attn_bytes_before"] > 0)
    if device.type == "cuda":
        ok = (ok and h["decode_bulk_attn_bytes_after"] == 0
              and h["prefill_bulk_attn_bytes_after"] == 0)
    h["ok"] = ok
    return h


def pretty(result: dict):
    print("== Serving: contiguous slots vs UniMem paged arena "
          "(--family sweep: dense,moe,hybrid,vlm) ==")
    topo = result["shard_topology"]
    print(f"   attention_impl={result['attention_impl']} "
          f"pages_per_block={result['pages_per_block']} "
          f"kv_dtype={result['kv_dtype']} "
          f"shards={topo['shards']} ({topo['devices']} "
          f"{topo['backend']} devices)")
    print(f"{'family':>8}{'batch':>6}{'max_seq':>8}{'reqs':>6}"
          f"{'contig tok/s':>14}{'paged tok/s':>13}{'contig KV MB':>14}"
          f"{'paged KV MB':>13}{'KV ratio':>10}  tokens")
    for r in result["rows"]:
        print(f"{r['family']:>8}{r['batch']:>6}{r['max_seq']:>8}"
              f"{r['requests']:>6}"
              f"{r['contig_tok_s']:>14.1f}{r['paged_tok_s']:>13.1f}"
              f"{r['contig_kv_mb']:>14.3f}{r['paged_kv_mb']:>13.3f}"
              f"{r['kv_ratio']:>10.2f}  "
              f"{'==' if r['tokens_match'] else 'DIFFER'}")
    q = result.get("quant")
    if q:
        print(f"   quantized arena (head_dim {q['head_dim']}): bf16 "
              f"{q['bf16_kv_mb']:.3f} MB -> int8 {q['int8_kv_mb']:.3f} MB "
              f"({q['bytes_ratio']:.3f}x, gate <= 0.55); tokens "
              f"{'==' if q['tokens_match'] else 'DIFFER'}")
    p = result.get("prefix")
    if p:
        print(f"   prefix cache ({p['requests']} sequential requests, "
              f"{p['system_tokens']}-token shared system prompt): "
              f"hit rate {p['prefix_hit_rate']:.2f} "
              f"({p['pages_reused']} pages reused / "
              f"{p['pages_prefilled']} prefilled, "
              f"{p['cross_request_hits']} cross-request hits); prompt "
              f"tokens computed {p['prefill_tokens_cached']} vs cold "
              f"{p['prefill_tokens_cold']}; steady TTFT "
              f"{p['steady_ttft_cached_s']*1e3:.1f} ms vs cold "
              f"{p['steady_ttft_cold_s']*1e3:.1f} ms "
              f"({p['ttft_speedup']:.2f}x); tokens "
              f"{'==' if p['tokens_match'] else 'DIFFER'}")
    t = result.get("host_tier")
    if t:
        print(f"   host tier (pool {t['pool_pages']} pages @ watermark "
              f"{t['high_watermark']}): HBM {t['tiered_hbm_kv_mb']:.3f} MB "
              f"(all-HBM run {t['all_hbm_kv_mb']:.3f} MB), host peak "
              f"{t['host_tier_peak_mb']:.3f} MB; {t['spills']} spills / "
              f"{t['prefetches']} prefetches / {t['restores']} restores; "
              f"tokens {'==' if t['tokens_match'] else 'DIFFER'}")
    sp = result.get("speculative")
    if sp:
        print(f"   speculative decode (k={sp['k']}, draft {sp['draft']}): "
              f"plain {sp['plain_tok_s']:.1f} tok/s -> speculative "
              f"{sp['speculative_tok_s']:.1f} tok/s ({sp['speedup']:.2f}x); "
              f"accept rate {sp['accept_rate']:.2f} "
              f"({sp['accepted_tokens']}/{sp['draft_tokens']} draft tokens, "
              f"{sp['verify_calls']} verify calls); tokens "
              f"{'==' if sp['tokens_match'] else 'DIFFER'} greedy, "
              f"{'==' if sp['tokens_match_sampled'] else 'DIFFER'} sampled")
    s = result.get("sampling")
    if s:
        print(f"   in-step sampling [{s['mode']}]: greedy "
              f"{s['greedy_tok_s']:.1f} tok/s -> sampled "
              f"{s['sampled_tok_s']:.1f} tok/s "
              f"({s['sampled_over_greedy']:.2f}x); seed replay "
              f"{'identical' if s['deterministic'] else 'DIVERGED'}")
    h = result.get("attention_hlo")
    if h:
        def kb(x):
            return "needs a card" if x is None else f"{x/1e3:.0f}kB"
        print("   paged-step attention traffic (traced, dense): "
              f"decode bulk {kb(h['decode_bulk_attn_bytes_before'])}"
              f" -> {kb(h['decode_bulk_attn_bytes_after'])}, "
              f"prefill bulk {kb(h['prefill_bulk_attn_bytes_before'])}"
              f" -> {kb(h['prefill_bulk_attn_bytes_after'])}")
    print(f"-> {'PASS' if result['ok'] else 'FAIL'} "
          "(identical greedy tokens; paged KV high-water <= contiguous "
          "on every family)\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default=",".join(FAMILY_CFGS),
                    help="comma-separated subset of "
                         f"{','.join(FAMILY_CFGS)} to sweep")
    ap.add_argument("--impl", default=None,
                    choices=("dense", "flash_xla", "flash_pallas"),
                    help="attention_impl override (on the CPU, "
                         "flash_pallas takes the kernels' plain versions; "
                         "the card launches the kernels whatever the impl)")
    ap.add_argument("--ppb", type=int, default=1,
                    help="pages per paged-kernel grid cell "
                         "(attn_pages_per_block; a TPU grid knob the CUDA "
                         "kernels do not read)")
    ap.add_argument("--shards", type=int, default=1,
                    help="serve the paged side from the near-memory "
                         "sharded arena with N banks")
    ap.add_argument("--sampling", action="store_true",
                    help="add the in-step sampling sweep (per-request "
                         "temperature + top-p + seeds on the dense "
                         "stream; gated on seed-replay determinism)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("bf16", "int8", "fp8"),
                    help="page-arena storage dtype for the paged side of "
                         "the main sweep (the contiguous oracle keeps "
                         "the compute dtype)")
    ap.add_argument("--quant", action="store_true",
                    help="add the quantized-arena sweep: int8 vs bf16 "
                         "page bytes at head_dim 64, gated on ratio "
                         "<= 0.55 AND identical greedy tokens")
    ap.add_argument("--host-tier", action="store_true",
                    help="add the host-tier spill smoke: forced-"
                         "watermark pool with a host-DRAM tier, gated "
                         "on nonzero spill+restore traffic AND tokens "
                         "identical to an all-HBM run")
    ap.add_argument("--prefix-trace", action="store_true",
                    help="add the shared-system-prompt trace through the "
                         "persistent prefix store; gated on nonzero "
                         "cross-request hits, fewer prompt tokens "
                         "computed, steady-state TTFT below the cold "
                         "run, AND identical greedy tokens")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="add the speculative-decode sweep: K-token "
                         "draft windows + one-call batched verify vs "
                         "plain decode, gated on BYTE-IDENTICAL streams "
                         "(greedy and sampled) at tokens/s ratio > 1")
    ap.add_argument("--draft", default="self:1",
                    help="draft spec for --speculate: 'self:N' "
                         "(truncated-layer self-draft) or an arch "
                         "name, optionally '@reduced' (default self:1)")
    ap.add_argument("--json", nargs="?", const="BENCH_serve.json",
                    default=None, metavar="PATH",
                    help="write machine-readable results (schema 6, "
                         "with the paged steps' attention traffic "
                         "before/after the kernels, `attention_hlo`) "
                         "to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    fams = [f.strip() for f in args.family.split(",") if f.strip()]
    unknown = [f for f in fams if f not in FAMILY_CFGS]
    if unknown:
        raise SystemExit(f"unknown families {unknown}; "
                         f"choose from {list(FAMILY_CFGS)}")
    res = {"name": "serve_throughput", "schema": SCHEMA, "ok": False,
           "error": "run() raised before completing"}
    try:
        res = run(fams, impl=args.impl, ppb=args.ppb,
                  attn_hlo=bool(args.json), shards=args.shards,
                  sampling=args.sampling, kv_dtype=args.kv_dtype,
                  quant=args.quant, host_tier=args.host_tier,
                  prefix_trace=args.prefix_trace,
                  speculate=args.speculate, draft=args.draft,
                  device=args.device)
        pretty(res)
    finally:
        # write even when run() raises: the (partial) record is what a
        # failing run needs kept
        if args.json:
            with open(args.json, "w") as f:
                json.dump(res, f, indent=1, default=str)
            print(f"wrote {args.json}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
