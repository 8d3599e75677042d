"""Serving entry point: continuous batching on the UniMem arena (paged)
or on per-slot contiguous caches.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch internlm2-1.8b|yi-9b|deepseek-67b|nemotron-4-340b|\
               qwen3-moe-30b-a3b|moonshot-v1-16b-a3b|zamba2-2.7b|\
               mamba2-130m|phi-3-vision-4.2b \
        --requests 8 --max-new 32 [--layout paged|contiguous] \
        [--reduced] [--max-batch 4 --max-seq 128 --page-size 16] \
        [--prefill-chunk N] [--temperature T --top-k K --top-p P \
         --sample-seed S] [--kv-dtype int8|fp8|bf16] \
        [--speculate K [--draft self:N|mamba2-130m]] \
        [--prefix-cache [--shared-prefix N]] [--host-tier-pages N] \
        [--high-watermark F] [--shards N] [--device cpu] \
        [--port N [--host H] [--tenant-budget alpha:3,beta:1]]

Builds the model with seeded random weights on the device (CUDA unless
`--device` names another), submits a synthetic request stream with mixed
prompt lengths, runs the engine to completion and logs latency,
throughput and pool statistics.  Each request gets its own sampling
seed (base + uid), so reruns reproduce while requests decorrelate.
Every family with a paged path defaults to the paged layout; the
pure-SSM mamba2-130m serves from the contiguous one.  A vlm
(phi-3-vision-4.2b) request carries `num_patches` seeded image rows,
which count against `--max-seq`; the encoder-only hubert-xlarge has
nothing to serve and exits.
The MoE and hybrid archs serve with their shipped `moe_dispatch="ep"` /
`ssd_impl="xla"` (the einsum dispatch and the plain SSD); the
grouped-matmul and SSD kernels are reached by serving
`cfg.replace(moe_dispatch="grouped")` / `cfg.replace(ssd_impl="pallas")`
through `LLMServer`.  `--speculate K` decodes speculatively: the draft
(`--draft`, default "self:1") proposes K tokens per window and one
paged-prefill verify call judges them (paged layout, dense and MoE
targets; the tokens are plain decode's).  `--prefix-cache` keeps full
prompt pages after their request retires, so later requests that share
the prefix (`--shared-prefix N` puts the same N system-prompt tokens
ahead of every prompt) adopt them instead of prefilling;
`--host-tier-pages` puts a host-DRAM tier of that many pages behind the
pool (preempted sequences spill and restore, evicted cache pages spill
cold); `--high-watermark` preempts (after shedding idle cache pages)
above that fraction of the pool.  `--shards N` serves from the
near-memory SHARDED arena (`serve/sharded/`): one bank of pages per
shard, each bank walking its resident pages and the softmax summaries
merged on the lead device.  The banks go round-robin over the visible
cards (N banks on one card share it as separate allocations; one bank a
card where there are N), or all on `--device` when one is named
(`--device cpu --shards 4` for the CPU); the launch log and the stats'
"mesh" say where each bank lies.

`--port N` serves the network front instead of the synthetic batch loop
(`serve/frontend`: HTTP/1.1 + server-sent events on `--host`, port 0
picks a free one) until interrupted; clients connect with
`examples/serve_lm_torch.py --connect host:port`.  `--tenant-budget`
gives each named tenant its weight in the engine's weighted max-min
budget shares (unnamed tenants weigh 1; the front only).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import registry
from repro_torch.models.config import reduced_for_smoke
from repro_torch.serve.api import LLMServer
from repro_torch.serve.sampling import SamplingParams
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


def parse_tenant_budget(spec: str | None) -> dict[str, float] | None:
    """'alpha:3,beta:1' -> {'alpha': 3.0, 'beta': 1.0}; '' / None -> None.
    A bare name means weight 1.0."""
    if not spec:
        return None
    out: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            out[name.strip()] = float(w) if w else 1.0
        except ValueError:
            raise SystemExit(f"--tenant-budget: bad weight in {part!r}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--layout", default=None,
                    choices=["paged", "contiguous"],
                    help="KV layout (default: paged where the family has "
                         "a paged path, else contiguous)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens prefilled per engine step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k cutoff (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus mass (1.0 = off)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base sampling seed (request uid is added)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["bf16", "int8", "fp8"],
                    help="page-arena storage dtype: int8/fp8 quantize K/V "
                         "on write and dequantize inside the kernels")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decode: draft K tokens per window, "
                         "verify them in one batched paged-prefill call "
                         "(tokens stay plain decode's; paged layout only)")
    ap.add_argument("--draft", default="self:1",
                    help="draft model for --speculate: 'self:N' (first N "
                         "target layers, shared embeddings) or a registry "
                         "arch name, e.g. 'mamba2-130m'")
    ap.add_argument("--host-tier-pages", type=int, default=None,
                    help="host-DRAM cold tier capacity in pages: "
                         "preempted sequences spill there and restore "
                         "on readmission instead of recomputing (paged "
                         "layout only)")
    ap.add_argument("--high-watermark", type=float, default=None,
                    help="pool fraction above which the engine "
                         "proactively preempts youngest slots")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="keep full prompt pages alive after their "
                         "request retires (serve/prefix_store.py): later "
                         "requests sharing the prefix adopt the cached "
                         "pages instead of re-prefilling; idle entries "
                         "are evicted LRU under memory pressure")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many SHARED system-prompt tokens "
                         "to every request (makes --prefix-cache hits "
                         "visible in stats['prefix_store'])")
    ap.add_argument("--shards", type=int, default=1,
                    help="banks of the near-memory sharded page arena (1 = "
                         "one arena); on --device when named, else "
                         "round-robin over the visible cards")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--port", type=int, default=None,
                    help="serve the NETWORK FRONT on this port instead of "
                         "the synthetic batch loop (0 = ephemeral; runs "
                         "until interrupted)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --port")
    ap.add_argument("--tenant-budget", default=None, metavar="T:W,...",
                    help="per-tenant weighted max-min token-budget shares, "
                         "e.g. 'alpha:3,beta:1' (unnamed tenants weigh 1)")
    args = ap.parse_args(argv)
    tenant_weights = parse_tenant_budget(args.tenant_budget)

    cfg = get_arch(args.arch).model
    if args.reduced:
        cfg = reduced_for_smoke(cfg, max_seq=args.max_seq)
    if args.kv_dtype:
        cfg = cfg.replace(kv_dtype=args.kv_dtype)
    if not registry.has_decode(cfg):
        raise SystemExit(f"{args.arch} is encoder-only: nothing to serve")
    patches = cfg.num_patches if cfg.frontend == "patch" else 0
    budget = args.max_seq - args.max_new - patches
    if budget < 5:       # before params init: fail fast on full models
        raise SystemExit(
            f"--max-seq {args.max_seq} too small: {patches} patch rows + "
            f"--max-new {args.max_new} leave no room for a prompt "
            f"(need max_seq >= {patches + args.max_new + 5})")

    mesh = None
    if args.shards > 1:
        from repro_torch.launch.mesh import make_mem_mesh
        mesh = make_mem_mesh(args.shards, devices=None if args.device is None
                             else [args.device])
        log.info("sharded arena: %d banks on %s", args.shards,
                 [str(d) for d in mesh.devices])
    engine_kw = dict(device=args.device, seed=args.seed, mesh=mesh,
                     max_batch=args.max_batch, max_seq=args.max_seq,
                     page_size=args.page_size, layout=args.layout,
                     prefill_chunk=args.prefill_chunk,
                     high_watermark=args.high_watermark,
                     host_tier_pages=args.host_tier_pages,
                     prefix_cache=args.prefix_cache,
                     speculate_k=args.speculate,
                     draft=args.draft if args.speculate else None)
    if args.port is not None:
        # network-front mode: the same engine, served over HTTP + SSE
        # until interrupted
        from repro_torch.serve.frontend import FrontendServer
        srv = FrontendServer(cfg, host=args.host, port=args.port,
                             tenant_weights=tenant_weights, **engine_kw)
        srv.start()
        log.info("serving %s over http://%s:%d (tenants: %s) — Ctrl-C "
                 "to stop", args.arch, srv.host, srv.port,
                 args.tenant_budget or "off")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            log.info("stopping: %s", srv.llm.stats)
            srv.stop()
        return []

    server = LLMServer(cfg, **engine_kw)
    rng = np.random.default_rng(args.seed)
    if args.shared_prefix >= budget - 4:
        raise SystemExit(f"--shared-prefix {args.shared_prefix} leaves no "
                         f"room for a per-request tail (budget {budget})")
    system = rng.integers(0, cfg.vocab_size,
                          (args.shared_prefix,)).astype(np.int32)
    for i in range(args.requests):
        plen = int(rng.integers(4, budget - args.shared_prefix))
        prompt = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
        prompt = np.concatenate([system, prompt])
        pe = (rng.standard_normal((patches, cfg.frontend_dim))
              .astype(np.float32) if patches else None)
        server.generate(prompt, SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.sample_seed + i,
            max_new_tokens=args.max_new), patch_embeds=pe)

    results = server.run()
    lat = sorted(r.latency_s for r in results)
    mode = ("greedy" if args.temperature == 0.0 else
            f"T={args.temperature} k={args.top_k} p={args.top_p}")
    log.info("served %d requests (%s); latency p50 %.3fs p95 %.3fs; "
             "stats=%s", len(results), mode, lat[len(lat) // 2],
             lat[int(len(lat) * 0.95)], server.stats)
    return results


if __name__ == "__main__":
    main()
