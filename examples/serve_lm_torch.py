"""Serving example with the PyTorch port: the counterpart of
`examples/serve_lm.py` (its batch loop, its streaming demo and its
network-client demo).

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
        [--stream] [--temperature T] [--top-k K] [--top-p P] [--seed S]
        [--kv-dtype int8|fp8|bf16] [--host-tier-pages N]
        [--prefix-cache] [--speculate K] [--draft self:1]
        [--devices N] [--connect HOST:PORT]

Everything runs on a reduced internlm2-1.8b with seeded random weights,
on the card unless `--device` names another.  Without `--stream` the
example runs the classic batch loop: a bursty stream of 12 mixed-length
requests through the paged engine (lazy page allocation: pool memory
tracks tokens in flight), then the two UniMem sharing paths end to end:

  * prefix sharing — identical prompts reuse each other's prompt pages
    through the page-hash cache (refcounts, zero copies, zero
    recompute of the shared K/V);
  * `engine.fork()` — branch an in-flight sequence; the child shares
    every page and the first divergent write copies only the partial
    last page.

`--prefix-cache` turns on the PERSISTENT cross-request prefix store:
after the batch loop the same request stream reruns against the
retained prompt pages and the example prints the cross-request hit and
eviction counts.  `--speculate K` decodes speculatively: a draft
(`--draft`, default `self:1` = the target's first layer sharing its
embeddings and head) proposes K tokens a window and the target verifies
the window in one batched paged call; the tokens stay byte-identical to
plain decode, and the example prints the accept rate.  `--devices N`
(default 1) serves the batch loop and the streaming demo from the
near-memory SHARDED arena of DESIGN.md §2 with N banks: each bank
keeps its pages, every bank walks only its resident pages, and only the
softmax summaries come back to be merged.  The banks go round-robin
over the visible cards (N banks on one card share it), or all on
`--device` when one is named; the example prints each bank's peak pages
and bytes.

`--stream` demonstrates the streaming API (`repro_torch.serve.api`
`LLMServer`): `generate(prompt, SamplingParams(...))` returns a
`GenerationStream` that yields `TokenEvent`s as the engine ticks, and
`stream.fork(params)` branches the in-flight sequence under a second
sampling regime over shared copy-on-write pages.  The sampling flags
set the per-request `SamplingParams` (temperature 0 = greedy; each
request gets seed S + index); `--kv-dtype` picks the page arena's
storage dtype and `--host-tier-pages` puts a host-DRAM tier behind the
pool.

`--connect host:port` builds no model and runs as a NETWORK CLIENT
against a running front (`python -m repro_torch.launch.serve --reduced
--port 8400 --tenant-budget alpha:3,beta:1`): two tenants submit a
burst of concurrent streams over localhost SSE, one stream is aborted
mid-flight (the server reclaims its pages), and the demo prints
per-tenant TTFT and the server's own tenant token shares.
"""
from __future__ import annotations

import argparse


def demo_stream(cfg, sp, seed: int, device=None,
                host_tier_pages: int | None = None, mesh=None):
    """The streaming API: tokens print as the engine emits them, then a
    fork decodes the same prompt under a second sampling regime from
    shared COW pages.  With a mesh, the same streams serve from the
    sharded arena."""
    import numpy as np

    from repro_torch.serve.api import LLMServer
    from repro_torch.serve.engine import FinishEvent, TokenEvent
    from repro_torch.serve.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    server = LLMServer(cfg, device=device, seed=seed, max_batch=4,
                       max_seq=128, page_size=16, mesh=mesh,
                       host_tier_pages=host_tier_pages)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 40)))
               .astype(np.int32) for _ in range(3)]
    streams = [server.generate(
        p, SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                          top_p=sp.top_p, seed=sp.seed + i,
                          max_new_tokens=12))
        for i, p in enumerate(prompts)]

    print("== streaming: tokens as the engine ticks ==")
    for i, stream in enumerate(streams):
        for ev in stream:
            if isinstance(ev, TokenEvent):
                print(f"  req{i} t{ev.index}: {ev.token}", flush=True)
            elif isinstance(ev, FinishEvent):
                print(f"  req{i} finished ({ev.reason}): "
                      f"{ev.result.tokens}")

    # fork: one prompt, two sampling regimes, shared COW pages
    parent = server.generate(prompts[0], SamplingParams(
        max_new_tokens=10, seed=sp.seed))                 # greedy parent
    child = parent.fork(SamplingParams(temperature=0.9, top_p=0.9,
                                       seed=sp.seed + 99,
                                       max_new_tokens=10))
    shared = server.engine.pool.stats().shared_pages
    a, b = parent.drain(), child.drain()
    print(f"fork: {shared} pages shared at branch point")
    print(f"  greedy  : {a.tokens}")
    print(f"  sampled : {b.tokens}")
    st = server.stats
    print(f"engine[{st['device']}]: {st['tokens_out']} tokens in "
          f"{st['steps']} steps, pool peak "
          f"{st['pool']['peak_allocated_pages']} pages, "
          f"{st['pool']['allocated_pages']} still allocated")
    if "host_tier" in st:
        print(f"host tier: {st['host_tier']}")


def demo_batch(cfg, params, device, *, temperature=0.0, top_k=0, top_p=1.0,
               seed=0, host_tier_pages=None, prefix_cache=False,
               speculate=0, draft="self:1", mesh=None) -> dict:
    """The batch loop: 12 mixed-length requests through the paged engine
    with pool statistics (the persistent cache's rerun, speculation and
    the host tier where asked), then the prefix-sharing and fork demos.
    With a mesh the batch loop serves from the sharded arena.  Returns
    the engine's stats after the loop."""
    import numpy as np

    from repro_torch.serve import Request, SamplingParams, ServingEngine

    engine = ServingEngine(cfg, params, device=device, max_batch=4,
                           max_seq=128, page_size=16, mesh=mesh,
                           host_tier_pages=host_tier_pages,
                           prefix_cache=prefix_cache,
                           speculate_k=speculate,
                           draft=draft if speculate else None)

    def submit_wave(base_uid):
        rng = np.random.default_rng(seed)
        for uid in range(12):
            plen = int(rng.integers(4, 80))
            engine.submit(Request(
                uid=base_uid + uid,
                prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                sampling=SamplingParams(
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed + uid,
                    max_new_tokens=int(rng.integers(4, 16)))))
        return rng

    rng = submit_wave(0)
    results = engine.run()
    lats = sorted(r.latency_s for r in results)
    st = engine.pool.stats()
    mode = "greedy" if temperature == 0.0 else (
        f"T={temperature} k={top_k} p={top_p}")
    arena = "sharded arena" if engine.mesh is not None else "arena"
    print(f"[{engine.layout}/{arena}/{mode}] served {len(results)} requests"
          f" | p50 {lats[len(lats) // 2]:.2f}s p95 {lats[-1]:.2f}s | "
          f"{engine.tokens_out} tokens in {engine.steps} engine steps")
    print(f"pool: peak {st.peak_allocated_pages}/{st.num_pages} pages "
          f"({engine.peak_kv_bytes() / 1e6:.2f} MB KV high-water vs "
          f"{engine.max_batch * engine.max_seq // engine.page_size} pages "
          f"a contiguous layout would pin)")
    if engine.mesh is not None:
        shards = engine.pool.shard_stats()
        print(f"near-memory banks on {engine.stats()['mesh']['devices']}: "
              f"peak pages per bank "
              f"{[s['peak_allocated_pages'] for s in shards]} | resident "
              f"KV bytes per bank {engine.arena.shard_kv_bytes()}")
    if speculate:
        sp_st = engine.stats()["speculative"]
        print(f"speculative: k={sp_st['k']} accept rate "
              f"{sp_st['accept_rate']:.2f}, "
              f"{sp_st['emitted_tokens'] / max(sp_st['windows'], 1):.2f} "
              f"tokens/window over {sp_st['windows']} windows "
              f"(draft {sp_st['draft']['spec']}) — tokens byte-identical "
              "to plain decode")
    if engine.host_tier is not None:
        ht = engine.stats()["host_tier"]
        print(f"host tier: {ht['spills']} spills / {ht['restores']} "
              f"restores ({ht['peak_bytes'] / 1e6:.2f} MB peak resident)")
    if prefix_cache:
        # resubmit the SAME stream: with the persistent cache the prompt
        # pages of wave 1 are still resident, so wave 2 adopts them
        rng = submit_wave(100)
        engine.run()
        ps = engine.stats()["prefix_store"]
        print(f"prefix store: wave-2 rerun reused {ps['reused_pages']} "
              f"pages ({ps['cross_request_hits']} cross-request hits, "
              f"{ps['entries']} entries resident, "
              f"{ps['evictions']} evicted)")
    stats = engine.stats()
    del engine

    # --- prefix sharing: same 64-token prompt, pages reused on device
    prompt = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    eng = ServingEngine(cfg, params, device=device, max_batch=4, max_seq=128,
                        page_size=16)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=6))
    eng.step()
    st = eng.pool.stats()
    print(f"prefix sharing: 3 identical prompts -> {st.allocated_pages} pages "
          f"allocated ({st.shared_pages} shared) vs "
          f"{3 * eng.pool.pages_for(64)} unshared")
    res = eng.run()
    assert all(r.tokens == res[0].tokens for r in res)
    del eng

    # --- fork: branch an in-flight sequence, COW on the last page only
    eng = ServingEngine(cfg, params, device=device, max_batch=2, max_seq=128,
                        page_size=16)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=10))
    while not any(s.generated for s in eng.slots.values()):
        eng.step()
    eng.fork(0, new_uid=1)
    st = eng.pool.stats()
    print(f"fork: parent+child share {st.shared_pages} pages; "
          f"first divergent write copies exactly one")
    res = eng.run()
    assert len(res) == 2
    assert eng.pool.stats().allocated_pages == 0
    print("all pages returned to the pool")
    return stats


def demo_connect(target: str, seed: int = 0) -> dict:
    """Network-client demo against a running front: two tenants, a
    burst, one mid-flight abort, per-tenant fairness printed.  Returns
    the server's stats after the burst."""
    import asyncio
    import time

    import numpy as np

    from repro_torch.serve.frontend import ServeClient
    from repro_torch.serve.sampling import SamplingParams

    host, _, port = target.rpartition(":")
    client = ServeClient(host or "127.0.0.1", int(port))
    rng = np.random.default_rng(seed)

    async def one(tenant, prompt, params, abort_after=None):
        t0 = time.perf_counter()
        st = await client.submit(prompt, params, tenant=tenant)
        ttft, n = None, 0
        async for event, data in st:
            if event == "token" and data["sid"] == 0:
                n += 1
                if ttft is None:
                    ttft = time.perf_counter() - t0
                if abort_after is not None and n >= abort_after:
                    await st.abort()
                    return dict(tenant=tenant, ttft=ttft, tokens=n,
                                aborted=True)
            elif event == "error":
                raise RuntimeError(f"{data['code']}: {data['message']}")
        return dict(tenant=tenant, ttft=ttft, tokens=n, aborted=False)

    async def storm():
        jobs = []
        for i in range(8):                    # burst: all submitted at once
            tenant = "alpha" if i % 2 == 0 else "beta"
            prompt = rng.integers(1, 100, int(rng.integers(6, 24))).tolist()
            jobs.append(one(tenant, prompt,
                            SamplingParams(max_new_tokens=10, seed=seed + i)))
        jobs.append(one("beta", rng.integers(1, 100, 8).tolist(),
                        SamplingParams(max_new_tokens=40), abort_after=3))
        obs = await asyncio.gather(*jobs)
        stats = await client.stats()
        return obs, stats

    print(f"== network client vs {client.host}:{client.port} ==")
    obs, stats = asyncio.run(storm())
    for tenant in ("alpha", "beta"):
        ttfts = sorted(o["ttft"] for o in obs
                       if o["tenant"] == tenant and o["ttft"] is not None)
        done = sum(1 for o in obs if o["tenant"] == tenant
                   and not o["aborted"])
        print(f"  {tenant}: {done} completed, "
              f"ttft p50 {ttfts[len(ttfts) // 2]:.3f}s "
              f"(max {ttfts[-1]:.3f}s)")
    aborted = [o for o in obs if o["aborted"]]
    print(f"  aborted mid-flight: {len(aborted)} stream(s) — server "
          f"cancellations: {stats['engine'].get('cancellations')}")
    tenants = stats["engine"].get("tenants")
    if tenants:
        print("  server token shares: "
              + ", ".join(f"{t} (w={v['weight']:.0f}): {v['tokens']}"
                          for t, v in sorted(tenants.items())))
    print(f"  engine pool: {stats['engine']['pool']}")
    return stats


def main(argv=None):
    from repro_torch.configs import get_arch
    from repro_torch.models import registry
    from repro_torch.models.config import reduced_for_smoke
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--stream", action="store_true",
                    help="demo the streaming LLMServer.generate API "
                         "(tokens print as emitted; fork under a second "
                         "sampling regime) instead of the batch loop")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0, help="top-k (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed (index added per request)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("bf16", "int8", "fp8"),
                    help="page-arena storage dtype (int8/fp8 quantize on "
                         "write, dequantize inside the attention kernels)")
    ap.add_argument("--host-tier-pages", type=int, default=None,
                    help="enable the host-DRAM cold tier with this many "
                         "pages")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="persistent cross-request prefix cache: prompt "
                         "pages survive retirement and a rerun of the "
                         "same stream adopts them instead of prefilling")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decode: draft K tokens per window, "
                         "verify in one batched call — tokens stay "
                         "byte-identical to plain decode")
    ap.add_argument("--draft", default="self:1",
                    help="draft for --speculate: 'self:N' (first N "
                         "target layers, shared embeddings) or a "
                         "registry arch name")
    ap.add_argument("--devices", type=int, default=1,
                    help="banks of the near-memory sharded arena (1 = one "
                         "arena); on --device when named, else "
                         "round-robin over the visible cards")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="run as a network client against a serving "
                         "front (repro_torch.launch.serve --port N) "
                         "instead of building a local engine")
    args = ap.parse_args(argv)
    if args.connect:
        return demo_connect(args.connect, seed=args.seed)
    cfg = reduced_for_smoke(get_arch("internlm2-1.8b").model, max_seq=128)
    if args.kv_dtype:
        cfg = cfg.replace(kv_dtype=args.kv_dtype)    # quantized page arena
    mesh = None
    if args.devices > 1:
        from repro_torch.launch.mesh import make_mem_mesh
        mesh = make_mem_mesh(args.devices, devices=None if args.device is None
                             else [args.device])
        args.device = args.device or mesh.devices[0]
    if args.stream:
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed)
        demo_stream(cfg, sp, args.seed, device=args.device,
                    host_tier_pages=args.host_tier_pages, mesh=mesh)
        return None
    device = resolve_device(args.device)
    params = registry.get_family(cfg).init(0, cfg, device)
    return demo_batch(cfg, params, device, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p, seed=args.seed,
                      host_tier_pages=args.host_tier_pages,
                      prefix_cache=args.prefix_cache,
                      speculate=args.speculate, draft=args.draft, mesh=mesh)


if __name__ == "__main__":
    main()
