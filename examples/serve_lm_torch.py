"""Serving example with the PyTorch port: the counterpart of
`examples/serve_lm.py`'s streaming demo and its network-client demo.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
        [--temperature T] [--top-k K] [--top-p P] [--seed S]
        [--kv-dtype int8|fp8|bf16] [--host-tier-pages N]
        [--connect HOST:PORT]

By default it demonstrates the streaming API (`repro_torch.serve.api`
`LLMServer`) on a reduced internlm2-1.8b with seeded random weights, on
the card unless `--device` names another: `generate(prompt,
SamplingParams(...))` returns a `GenerationStream` that yields
`TokenEvent`s as the engine ticks, and `stream.fork(params)` branches
the in-flight sequence under a second sampling regime over shared
copy-on-write pages.  The sampling flags set the per-request
`SamplingParams` (temperature 0 = greedy; each request gets seed
S + index); `--kv-dtype` picks the page arena's storage dtype and
`--host-tier-pages` puts a host-DRAM tier behind the pool.

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
                host_tier_pages: int | None = None):
    """The streaming API: tokens print as the engine emits them, then a
    fork decodes the same prompt under a second sampling regime from
    shared COW pages."""
    import numpy as np

    from repro_torch.serve.api import LLMServer
    from repro_torch.serve.engine import FinishEvent, TokenEvent
    from repro_torch.serve.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    server = LLMServer(cfg, device=device, seed=seed, max_batch=4,
                       max_seq=128, page_size=16,
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
    from repro_torch.models.config import reduced_for_smoke
    from repro_torch.serve.sampling import SamplingParams

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
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
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed)
    demo_stream(cfg, sp, args.seed, device=args.device,
                host_tier_pages=args.host_tier_pages)
    return None


if __name__ == "__main__":
    main()
