"""Serving entry point: paged continuous batching on the UniMem arena.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch internlm2-1.8b|qwen3-moe-30b-a3b|zamba2-2.7b \
        --requests 8 --max-new 32 \
        [--reduced] [--max-batch 4 --max-seq 128 --page-size 16] \
        [--prefill-chunk N] [--temperature T --top-k K --top-p P \
         --sample-seed S] [--kv-dtype int8|fp8|bf16] [--device cpu]

Builds the model with seeded random weights on the device (CUDA unless
`--device` names another), submits a synthetic request stream with mixed
prompt lengths, runs the engine to completion and logs latency,
throughput and pool statistics.  Each request gets its own sampling
seed (base + uid), so reruns reproduce while requests decorrelate.
The MoE and hybrid archs serve with their shipped `moe_dispatch="ep"` /
`ssd_impl="xla"` (the einsum dispatch and the plain SSD); the
grouped-matmul and SSD kernels are reached by serving
`cfg.replace(moe_dispatch="grouped")` / `cfg.replace(ssd_impl="pallas")`
through `LLMServer`.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models.config import reduced_for_smoke
from repro_torch.serve.api import LLMServer
from repro_torch.serve.sampling import SamplingParams
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).model
    if args.reduced:
        cfg = reduced_for_smoke(cfg, max_seq=args.max_seq)
    if args.kv_dtype:
        cfg = cfg.replace(kv_dtype=args.kv_dtype)
    budget = args.max_seq - args.max_new
    if budget < 5:
        raise SystemExit(
            f"--max-seq {args.max_seq} too small: --max-new {args.max_new} "
            f"leaves no room for a prompt (need max_seq >= "
            f"{args.max_new + 5})")

    server = LLMServer(cfg, device=args.device, seed=args.seed,
                       max_batch=args.max_batch, max_seq=args.max_seq,
                       page_size=args.page_size,
                       prefill_chunk=args.prefill_chunk)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(4, budget))
        prompt = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
        server.generate(prompt, SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.sample_seed + i,
            max_new_tokens=args.max_new))

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
