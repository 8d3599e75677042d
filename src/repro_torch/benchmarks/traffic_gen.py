"""Trace-driven traffic generator for the port's network serving front.

Port of the reference's `benchmarks/traffic_gen.py`.  Drives the REAL
`FrontendServer` (serve/frontend) over localhost TCP — HTTP submit, SSE
streaming, client aborts — with a seeded synthetic trace that mixes the
arrival patterns a production engine must survive:

* Poisson chatbot arrivals with heavy-tailed prompt/output lengths
  (Pareto — most requests are small, the tail is not),
* a BURST STORM: a knot of simultaneous arrivals mid-trace,
* one GIANT PROMPT amid the chatbots (the head-of-line-blocking bait
  the chunked-prefill scheduler exists to defuse),
* fork FANOUT requests (one prompt, several sampling regimes over one
  socket via the engine's COW fork),
* mid-flight CLIENT ABORTS (socket drop, no cancel frame — the
  disconnect path must reclaim pages).

Requests carry two tenants ("alpha" weight 3, "beta" weight 1); the
engine runs with `tenant_weights` so admission order and the token
budget follow weighted max-min shares (frontend/tenants.py).  The giant
prompt is submitted under BETA — fairness should keep alpha's latency
tail intact while beta absorbs its own whale.

Reported per tenant: TTFT and TPOT p50/p99 (wall-clock, measured at the
client), goodput under a TTFT SLO (completed tokens/s counting only
SLO-meeting streams), plus engine admission/preemption/cancellation
counters and the cancel-reclaim latency (abort -> pages back in the
pool, measured by polling GET /v1/stats).

PASS gates (wall-clock magnitudes are reported, not judged):
  (a) every accepted, non-aborted stream receives its finish frame;
  (b) a token-identity subset: streams replayed in-process through
      `LLMServer` with the same params equal what crossed the wire;
  (c) p99 TTFT is finite under the burst (every stream actually
      started — no starved tenant);
  (d) zero leaked pages after the trace drains (allocated == pinned,
      no open routes).

    PYTHONPATH=src python -m repro_torch.benchmarks.traffic_gen \\
        [--requests 24] [--horizon 1.5] [--seed 0] [--shards N] \\
        [--json BENCH_traffic.json] [--device cpu]

`--shards N` serves the trace from the near-memory sharded arena (N
banks, on `--device` when named, else round-robin over the visible
cards; the record's `shard_topology` names each bank's device).

`run` takes the model config, its params, the engine's sizes and the
device as keyword arguments (defaults: the reference's tiny `CFG`,
max_batch 4, max_seq 256, tick_token_budget 64, page 16, CUDA), so the
same trace can be served at a full model's width.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.serve.api import LLMServer
from repro_torch.serve.frontend import FrontendServer, ServeClient
from repro_torch.serve.sampling import SamplingParams

# machine-readable result schema: 1 = per-tenant TTFT/TPOT p50/p99,
# goodput-under-SLO, cancel-reclaim latency, admission/preemption/
# cancellation counters, gate booleans
SCHEMA = 1

CFG = ModelConfig(
    name="traffic-dense", family="dense", num_layers=2, d_model=64,
    vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    attn_chunk=32, max_seq=256)

TENANT_WEIGHTS = {"alpha": 3.0, "beta": 1.0}
TTFT_SLO_S = 5.0


# ------------------------------------------------------------------- trace

def build_trace(rng: np.random.Generator, n: int, horizon: float,
                max_seq: int, vocab_size: int = CFG.vocab_size
                ) -> list[dict]:
    """Seeded synthetic trace: a list of submit descriptions, each
    {"at": arrival_s, "tenant", "prompt", "params", "fanout",
    "abort_after": tokens | None}.  Arrivals are Poisson over
    [0, horizon) with a burst storm knotted at horizon/2 and one giant
    prompt; lengths are Pareto (heavy-tailed); token ids lie in
    [1, vocab_size)."""
    def lengths():
        plen = int(min(max_seq // 4, 4 + rng.pareto(1.5) * 6))
        gen = int(min(24, 3 + rng.pareto(1.3) * 4))
        return max(2, plen), max(2, gen)

    def prompt(plen):
        return rng.integers(1, vocab_size, size=plen).tolist()

    entries: list[dict] = []
    # Poisson chatbots (~60% of n)
    t = 0.0
    n_chat = max(4, int(n * 0.6))
    for _ in range(n_chat):
        t += rng.exponential(horizon / max(n_chat, 1))
        plen, gen = lengths()
        entries.append(dict(
            at=min(t, horizon), tenant=("alpha" if rng.random() < 0.6
                                        else "beta"),
            prompt=prompt(plen),
            params=SamplingParams(max_new_tokens=gen,
                                  temperature=float(rng.choice([0.0, 0.8])),
                                  top_k=20, seed=int(rng.integers(1 << 20))),
            fanout=None, abort_after=None))
    # burst storm: simultaneous knot at horizon/2 (~25% of n)
    for _ in range(max(3, int(n * 0.25))):
        plen, gen = lengths()
        entries.append(dict(
            at=horizon / 2 + float(rng.random()) * 1e-3,
            tenant=("alpha" if rng.random() < 0.5 else "beta"),
            prompt=prompt(plen),
            params=SamplingParams(max_new_tokens=gen,
                                  seed=int(rng.integers(1 << 20))),
            fanout=None, abort_after=None))
    # one giant prompt (under beta — fairness should shield alpha)
    entries.append(dict(
        at=horizon * 0.4, tenant="beta",
        prompt=prompt(max_seq // 2),
        params=SamplingParams(max_new_tokens=8),
        fanout=None, abort_after=None))
    # fork fanout: one prompt, two extra sampling regimes
    plen, gen = lengths()
    entries.append(dict(
        at=horizon * 0.3, tenant="alpha", prompt=prompt(plen),
        params=SamplingParams(max_new_tokens=max(4, gen), seed=11),
        fanout=[SamplingParams(max_new_tokens=max(4, gen), seed=12,
                               temperature=0.9),
                SamplingParams(max_new_tokens=max(4, gen), seed=13,
                               temperature=0.9, top_p=0.8)],
        abort_after=None))
    # mid-flight aborts: two long streams dropped at their 3rd token
    for frac in (0.25, 0.6):
        entries.append(dict(
            at=horizon * frac, tenant="beta",
            prompt=prompt(8),
            params=SamplingParams(max_new_tokens=40),
            fanout=None, abort_after=3))
    entries.sort(key=lambda e: e["at"])
    return entries


# ----------------------------------------------------------------- clients

async def _drive_one(client: ServeClient, entry: dict, t_start: float
                     ) -> dict:
    """Submit one trace entry at its arrival time; stream to completion
    (or abort); return wall-clock observations."""
    await asyncio.sleep(max(0.0, entry["at"] - (time.perf_counter()
                                                - t_start)))
    obs = dict(tenant=entry["tenant"], submitted_at=time.perf_counter(),
               ttft=None, token_times=[], finished={}, aborted=False,
               tokens={}, error=None, prompt=entry["prompt"],
               params=entry["params"], abort_after=entry["abort_after"])
    try:
        stream = await client.submit(entry["prompt"], entry["params"],
                                     tenant=entry["tenant"],
                                     fanout=entry["fanout"])
    except Exception as e:                        # rejected at admission
        obs["error"] = str(e)
        return obs
    n_sid0 = 0
    async for event, data in stream:
        now = time.perf_counter()
        sid = data.get("sid")
        if event == "token":
            obs["tokens"].setdefault(sid, []).append(data["t"])
            if sid == 0:
                if obs["ttft"] is None:
                    obs["ttft"] = now - obs["submitted_at"]
                obs["token_times"].append(now)
                n_sid0 += 1
                if (entry["abort_after"] is not None
                        and n_sid0 >= entry["abort_after"]):
                    obs["aborted"] = True
                    obs["abort_at"] = now
                    await stream.abort()
                    break
        elif event == "finish":
            obs["finished"][sid] = data["reason"]
        elif event == "error":
            obs["error"] = f"{data.get('code')}: {data.get('message')}"
    return obs


async def _cancel_reclaim_latency(client: ServeClient, obs_aborts: list
                                  ) -> float:
    """Poll /v1/stats until every abort's pages are back (allocated ==
    pinned and the cancellation counter covers them); returns seconds
    from the LAST abort to reclaim."""
    if not obs_aborts:
        return 0.0
    t_abort = max(o["abort_at"] for o in obs_aborts)
    deadline = time.perf_counter() + 30.0
    while time.perf_counter() < deadline:
        s = await client.stats()
        eng = s["engine"]
        pool = eng.get("pool", {})
        if (eng.get("cancellations", 0) >= len(obs_aborts)
                and pool.get("allocated_pages", -1)
                == pool.get("pinned_pages", 0)):
            return time.perf_counter() - t_abort
        await asyncio.sleep(0.005)
    return float("inf")


async def _run_trace(port: int, entries: list[dict]) -> tuple[list, float]:
    client = ServeClient("127.0.0.1", port)
    t_start = time.perf_counter()
    obs = await asyncio.gather(*[_drive_one(client, e, t_start)
                                 for e in entries])
    reclaim = await _cancel_reclaim_latency(
        client, [o for o in obs if o["aborted"]])
    return list(obs), reclaim


# ----------------------------------------------------------------- metrics

def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, float), q)) if xs else None


def _tenant_rows(obs: list[dict], wall: float) -> list[dict]:
    rows = []
    for tenant in sorted(TENANT_WEIGHTS):
        mine = [o for o in obs if o["tenant"] == tenant
                and o["error"] is None]
        ttfts = [o["ttft"] for o in mine if o["ttft"] is not None]
        tpots = []
        for o in mine:
            ts = o["token_times"]
            if len(ts) >= 2:
                tpots.append((ts[-1] - ts[0]) / (len(ts) - 1))
        done = [o for o in mine if not o["aborted"] and 0 in o["finished"]]
        slo_ok = [o for o in done if o["ttft"] is not None
                  and o["ttft"] <= TTFT_SLO_S]
        slo_tokens = sum(len(toks) for o in slo_ok
                         for toks in o["tokens"].values())
        rows.append(dict(
            tenant=tenant, weight=TENANT_WEIGHTS[tenant],
            requests=len(mine), completed=len(done),
            aborted=sum(o["aborted"] for o in mine),
            ttft_p50_s=_pct(ttfts, 50), ttft_p99_s=_pct(ttfts, 99),
            tpot_p50_s=_pct(tpots, 50), tpot_p99_s=_pct(tpots, 99),
            slo_attainment=(len(slo_ok) / len(done)) if done else None,
            goodput_tok_s=slo_tokens / wall if wall > 0 else 0.0))
    return rows


def _token_identity(llm: LLMServer, obs: list[dict],
                    max_checks: int = 3) -> tuple[bool, list[dict]]:
    """Replay a subset of completed streams in-process through `llm`
    (an engine on the same params); over-the-wire tokens must equal
    the replay's.  Returns (all equal, one record per replay)."""
    checked, ok = [], True
    for o in obs:
        if len(checked) >= max_checks:
            break
        if o["aborted"] or o["error"] is not None or 0 not in o["finished"]:
            continue
        res = llm.generate(o["prompt"], o["params"]).drain()
        same = o["tokens"].get(0, []) == list(res.tokens)
        ok &= same
        checked.append(dict(tenant=o["tenant"],
                            temperature=o["params"].temperature,
                            tokens=len(res.tokens), equal=same))
    return ok, checked


# --------------------------------------------------------------------- run

def run(requests: int = 24, horizon: float = 1.5, seed: int = 0,
        json_path: str | None = "BENCH_traffic.json", *,
        cfg: ModelConfig = CFG, params=None, max_batch: int = 4,
        max_seq: int = 256, tick_token_budget: int = 64,
        page_size: int = 16, device=None, identity_checks: int = 3,
        after_stop=None, shards: int | None = None) -> dict:
    """Serve the seeded trace through a `FrontendServer` on `device`
    (CUDA unless named) and judge the four gates.  `params=None` draws
    the model's seeded random weights on the device.  `after_stop`, if
    given, is called with the stopped server before the in-process
    replays (which run on the same device and mesh, the server's engine
    gone).  `shards` > 1 serves from the sharded arena: its banks on
    `device` when it is named, else round-robin over the visible cards;
    the trace record's `shard_topology` says where."""
    mesh = None
    if shards and shards > 1:
        from repro_torch.launch.mesh import make_mem_mesh
        mesh = make_mem_mesh(shards, devices=None if device is None
                             else [device])
    rng = np.random.default_rng(seed)
    entries = build_trace(rng, requests, horizon, max_seq, cfg.vocab_size)

    srv = FrontendServer(cfg, params, host="127.0.0.1", port=0,
                         device=device, max_batch=max_batch,
                         max_seq=max_seq, page_size=page_size,
                         tick_token_budget=tick_token_budget, mesh=mesh,
                         tenant_weights=TENANT_WEIGHTS)
    srv.start()
    t0 = time.perf_counter()
    try:
        obs, reclaim_s = asyncio.run(_run_trace(srv.port, entries))
        wall = time.perf_counter() - t0
        stats = srv.llm.stats
        fe = dict(srv.counters)
    finally:
        srv.stop()
    if after_stop is not None:
        after_stop(srv)

    rows = _tenant_rows(obs, wall)
    accepted = [o for o in obs if o["error"] is None]
    # (a) every accepted, non-aborted stream finished — including every
    # fanout child sid it was promised
    ok_complete = all(
        o["aborted"] or (0 in o["finished"]
                         and len(o["finished"]) == len(o["tokens"]))
        for o in accepted)
    # (b) identity with in-process serving, on the server's params
    params, device = srv.llm.engine.params, srv.llm.engine.device
    del srv                          # the server's arena goes first
    oracle = LLMServer(cfg, params, device=device, max_batch=max_batch,
                       max_seq=max_seq, page_size=page_size, mesh=mesh)
    ok_identity, replays = _token_identity(oracle, obs, identity_checks)
    del oracle
    # (c) p99 TTFT finite: every accepted stream actually started
    ok_ttft = all(o["ttft"] is not None for o in accepted) and all(
        r["ttft_p99_s"] is not None and np.isfinite(r["ttft_p99_s"])
        for r in rows if r["requests"])
    # (d) zero leaked pages once drained
    pool = stats.get("pool", {})
    ok_leak = bool(pool.get("allocated_pages", -1)
                   == pool.get("pinned_pages", 0)
                   and np.isfinite(reclaim_s))

    result = {
        "name": "traffic_gen", "schema": SCHEMA,
        "ok": bool(ok_complete and ok_identity and ok_ttft and ok_leak),
        "gates": dict(streams_complete=ok_complete,
                      token_identity=ok_identity,
                      identity_checked=len(replays),
                      ttft_finite=ok_ttft, zero_leaked_pages=ok_leak),
        "rows": rows,
        "trace": dict(requests=len(entries), horizon_s=horizon, seed=seed,
                      wall_s=wall, shards=shards or 1),
        "shard_topology": ({"shards": 1, "mesh_axis": None,
                            "devices": [str(device)]} if mesh is None
                           else mesh.describe()),
        "cancel_reclaim_s": reclaim_s,
        "counters": dict(admitted=stats.get("admitted"),
                         preemptions=stats.get("preemptions"),
                         cancellations=stats.get("cancellations"),
                         frontend=fe),
        "tenant_tokens": {t: v["tokens"]
                          for t, v in stats.get("tenants", {}).items()},
        "replays": replays,
        "error_frames": [o["error"] for o in obs if o["error"] is not None],
        "streams": sum(len(o["finished"]) for o in obs)
        + sum(o["aborted"] for o in obs),
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def pretty(result: dict):
    print(f"== traffic_gen (network front, schema {result['schema']}) ==")
    tr = result["trace"]
    print(f"  trace: {tr['requests']} requests over {tr['horizon_s']}s "
          f"(seed {tr['seed']}, {tr['shards']} shard(s)), "
          f"drained in {tr['wall_s']:.2f}s")
    hdr = (f"  {'tenant':<8} {'w':>3} {'req':>4} {'done':>5} {'abrt':>5} "
           f"{'ttft p50':>9} {'ttft p99':>9} {'tpot p50':>9} "
           f"{'slo%':>6} {'goodput':>9}")
    print(hdr)
    for r in result["rows"]:
        def fmt(x, unit=""):
            return "-" if x is None else f"{x:.3f}{unit}"
        slo = ("-" if r["slo_attainment"] is None
               else f"{100 * r['slo_attainment']:.0f}%")
        print(f"  {r['tenant']:<8} {r['weight']:>3.0f} {r['requests']:>4} "
              f"{r['completed']:>5} {r['aborted']:>5} "
              f"{fmt(r['ttft_p50_s'], 's'):>9} {fmt(r['ttft_p99_s'], 's'):>9} "
              f"{fmt(r['tpot_p50_s'], 's'):>9} "
              f"{slo:>6} {r['goodput_tok_s']:>7.1f}/s")
    c = result["counters"]
    print(f"  cancel-reclaim {result['cancel_reclaim_s'] * 1e3:.0f} ms | "
          f"admitted {c['admitted']} preemptions {c['preemptions']} "
          f"cancellations {c['cancellations']}")
    print(f"  gates: {result['gates']}")
    print(f"  -> {'PASS' if result['ok'] else 'FAIL'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--horizon", type=float, default=1.5)
    ap.add_argument("--shards", type=int, default=None,
                    help="serve from the near-memory sharded arena with "
                         "N banks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="BENCH_traffic.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    a = ap.parse_args(argv)
    res = run(requests=a.requests, horizon=a.horizon, seed=a.seed,
              json_path=a.json, device=a.device, shards=a.shards)
    pretty(res)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
