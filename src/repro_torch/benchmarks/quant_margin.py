"""The quantized sweep's greedy streams, with the margin of every token.

`serve_throughput._quant_sweep` serves one stream over a bf16 and over
an int8 page arena (an f32 model) and requires identical greedy tokens.
This tool serves the same two engines on the tool's default weights and
records, for every token a decode step picks, the gap between its two
largest logits.  On the card it serves them twice: through the paged
kernels (`kernels`) and with the paged kernels replaced by their plain
versions (`plain`, the CPU route's arithmetic); on the CPU it serves
the plain route alone.  It prints one JSON object: per route and arena
the tokens and the smallest gap, and every route's token and gap at
each (uid, index) where the streams disagree and at each `--at`.

    PYTHONPATH=src python -m repro_torch.benchmarks.quant_margin \\
        [--device cpu] [--at 4:4]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.benchmarks import serve_throughput as ST
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_prefill import ops as pp
from repro_torch.models import layers
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import serve_step
from repro_torch.utils.device import resolve_device

ARENAS = ("bf16", "int8")


def _plain_decode(*args, **kw):
    return pa.paged_decode_attention_plain(*args, round_scores=True, **kw)


def _plain_prefill(*args, **kw):
    return pp.paged_prefill_attention_plain(*args, round_scores=True, **kw)


def _serve(cfg, params, reqs, device) -> tuple[dict, dict]:
    """`_quant_sweep`'s engine over `reqs`: the tokens by uid, and the
    top-2 logit gap of every decoded token by (uid, index)."""
    gaps, last = {}, {}
    base_sample = serve_step.sample_tokens
    base_emit = engine_mod.ServingEngine._emit_decoded

    def sample(logits, state, knobs=None):
        top = torch.topk(logits.float(), 2, dim=-1).values
        last["gap"] = (top[:, 0] - top[:, 1]).cpu()
        return base_sample(logits, state, knobs)

    def emit(self, active, nxt):
        gap = last.pop("gap")
        for i, s in active.items():
            gaps[(s.request.uid, len(s.generated))] = float(gap[i])
        return base_emit(self, active, nxt)

    serve_step.sample_tokens = sample
    engine_mod.ServingEngine._emit_decoded = emit
    try:
        out = ST._run(cfg, params, "paged", reqs, 4, 128, device)
    finally:
        serve_step.sample_tokens = base_sample
        engine_mod.ServingEngine._emit_decoded = base_emit
    return out["tokens"], gaps


def run(device=None, at=()) -> dict:
    device = resolve_device(device)
    reqs = ST._stream(np.random.default_rng(777), ST.QUANT_CFG, 8, 48, 8)
    routes = ("kernels", "plain") if device.type == "cuda" else ("plain",)
    params_for = ST._params_for(None, device)
    served = {}
    for route in routes:
        saved = layers.paged_decode_attention, layers.paged_prefill_attention
        if route == "plain":
            layers.paged_decode_attention = _plain_decode
            layers.paged_prefill_attention = _plain_prefill
        try:
            for tag in ARENAS:
                cfg = ST.QUANT_CFG.replace(kv_dtype=tag)
                served[f"{route}/{tag}"] = _serve(cfg, params_for(cfg), reqs,
                                                  device)
        finally:
            layers.paged_decode_attention, layers.paged_prefill_attention = \
                saved
    summary = {}
    for name, (tokens, gaps) in served.items():
        where = min(gaps, key=gaps.get)
        summary[name] = {"tokens": {u: list(t) for u, t in tokens.items()},
                         "min_gap": gaps[where], "min_gap_at": list(where)}
    first = next(iter(served.values()))[0]
    points = sorted({(u, i) for tokens, _ in served.values()
                     for u, t in tokens.items()
                     for i, tok in enumerate(t) if tok != first[u][i]}
                    | {tuple(p) for p in at})
    table = [{"uid": u, "index": i,
              "tokens": {n: tokens[u][i] for n, (tokens, _) in served.items()},
              "gaps": {n: gaps.get((u, i)) for n, (_, gaps) in served.items()}}
             for u, i in points]
    same = all(tokens == first for tokens, _ in served.values())
    return {"name": "quant_margin", "device": str(device),
            "card": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else None),
            "routes": summary, "all_streams_equal": same, "points": table}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--at", action="append", default=[],
                    help="uid:index of a token to report on every route")
    args = ap.parse_args()
    at = [tuple(int(x) for x in a.split(":")) for a in args.at]
    print(json.dumps(run(args.device, at)))


if __name__ == "__main__":
    main()
