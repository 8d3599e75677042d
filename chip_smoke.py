#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, no options

Phases, each printing one JSON line (the script stops with a nonzero
exit at the first failure):

1. device + build: the card's name and power limit (nvidia-smi), then
   the four CUDA kernels built from `src/repro_torch/kernels/csrc` with
   nvcc for sm_90a.
2. kernels: each paged-attention kernel against its plain PyTorch
   version on the card, at the dense path's shapes (hq 16, hkv 8, d
   128, page 16, batch 8, ragged positions up to 1023, 64 table
   columns; prefill chunks of 1, 7 and 64 with ragged chunk lengths
   including 0), in bf16 and f32, with page_positions + POS_PAD holes +
   partials, and with int8 and fp8 pages, each output element within
   rtol |plain| + atol * max |plain row| (`repro_torch/kernels/
   tolerance.py`).  The main-path case is timed: kernel, plain version,
   one `scaled_dot_product_attention` call over the gathered K/V (a
   yardstick the port never calls) and the bound.
3. moe/ssd kernels: the grouped matmul at qwen3-moe-30b-a3b's shapes
   (128 experts, K x F 2048 x 768 and 768 x 2048, C 64 and 4096, with
   the live rows of a random top-8 routing and without) and the SSD
   intra-chunk kernel at zamba2-2.7b's (640 batch*heads, p = n = 64,
   chunks of 64 and 256), in bf16 and f32, against their plain versions
   by the same rule; timed beside one `torch.bmm` (grouped; SSD has no
   single PyTorch call) and the bound.
4. serve: `LLMServer` on internlm2-1.8b at full width and depth (bf16,
   seeded random weights): 8 prompts, one sampled, one stream forked
   after its first token; every stream finishes, no page leaks, each
   kernel launched 24 times per step call, and a second identical run
   gives byte-identical streams.
5. serve_moe: the same on qwen3-moe-30b-a3b (48 layers, 128 experts,
   `moe_dispatch="grouped"`): the grouped-matmul kernel launched 3 x 48
   times and each paged kernel 48 times per step call.
6. serve_hybrid: the same on zamba2-2.7b (54 Mamba-2 layers, 9 shared
   attention applications, `ssd_impl="pallas"`), with two identical
   prompts: the SSD kernel launched 54 times per prefill call, each
   paged kernel 9 times per step call.
7. card vs CPU: a 2-layer internlm2-width, a 2-layer qwen3-width and a
   12-layer (two shared applications) zamba2-width f32 model, one paged
   prefill and one paged decode step on the card (kernels) and on the
   CPU (plain versions), logits, pages and state compared.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
repository's `src/` beside it, the script exits nonzero and prints no
result.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
ROOT = Path(__file__).resolve().parent


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# ------------------------------------------------------------- timing

def time_ms(fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median of `iters` CUDA-event timings of fn(), each after an L2
    flush (the serving step finds attention's pages cold: other layers'
    weights pass through L2 in between)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------- phase 2: kernels

class KernelBench:
    """Main-path geometry and arenas for the kernel phase."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.dev = dev
        self.b, self.hq, self.hkv, self.d, self.page, self.mp = 8, 16, 8, 128, 16, 64
        g = torch.Generator(device="cpu").manual_seed(0)
        self.P = self.b * self.mp                       # pages; null = P
        perm = torch.randperm(self.P, generator=g).to(torch.int32)
        self.bt = perm.view(self.b, self.mp).to(dev)
        self.positions = torch.tensor([1023, 0, 511, 17, 700, 64, 255, 999],
                                      dtype=torch.int32, device=dev)
        # past each row's last live page the table points at the null page
        live = self.positions // self.page + 1
        cols = torch.arange(self.mp, device=dev)[None, :]
        self.bt = torch.where(cols < live[:, None].long(), self.bt,
                              torch.full_like(self.bt, self.P)).contiguous()
        shape = (self.P + 1, self.page, self.hkv, self.d)
        self.kf = torch.randn(shape, generator=g).to(dev)
        self.vf = torch.randn(shape, generator=g).to(dev)
        self.gen = g
        self.flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def flush(self):
        self.flush_buf.zero_()

    def pages(self, dtype):
        """K/V pages (+ scales) in `dtype` (float32, bfloat16, int8, fp8)."""
        torch = self.torch
        from repro_torch.core.unimem import quantize_kv
        if dtype in (torch.int8, torch.float8_e4m3fn):
            qk, sk = quantize_kv(self.kf, dtype)
            qv, sv = quantize_kv(self.vf, dtype)
            return qk, qv, sk.contiguous(), sv.contiguous()
        return self.kf.to(dtype), self.vf.to(dtype), None, None

    def holes(self):
        """A compacted table: every other live page of each row, at its
        true position, POS_PAD in the holes (a sharded walk's shape)."""
        torch = self.torch
        from repro_torch.kernels.paged_attention.ops import POS_PAD
        cols = torch.arange(self.mp, device=self.dev, dtype=torch.int32)
        ppos = (cols * self.page)[None, :].expand(self.b, self.mp).clone()
        ppos[:, 1::2] = POS_PAD
        return ppos.contiguous()

    def q(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen).to(self.dev).to(dtype)


def check(name, got, want, qdt, rows):
    """Hold a kernel's output against its plain version's, element by
    element (repro_torch.kernels.tolerance); returns the max abs error."""
    from repro_torch.kernels.tolerance import TOLERANCE, worst_ratio
    rtol, atol = TOLERANCE[qdt]
    err, ratio = worst_ratio(got, want, rtol, atol)
    rows.append({"case": name, "max_abs_err": err, "rtol": rtol,
                 "atol_x_row_max": atol, "worst_err_over_bound": ratio})
    if not ratio <= 1.0:
        emit({"phase": "kernels", "failed": rows[-1]})
        fail(f"kernel {name} disagrees with its plain version: "
             f"err / bound {ratio}")
    return err


def phase_kernels(torch, dev, card: str):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_prefill import ops as pp

    kb = KernelBench(torch, dev)
    b, hq, hkv, d, page = kb.b, kb.hq, kb.hkv, kb.d, kb.page
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    results = {}

    # ---------------------------------------------------------- decode
    for qdt, kvdt, mode in ((bf16, bf16, "plain"), (f32, f32, "plain"),
                            (bf16, bf16, "holes+partials"),
                            (f32, f32, "holes+partials"),
                            (bf16, torch.int8, "plain"),
                            (f32, torch.int8, "plain"),
                            (bf16, torch.float8_e4m3fn, "plain"),
                            (bf16, torch.float8_e4m3fn, "holes+partials")):
        kp, vp, ks, vs = kb.pages(kvdt)
        q = kb.q((b, hq, d), qdt)
        kw = dict(k_scale=ks, v_scale=vs)
        if mode != "plain":
            kw.update(page_positions=kb.holes(), partials=True)
        got = pa.paged_decode_attention(q, kp, vp, kb.bt, kb.positions, **kw)
        want = pa.paged_decode_attention_plain(q, kp, vp, kb.bt,
                                               kb.positions, **kw)
        torch.cuda.synchronize()
        name = f"decode {qdt} q, {kvdt} pages, {mode}"
        err = check(name, got, want, qdt, rows)
        if (qdt, kvdt, mode) == (bf16, bf16, "plain"):
            results["decode"] = dict(q=q, kp=kp, vp=vp, err=err)

    # ---------------------------------------------------------- prefill
    clen_for = {1: [1, 0, 1, 1, 1, 0, 1, 1],
                7: [7, 3, 0, 7, 1, 7, 5, 2],
                64: [64, 17, 0, 64, 33, 1, 64, 40]}
    start = torch.tensor([959, 0, 448, 0, 600, 63, 191, 900],
                         dtype=torch.int32, device=dev)
    for c, qdt, kvdt, mode in ((1, bf16, bf16, "plain"),
                               (7, bf16, bf16, "plain"),
                               (64, bf16, bf16, "plain"),
                               (64, f32, f32, "plain"),
                               (7, bf16, bf16, "holes+partials"),
                               (64, f32, f32, "holes+partials"),
                               (7, bf16, torch.int8, "plain"),
                               (64, f32, torch.int8, "plain"),
                               (7, bf16, torch.float8_e4m3fn, "plain"),
                               (7, f32, torch.float8_e4m3fn,
                                "holes+partials")):
        kp, vp, ks, vs = kb.pages(kvdt)
        clen = torch.tensor(clen_for[c], dtype=torch.int32, device=dev)
        q = kb.q((b, c, hq, d), qdt)
        kw = dict(k_scale=ks, v_scale=vs)
        if mode != "plain":
            kw.update(page_positions=kb.holes(), partials=True)
        got = pp.paged_prefill_attention(q, kp, vp, kb.bt, start, clen, **kw)
        want = pp.paged_prefill_attention_plain(q, kp, vp, kb.bt, start,
                                                clen, **kw)
        torch.cuda.synchronize()
        name = f"prefill c={c} {qdt} q, {kvdt} pages, {mode}"
        err = check(name, got, want, qdt, rows)
        if (c, qdt, kvdt, mode) == (64, bf16, bf16, "plain"):
            results["prefill"] = dict(q=q, kp=kp, vp=vp, clen=clen, err=err)
    emit({"phase": "kernels", "cases": rows})

    # ------------------------------------------- timing, main-path case
    elt = 2                                          # bf16 bytes
    # decode: live K/V of every row, q, out, the walked table entries
    live = (kb.positions.long() + 1)
    dec = results["decode"]
    dec_bytes = (2 * int(live.sum()) * hkv * d * elt + 2 * b * hq * d * elt
                 + 4 * int(((live + page - 1) // page).sum()) + 4 * b)
    dec_ops = 4 * hq * d * int(live.sum())
    timings = {}
    bt_l = kb.bt.long()
    S = kb.mp * page

    def sdpa_inputs(qq, c):
        k = dec["kp"][bt_l].reshape(b, S, hkv, d)
        v = dec["vp"][bt_l].reshape(b, S, hkv, d)
        k = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        v = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        return qq.reshape(b, c, hq, d).transpose(1, 2).contiguous(), k, v

    kv_pos = torch.arange(S, device=dev)
    qd, kd, vd = sdpa_inputs(dec["q"], 1)
    mask_d = (kv_pos[None, :] <= kb.positions[:, None].long())[:, None, None, :]
    timings["paged_decode_attention"] = dict(
        ms=time_ms(lambda: pa.paged_decode_attention(
            dec["q"], dec["kp"], dec["vp"], kb.bt, kb.positions), kb.flush),
        plain_ms=time_ms(lambda: pa.paged_decode_attention_plain(
            dec["q"], dec["kp"], dec["vp"], kb.bt, kb.positions), kb.flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask_d), kb.flush),
        bytes=dec_bytes, ops=dec_ops, max_abs_err=dec["err"])

    pre = results["prefill"]
    c = 64
    clen = pre["clen"].long()
    st = start.long()
    need = torch.where(clen > 0, st + clen, torch.zeros_like(st))
    vis = sum(int(st[i]) * int(clen[i]) + int(clen[i]) * (int(clen[i]) + 1) // 2
              for i in range(b))                     # visible (query, key) pairs
    pre_bytes = (2 * int(need.sum()) * hkv * d * elt + 2 * b * c * hq * d * elt
                 + 4 * int(((need + page - 1) // page).sum()) + 8 * b)
    pre_ops = 4 * hq * d * vis
    qp, kpp, vpp = sdpa_inputs(pre["q"], c)
    qpos = st[:, None] + torch.arange(c, device=dev)[None, :]
    mask_p = ((kv_pos[None, None, :] <= qpos[:, :, None])
              & (torch.arange(c, device=dev)[None, :, None]
                 < clen[:, None, None]))[:, None]
    timings["paged_prefill_attention"] = dict(
        ms=time_ms(lambda: pp.paged_prefill_attention(
            pre["q"], pre["kp"], pre["vp"], kb.bt, start, pre["clen"]),
            kb.flush),
        plain_ms=time_ms(lambda: pp.paged_prefill_attention_plain(
            pre["q"], pre["kp"], pre["vp"], kb.bt, start, pre["clen"]),
            kb.flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qp, kpp, vpp, attn_mask=mask_p), kb.flush),
        bytes=pre_bytes, ops=pre_ops, max_abs_err=pre["err"])
    for name, t in timings.items():
        t["bound_ms"] = 1e3 * max(t["bytes"] / HBM_BYTES_PER_S,
                                  t["ops"] / PEAK_OPS["bfloat16"])
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / PEAK_OPS["bfloat16"] else "operations")
    emit({"phase": "kernel_times", "card": card, "dtype": "bfloat16",
          "shapes": {"b": b, "hq": hq, "hkv": hkv, "d": d, "page": page,
                     "max_pages": kb.mp, "prefill_c": c},
          "timing": "CUDA events, median of 30 after 5 warm-up, L2 flushed",
          **{k: {kk: vv for kk, vv in v.items()} for k, v in timings.items()}})
    return timings


# ------------------------------------------- phase 3: moe/ssd kernels

def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) on this card's bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def routed_rows(torch, E: int, tokens: int, k: int, gen):
    """Per-expert row counts of `tokens` tokens each routed to k distinct
    experts uniformly at random (the dropless dispatch's counts)."""
    choice = torch.rand(tokens, E, generator=gen).argsort(-1)[:, :k]
    return torch.bincount(choice.reshape(-1), minlength=E).to(torch.int32)


def phase_moe_ssd_kernels(torch, dev, card: str, flush):
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tolerance import worst_ratio

    gen = torch.Generator(device="cpu").manual_seed(5)
    gdev = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    rows_out, times = [], {}

    def hold(name, got, want, tol):
        err, ratio = worst_ratio(got, want, *tol)
        rows_out.append({"case": name, "max_abs_err": err, "rtol": tol[0],
                         "atol_x_row_max": tol[1],
                         "worst_err_over_bound": ratio})
        if not ratio <= 1.0:
            emit({"phase": "moe_ssd_kernels", "failed": rows_out[-1]})
            fail(f"kernel {name} disagrees with its plain version: "
                 f"err / bound {ratio}")
        return err

    # ---------------------------------------------------- grouped matmul
    E, k, D, FF = 128, 8, 2048, 768
    for C, K, F in ((64, D, FF), (64, FF, D), (4096, D, FF)):
        rows = routed_rows(torch, E, C // k, k, gen).to(dev)
        live = (torch.arange(C, device=dev)[None, :]
                < rows[:, None].long())[..., None]
        x32 = torch.randn(E, C, K, generator=gdev, device=dev) * live
        w32 = torch.randn(E, K, F, generator=gdev, device=dev) * 0.02
        for dt in (bf16, f32):
            x, w = x32.to(dt), w32.to(dt)
            for r in (rows, None):
                got = gm.grouped_matmul(x, w, r)
                want = gm.grouped_matmul_plain(x, w, r)
                torch.cuda.synchronize()
                name = (f"grouped E{E} C{C} K{K} F{F} {dt} "
                        f"{'rows' if r is not None else 'all rows'}")
                err = hold(name, got, want, gm.TOLERANCE[dt])
                del got, want
                if dt is not bf16 or r is None or K != D:
                    continue
                # timed: bf16 with the routing's live rows, gate shape
                n_live = int(rows.sum())
                experts = int((rows > 0).sum())
                nbytes = 2 * experts * K * F + 2 * n_live * K + 4 * n_live * F
                ms, by = bound(nbytes, 2 * n_live * K * F)
                rr = r
                times[f"grouped_matmul C{C}"] = dict(
                    ms=time_ms(lambda: gm.grouped_matmul(x, w, rr), flush),
                    plain_ms=time_ms(lambda: gm.grouped_matmul_plain(x, w, rr),
                                     flush, iters=10),
                    library_ms=time_ms(lambda: torch.bmm(x, w), flush),
                    bound_ms=ms, bound_by=by, max_abs_err=err,
                    live_rows=n_live, live_experts=experts)
            del x, w
    # ------------------------------------------------------------- SSD
    bh, p, n = 8 * 80, 64, 64
    for l in (64, 256):
        x32 = torch.randn(bh, 1, l, p, generator=gdev, device=dev)
        B32 = torch.randn(bh, 1, l, n, generator=gdev, device=dev) * 0.3
        C32 = torch.randn(bh, 1, l, n, generator=gdev, device=dev) * 0.3
        dt_ = torch.rand(bh, 1, l, generator=gdev, device=dev) * 0.1
        A = (-torch.linspace(1.0, 16.0, 80, device=dev)).repeat(8)
        for dt in (bf16, f32):
            args = (x32.to(dt), dt_, A, B32.to(dt), C32.to(dt))
            got = ssd.ssd_intra_chunk(*args)
            want = ssd.ssd_intra_chunk_plain(*args)
            torch.cuda.synchronize()
            errs = [hold(f"ssd bh{bh} l{l} p{p} n{n} {dt} {part}", g, w_,
                         ssd.TOLERANCE[dt])
                    for part, g, w_ in zip(("y", "s", "cd"), got, want)]
            if dt is not bf16:
                continue
            # x, B, C in bf16, dt and A in f32 in; y, s, cd in f32 out
            nbytes = (2 * bh * l * (p + 2 * n) + 4 * (bh * l + bh)
                      + 4 * (bh * l * p + bh * n * p + bh))
            pairs = l * (l + 1) // 2
            ops = bh * (2 * pairs * (n + p) + 2 * l * n * p)
            ms, by = bound(nbytes, ops)
            times[f"ssd_intra_chunk l{l}"] = dict(
                ms=time_ms(lambda: ssd.ssd_intra_chunk(*args), flush),
                plain_ms=time_ms(lambda: ssd.ssd_intra_chunk_plain(*args),
                                 flush),
                library_ms=None, bound_ms=ms, bound_by=by,
                max_abs_err=max(errs))
    emit({"phase": "moe_ssd_kernels", "cases": rows_out})
    emit({"phase": "moe_ssd_kernel_times", "card": card, "dtype": "bfloat16",
          "shapes": {"grouped": {"E": E, "top_k": k, "d_model": D,
                                 "moe_d_ff": FF},
                     "ssd": {"bh": bh, "p": p, "n": n}},
          "library": {"grouped": "one torch.bmm over the same (E, C, K) and "
                                 "(E, K, F), every row",
                      "ssd": "none: no single PyTorch call computes it"},
          "timing": "CUDA events, median of 30 (plain grouped: 10) after 5 "
                    "warm-up, L2 flushed", **times})
    return times


# ------------------------------------------------------- phase 3: serve

PROMPT_LENS = (5, 17, 64, 100, 128, 200, 333, 511)
SAMPLED = 3                 # the 100-token prompt samples
FORKED = 7                  # the 511-token prompt's stream is forked


def serve_once(torch, dev, cfg, params, prompts):
    from repro_torch.serve.api import LLMServer
    from repro_torch.serve.engine import TokenEvent
    from repro_torch.serve.sampling import SamplingParams

    server = LLMServer(cfg, params, device=dev, max_batch=8,
                       max_seq=1024, page_size=16)
    eng = server.engine
    steps = {"prefill": [0.0, 0.0], "decode": [0.0, 0.0]}

    def timed(fn, acc):
        """fn, adding its host enqueue time and its time to the card's
        finish (the sync the engine's token read would make anyway)."""
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            t1 = time.perf_counter()
            torch.cuda.synchronize(dev)
            acc[0] += t1 - t0
            acc[1] += time.perf_counter() - t0
            return out
        return run

    eng.prefill_fn = timed(eng.prefill_fn, steps["prefill"])
    eng.decode_fn = timed(eng.decode_fn, steps["decode"])
    streams = []
    for i, p in enumerate(prompts):
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=7,
                             max_new_tokens=32) if i == SAMPLED
              else SamplingParams(max_new_tokens=32))
        streams.append(server.generate(p, sp))
    t0 = time.perf_counter()
    ttft = {}
    live = list(streams)
    forked = None
    while live:
        for s in list(live):
            ev = next(s, None)
            if ev is None:
                live.remove(s)
                continue
            if isinstance(ev, TokenEvent) and s.uid not in ttft:
                ttft[s.uid] = time.perf_counter() - t0
            if (forked is None and s is streams[FORKED] and s.tokens
                    and not s.finished and len(eng.slots) < eng.max_batch):
                forked = s.fork()
                streams.append(forked)
                live.append(forked)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return server, streams, forked, ttft, wall, steps


def kernel_modules():
    """name -> the wrapper module whose `launches` counts that kernel."""
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_prefill import ops as pp
    from repro_torch.kernels.ssd_scan import ops as ssd
    return {"paged_decode_attention": pa, "paged_prefill_attention": pp,
            "grouped_matmul": gm, "ssd_intra_chunk": ssd}


def expected_launches(cfg, st) -> dict:
    """Kernel launches one served run must make: each step call launches
    each paged kernel once per attention layer (dense and MoE: every
    layer; hybrid: every shared-block application), the grouped matmul
    3 times per MoE layer, the SSD kernel once per Mamba layer of a
    prefill call."""
    pre, dec = st["prefill_calls"], st["decode_calls"]
    attn = (cfg.num_layers // cfg.shared_attn_period
            if cfg.family == "hybrid" else cfg.num_layers)
    return {"paged_decode_attention": dec * attn,
            "paged_prefill_attention": pre * attn,
            "grouped_matmul": (3 * cfg.num_layers * (pre + dec)
                               if cfg.family == "moe" else 0),
            "ssd_intra_chunk": (cfg.num_layers * pre
                                if cfg.family == "hybrid" else 0)}


def free_card(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(torch, dev, card: str, phase: str, cfg, twins=False):
    """Serve the 8 prompts (+ one fork) twice on `cfg` at full width and
    depth; with `twins` the 333-token prompt is replaced by a copy of
    the 200-token one, so identical prompts co-prefill.  Returns the
    launches of the first run."""
    import numpy as np
    from repro_torch.models import registry

    free_card(torch)
    t0 = time.perf_counter()
    params = registry.get_family(cfg).init(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    if twins:
        prompts[6] = prompts[5].copy()
    mods = kernel_modules()

    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():                          # count the main path
        m.launches = 0
    server, streams, forked, ttft, wall, steps = serve_once(
        torch, dev, cfg, params, prompts)
    launches = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    st = server.stats
    if forked is None:
        fail("the fork never happened (no free slot while its parent decoded)")
    for s in streams:
        if s.result is None or not s.finished:
            fail(f"stream {s.uid} did not finish")
        toks = s.result.tokens
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"stream {s.uid}: bad tokens {toks}")
    if st["pool"]["allocated_pages"] != 0:
        fail(f"{st['pool']['allocated_pages']} pages leaked")
    want = expected_launches(cfg, st)
    if launches != want:
        fail(f"{phase}: kernel launches {launches} != expected {want}")
    if twins:
        # per-slot-state families share pages but recompute every token
        if st["prefill_tokens"] != sum(len(p) for p in prompts):
            fail(f"prefill computed {st['prefill_tokens']} prompt tokens, "
                 f"not all {sum(len(p) for p in prompts)}")
        if streams[5].result.tokens != streams[6].result.tokens:
            fail("identical greedy prompts gave different streams")
    first = {s.uid: s.result.tokens for s in streams}
    n_streams = len(streams)
    del server, streams, forked                      # free the first arena
    free_card(torch)

    _, streams2, _, _, wall2, _ = serve_once(torch, dev, cfg, params,
                                             prompts)
    if first != {s.uid: s.result.tokens for s in streams2}:
        fail("rerun streams differ")
    tokens = st["tokens_out"]
    emit({"phase": phase, "card": card, "arch": cfg.name,
          "layers": cfg.num_layers, "dtype": cfg.dtype,
          "moe_dispatch": cfg.moe_dispatch, "ssd_impl": cfg.ssd_impl,
          "params_init_s": init_s,
          "streams": n_streams, "tokens_out": tokens,
          "prefill_tokens": st["prefill_tokens"],
          "prefill_calls": st["prefill_calls"],
          "decode_calls": st["decode_calls"], "launches": launches,
          "peak_kv_bytes": st["peak_kv_bytes"],
          "peak_allocated_pages": st["pool"]["peak_allocated_pages"],
          "prefix_store": st["prefix_store"],
          "max_memory_allocated": peak,
          "wall_s": wall, "tokens_per_s": tokens / wall,
          "rerun_wall_s": wall2, "rerun_tokens_per_s": tokens / wall2,
          "ttft_s": {str(k): v for k, v in sorted(ttft.items())},
          # per step kind: host seconds to enqueue the calls, and seconds
          # until the card finished them; the rest of wall_s is the
          # engine's host work between calls
          "step_s": {k: {"enqueue_s": v[0], "call_s": v[1]}
                     for k, v in steps.items()},
          "between_calls_s": wall - sum(v[1] for v in steps.values()),
          "rerun_identical": True, "leaked_pages": 0})
    return launches


# ----------------------------------------------------- phase 4: parity

def phase_parity(torch, dev):
    from repro_torch.configs import get_arch
    from repro_torch.kernels.tolerance import worst_ratio
    from repro_torch.models import transformer

    cfg = get_arch("internlm2-1.8b").model.replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    params = transformer.init(1, cfg, dev)

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    cpu = torch.device("cpu")
    params_cpu = to(params, cpu)
    page, P, mp, b, c = 16, 32, 8, 4, 16
    g = torch.Generator().manual_seed(3)
    bt = torch.full((b, mp), P, dtype=torch.int32)
    perm = torch.randperm(P, generator=g).to(torch.int32)
    for i, n in enumerate((2, 1, 3, 0)):
        bt[i, :n] = perm[4 * i:4 * i + n]
    start = torch.tensor([0, 0, 16, 0], dtype=torch.int32)
    clen = torch.tensor([16, 9, 5, 0], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (b, c), generator=g,
                           dtype=torch.int32)
    positions = torch.tensor([16, 9, 21, 0], dtype=torch.int32)
    dec_tokens = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                               dtype=torch.int32)
    out = []
    for where, p in ((dev, params), (cpu, params_cpu)):
        arena = transformer.init_paged_cache(cfg, P + 1, page, device=where)
        with torch.inference_mode():
            arena, lp = transformer.paged_prefill(
                p, cfg, {"tokens": tokens.to(where)}, arena, bt.to(where),
                start.to(where), clen.to(where))
            arena, ld = transformer.paged_decode_step(
                p, cfg, arena, bt.to(where), positions.to(where),
                dec_tokens.to(where))
        out.append((lp.cpu(), ld.cpu(),
                    {k: v[:, :P].cpu() for k, v in arena.items()}))
    (lp_g, ld_g, ar_g), (lp_c, ld_c, ar_c) = out
    rows = clen > 0          # inert rows' logits are garbage by contract
    act = positions > 0
    # f32 products of widths 2048 and 8192, summed in another order on
    # each side; per element along each row, as for the kernels
    rtol, atol = 1e-3, 1e-3
    res = {"prefill_logits": worst_ratio(lp_g[rows], lp_c[rows], rtol, atol),
           "decode_logits": worst_ratio(ld_g[act], ld_c[act], rtol, atol),
           **{f"arena_{k}": worst_ratio(ar_g[k], ar_c[k], rtol, atol)
              for k in ar_c}}
    emit({"phase": "parity", "config": "internlm2-1.8b width, 2 layers, f32",
          "rtol": rtol, "atol_x_row_max": atol,
          "max_abs_err": {k: v[0] for k, v in res.items()},
          "worst_err_over_bound": {k: v[1] for k, v in res.items()}})
    for k, (e, r) in res.items():
        if not r <= 1.0:
            fail(f"card vs CPU {k}: err {e}, err / bound {r}")


def phase_parity_family(torch, dev, cfg, label: str):
    """One paged prefill chunk from position 0, a second continuing one
    row (the other inert), and one decode step, on the card and on the
    CPU; logits, pages and per-slot state held by the per-element rule."""
    from repro_torch.kernels.tolerance import worst_ratio
    from repro_torch.models import registry

    fam = registry.get_family(cfg)
    free_card(torch)
    params = fam.init(1, cfg, dev)
    cpu = torch.device("cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    params_cpu = to(params, cpu)
    page, P, mp, b, c = 16, 8, 4, 2, 8
    g = torch.Generator().manual_seed(4)
    bt = torch.full((b, mp), P, dtype=torch.int32)
    bt[0, :2] = torch.tensor([3, 6], dtype=torch.int32)
    bt[1, :1] = torch.tensor([1], dtype=torch.int32)
    chunks = [(torch.tensor([0, 0], dtype=torch.int32),
               torch.tensor([8, 5], dtype=torch.int32)),
              (torch.tensor([8, 5], dtype=torch.int32),
               torch.tensor([8, 0], dtype=torch.int32))]
    tokens = [torch.randint(0, cfg.vocab_size, (b, c), generator=g,
                            dtype=torch.int32) for _ in chunks]
    positions = torch.tensor([16, 5], dtype=torch.int32)
    dec_tokens = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                               dtype=torch.int32)
    out = []
    for where, prm in ((dev, params), (cpu, params_cpu)):
        arena = fam.init_paged_cache(cfg, P + 1, page, max_batch=b,
                                     device=where)
        logits = []
        with torch.inference_mode():
            for (start, clen), tok in zip(chunks, tokens):
                arena, lg = fam.paged_prefill(
                    prm, cfg, {"tokens": tok.to(where)}, arena, bt.to(where),
                    start.to(where), clen.to(where))
                logits.append(lg.cpu()[clen > 0])
            arena, ld = fam.paged_decode_step(
                prm, cfg, arena, bt.to(where), positions.to(where),
                dec_tokens.to(where))
            logits.append(ld.cpu())
        out.append((logits, {k: (v[:, :P] if k in ("k", "v") else v).cpu()
                             for k, v in arena.items()}))
    del params, params_cpu
    (lg_g, ar_g), (lg_c, ar_c) = out
    # An SSM state row (one head's channel p over its n state entries)
    # is sum_j w_j x_j[p] B_j: where x[p] is near zero the row is tiny,
    # while the error x_j[p] carries from the projection feeding it is
    # on the scale of the whole head.  So the ssm leaf's "row" is each
    # head's (p, n) state, flattened.
    for ar in (ar_g, ar_c):
        if "ssm" in ar:
            ar["ssm"] = ar["ssm"].flatten(-2)
    rtol, atol = 1e-3, 1e-3
    res = {**{f"logits_{i}": worst_ratio(a, b_, rtol, atol)
              for i, (a, b_) in enumerate(zip(lg_g, lg_c))},
           **{f"arena_{k}": worst_ratio(ar_g[k], ar_c[k], rtol, atol)
              for k in ar_c}}
    emit({"phase": "parity", "config": label,
          "rtol": rtol, "atol_x_row_max": atol,
          "max_abs_err": {k: v[0] for k, v in res.items()},
          "worst_err_over_bound": {k: v[1] for k, v in res.items()}})
    for k, (e, r) in res.items():
        if not r <= 1.0:
            fail(f"{label}: card vs CPU {k}: err {e}, err / bound {r}")


# --------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = kbuild.library()
    ptxas = [ln.strip() for ln in lib.compiler_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.path.relative_to(ROOT)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "ptxas": ptxas})

    timings = phase_kernels(torch, dev, card)
    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    timings.update(phase_moe_ssd_kernels(torch, dev, card, flush_buf.zero_))
    del flush_buf
    dense = get_arch("internlm2-1.8b").model
    moe = get_arch("qwen3-moe-30b-a3b").model.replace(moe_dispatch="grouped")
    hybrid = get_arch("zamba2-2.7b").model.replace(ssd_impl="pallas")
    launches = phase_serve(torch, dev, card, "serve", dense)
    moe_launches = phase_serve(torch, dev, card, "serve_moe", moe)
    hybrid_launches = phase_serve(torch, dev, card, "serve_hybrid", hybrid,
                                  twins=True)
    phase_parity(torch, dev)
    f32 = dict(dtype="float32", param_dtype="float32")
    phase_parity_family(torch, dev, moe.replace(num_layers=2, **f32),
                        "qwen3-moe-30b-a3b width, 2 layers, f32")
    phase_parity_family(
        torch, dev,
        hybrid.replace(num_layers=2 * hybrid.shared_attn_period, **f32),
        "zamba2-2.7b width, 12 layers (2 shared applications), f32")

    # each kernel's launches come from the served run of its family
    launches["grouped_matmul"] = moe_launches["grouped_matmul"]
    launches["ssd_intra_chunk"] = hybrid_launches["ssd_intra_chunk"]
    main_case = {"grouped_matmul": "grouped_matmul C64",
                 "ssd_intra_chunk": "ssd_intra_chunk l64"}
    sources = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:245"),
        "paged_prefill_attention": (
            "src/repro_torch/kernels/csrc/paged_prefill.cu",
            "src/repro/kernels/paged_prefill/kernel.py:90"),
        "grouped_matmul": (
            "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "src/repro/kernels/grouped_matmul/kernel.py:36"),
        "ssd_intra_chunk": (
            "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan/kernel.py:55")}
    rows = []
    for name, (src, rep) in sources.items():
        t = timings[main_case.get(name, name)]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
