"""The port's network front (`repro_torch.serve.frontend`) and tenant
budget shares, held against the JAX reference on the CPU.

- Protocol: `Submit`/`parse_submit` on seeded bodies and every rejection
  of the reference's tests, `sse_encode`'s bytes, `SSEDecoder` under
  seeded chunkings and the HTTP helpers give the reference's results.
- Tenants: `TenantScheduler.allocate`/`fair_shares` over seeded demands
  equal the reference's; the reference's two law tests hold.
- Engine: on TINY dense with `tenant_weights` and `tick_token_budget`
  16, the port's event streams, finish steps and `stats()["tenants"]`
  equal the reference engine's (paged, speculative, host tier,
  contiguous), and so do the three legacy fields (`Request.eos_token`,
  `Request.tenant`, `ServingEngine(temperature=)`).  Each scenario runs
  the reference once, in a module-scoped fixture.
- Over the wire: the port's server and client against the reference
  engine's in-process streams (concurrent greedy and sampled clients,
  disconnect, cancel, rejection, fanout, speculation with the prefix
  cache), mirroring the reference's `tests/test_frontend.py`.
- Cross-wire: the reference's client reads the port's server and the
  port's client the reference's; the bytes on the wire are the same.
- Tools: `parse_tenant_budget`, `traffic_gen.build_trace` and one CPU
  `traffic_gen.run` at the reference's defaults.
"""
from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import jax

from conftest import TINY
from repro.launch.serve import parse_tenant_budget as jax_parse_budget
from repro.models import registry as jax_registry
from repro.serve import engine as jax_engine
from repro.serve import serve_step as jax_serve_step
from repro.serve.api import LLMServer as JaxServer
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.frontend import FrontendServer as JaxFront
from repro.serve.frontend import ServeClient as JaxClient
from repro.serve.frontend import TenantScheduler as JaxTenants
from repro.serve.frontend import collect as jax_collect
from repro.serve.frontend import protocol as jax_protocol
from repro.serve.sampling import SamplingParams as JaxSP
from repro_torch.benchmarks import traffic_gen
from repro_torch.launch.serve import parse_tenant_budget
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.frontend import (FrontendServer, ProtocolError,
                                        SSEDecoder, ServeClient, Submit,
                                        TenantScheduler, collect,
                                        parse_submit, sse_encode)
from repro_torch.serve.frontend import protocol
from repro_torch.serve.sampling import SamplingParams
from test_torch_serve import _events
from torch_port_helpers import port_cfg, port_params
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

CFG = TINY["dense"]
WEIGHTS = {"alpha": 3.0, "beta": 1.0}
FRONT_KW = dict(max_batch=4, max_seq=64, page_size=16)

_REF_FNS: dict = {}


def _shared_ref_fns(cfg):
    """The reference's jitted paged step closures depend on the config
    only: every reference engine of this module shares them."""
    if cfg not in _REF_FNS:
        _REF_FNS[cfg] = jax_serve_step.make_paged_serve_fns(cfg)
    return _REF_FNS[cfg]


@pytest.fixture(scope="module", autouse=True)
def _ref_fns_shared():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "make_paged_serve_fns", _shared_ref_fns)
        yield


@pytest.fixture(scope="module")
def dense():
    init = jax_registry.get_family(CFG).init
    jp = jax.jit(lambda key: init(key, CFG))(jax.random.key(0))
    return jp, port_params(jp, CFG)


# ---------------------------------------------------------------- protocol

def _random_params(rng) -> dict:
    kw = {}
    if rng.random() < 0.7:
        kw["temperature"] = float(rng.choice([0.0, 0.5, 0.8, 1.3]))
    if rng.random() < 0.5:
        kw["top_k"] = int(rng.integers(0, 40))
    if rng.random() < 0.5:
        kw["top_p"] = float(rng.choice([1.0, 0.9, 0.5]))
    if rng.random() < 0.7:
        kw["seed"] = int(rng.integers(1 << 30))
    if rng.random() < 0.7:
        kw["max_new_tokens"] = int(rng.integers(1, 64))
    if rng.random() < 0.4:
        kw["stop"] = [int(t) for t in rng.integers(0, 128, 3)]
    if rng.random() < 0.3:
        kw["speculative"] = bool(rng.random() < 0.5)
    return kw


def _random_body(rng) -> dict:
    body = {"prompt": [int(t) for t in
                       rng.integers(0, 50_000, int(rng.integers(1, 40)))]}
    if rng.random() < 0.7:
        body["tenant"] = str(rng.choice(["alpha", "beta", "t-9", "x" * 256]))
    if rng.random() < 0.8:
        body["params"] = _random_params(rng)
    if rng.random() < 0.5:
        body["fanout"] = [_random_params(rng)
                          for _ in range(int(rng.integers(0, 9)))]
    return body


@pytest.mark.parametrize("seed", range(4))
def test_submit_bodies_parse_as_the_reference_parses_them(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        body = _random_body(rng)
        got, want = parse_submit(body), jax_protocol.parse_submit(body)
        assert got.to_wire() == want.to_wire()
        assert got.prompt.dtype == want.prompt.dtype == np.int32
        assert got.tenant == want.tenant
        back = parse_submit(got.to_wire())
        assert back.to_wire() == got.to_wire()
        # the port's Submit, built directly, ships the reference's body
        sub = Submit(prompt=got.prompt, tenant=got.tenant,
                     params=got.params, fanout=got.fanout)
        ref = jax_protocol.Submit(prompt=want.prompt, tenant=want.tenant,
                                  params=want.params, fanout=want.fanout)
        assert sub.to_wire() == ref.to_wire()


@pytest.mark.parametrize("body", [
    [1, 2],                                        # not an object
    {"prompt": []},                                # empty prompt
    {"prompt": [1, True]},                         # bool is not a token
    {"prompt": [1], "nope": 1},                    # unknown field
    {"prompt": [1], "params": {"frobnicate": 1}},  # unknown knob
    {"prompt": [1], "fanout": [{}] * 9},           # fanout cap
    {"prompt": [1], "params": {"top_p": 0.0}},     # invalid value
    {"prompt": [1], "fanout": [{"temperature": -1.0}]},
    {"prompt": [1], "params": [0.5]},              # params not an object
    {"prompt": [1], "tenant": ""},
    {"prompt": [1], "tenant": 7},
    {"prompt": [1], "tenant": "x" * 257},
    {"prompt": "1 2 3"},
    {"prompt": [1.5]},
], ids=lambda b: repr(b)[:40])
def test_parse_submit_rejects_as_the_reference(body):
    with pytest.raises(jax_protocol.ProtocolError) as want:
        jax_protocol.parse_submit(body)
    with pytest.raises(ProtocolError) as got:
        parse_submit(body)
    assert (got.value.code, got.value.message) == (want.value.code,
                                                   want.value.message)


def _random_frames(rng, n=12):
    frames = []
    for i in range(n):
        kind = rng.choice(["start", "token", "finish", "error"])
        if kind == "start":
            data = {"uid": int(rng.integers(1000)), "sid": 0,
                    "tenant": "alpha", "schema": 1}
        elif kind == "token":
            data = {"sid": int(rng.integers(3)),
                    "t": np.int32(rng.integers(50_000)), "i": i}
        elif kind == "finish":
            data = {"sid": 1, "reason": "length",
                    "tokens": [int(t) for t in rng.integers(0, 99, 5)],
                    "prompt_len": np.int64(17)}
        else:
            data = {"sid": None, "code": "engine_error",
                    "message": "tick failed: é\n"}
        frames.append((str(kind), data))
    return frames


@pytest.mark.parametrize("seed", range(4))
def test_sse_bytes_and_decoding_match_the_reference(seed):
    """`sse_encode` writes the reference's bytes (numpy ints included);
    both decoders give the same frames under the same seeded chunkings,
    with \\r\\n line endings and comment lines too."""
    rng = np.random.default_rng(seed)
    frames = _random_frames(rng)
    wire = b"".join(sse_encode(e, d) for e, d in frames)
    assert wire == b"".join(jax_protocol.sse_encode(e, d) for e, d in frames)
    crlf = b": heartbeat\r\n\r\n" + wire.replace(b"\n", b"\r\n")
    for blob in (wire, crlf):
        cuts = np.sort(rng.choice(np.arange(1, len(blob)),
                                  size=min(20, len(blob) - 1),
                                  replace=False))
        pieces = np.split(np.frombuffer(blob, np.uint8), cuts)
        got_dec, want_dec = SSEDecoder(), jax_protocol.SSEDecoder()
        got, want = [], []
        for p in pieces:
            got.extend(got_dec.feed(p.tobytes()))
            want.extend(want_dec.feed(p.tobytes()))
        assert got == want
        assert [e for e, _ in got] == [e for e, _ in frames]
    bad = b"event: token\ndata: {nope\n\n"
    with pytest.raises(ProtocolError) as ei:
        SSEDecoder().feed(bad)
    assert ei.value.code == "bad_frame"


def test_http_framing_matches_the_reference():
    for args in ((200, "OK", "text/plain", b"hi"),
                 (404, "Not Found", "application/json", b"{}")):
        for kw in ({}, {"close": False}, {"stream": True}):
            assert (protocol.http_response(*args, **kw)
                    == jax_protocol.http_response(*args, **kw))
    obj = {"code": "x", "n": 3, "f": 0.5}
    assert (protocol.json_response(400, "Bad Request", obj)
            == jax_protocol.json_response(400, "Bad Request", obj))
    assert protocol.sse_response_head() == jax_protocol.sse_response_head()

    raws = [b"POST /v1/generate HTTP/1.1\r\nHost: h\r\nContent-Length: 2"
            b"\r\n\r\n{}",
            b"GET /v1/stats HTTP/1.1\r\nX-A:  b \r\n\r\n",
            b"BROKEN\r\n\r\n",
            b"POST / HTTP/1.1\r\nContent-Length: -3\r\n\r\n",
            b"POST / HTTP/1.1\r\nHost",
            b""]

    async def parse(mod, raw):
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        try:
            req = await mod.read_http_request(reader)
        except (ProtocolError, jax_protocol.ProtocolError) as e:
            return ("error", e.code, e.message)
        return req and (req.method, req.path, req.headers, req.body)

    for raw in raws:
        assert (asyncio.run(parse(protocol, raw))
                == asyncio.run(parse(jax_protocol, raw)))


# ----------------------------------------------------------- tenant shares

@pytest.mark.parametrize("seed", range(4))
def test_tenant_allocation_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    names = ["alpha", "beta", "gamma", "delta"]
    weights = {t: float(rng.choice([0.1, 0.5, 1.0, 3.0, 10.0]))
               for t in names[:int(rng.integers(0, 4))]}
    got, want = TenantScheduler(weights), JaxTenants(weights)
    for _ in range(60):
        demands = {t: int(rng.integers(0, 40)) for t in names
                   if rng.random() < 0.7}
        budget = int(rng.integers(0, 64))
        kind = str(rng.choice(["", "prefill", "decode"]))
        assert got.fair_shares(budget, demands) == \
            want.fair_shares(budget, demands)
        assert got.allocate(budget, demands, kind=kind) == \
            want.allocate(budget, demands, kind=kind)
    assert got.stats() == want.stats()
    assert got._credit == want._credit


def _law_weighted_maxmin(ts):
    # saturated: grants split 3:1
    assert ts.allocate(16, {"a": 100, "b": 100}) == {"a": 12, "b": 4}
    # max-min: a small demand is fully met, the surplus flows on
    got = ts.allocate(16, {"a": 2, "b": 100})
    assert got["a"] == 2 and got["b"] == 14
    # unnamed tenants default to weight 1
    got = ts.allocate(8, {"b": 100, "ghost": 100})
    assert got["b"] + got["ghost"] == 8


def _law_starvation_free(ts):
    small_total = sum(ts.allocate(4, {"big": 100, "small": 100})["small"]
                      for _ in range(200))
    assert small_total > 0
    assert small_total == pytest.approx(800 * 0.1 / 10.1, rel=0.5)


@pytest.mark.parametrize("law, weights", [
    (_law_weighted_maxmin, {"a": 3.0, "b": 1.0}),
    (_law_starvation_free, {"big": 10.0, "small": 0.1})],
    ids=["weighted_maxmin", "starvation_free"])
def test_tenant_laws_of_the_reference(law, weights):
    law(TenantScheduler(weights))
    with pytest.raises(ValueError):
        TenantScheduler({"a": 0.0})
    with pytest.raises(ValueError):
        TenantScheduler(default_weight=-1.0)


# ------------------------------------------------------------------ engine

def _saturation(kw_sampling):
    """The reference's engine-level saturation scenario: 8 requests,
    alternating tenants, 16-token prompts, 12 new tokens."""
    rng = np.random.default_rng(0)
    return [dict(uid=uid, prompt=rng.integers(1, CFG.vocab_size, 16)
                 .astype(np.int32),
                 tenant="alpha" if uid % 2 == 0 else "beta",
                 sampling=kw_sampling(uid)) for uid in range(8)]


def _mixed(n=10, seed=3):
    """Ragged prompts over three tenants (one unnamed: weight 1)."""
    rng = np.random.default_rng(seed)
    return [dict(uid=uid, prompt=rng.integers(
        1, CFG.vocab_size, int(rng.integers(5, 30))).astype(np.int32),
        tenant=("alpha", "beta", "gamma")[uid % 3],
        sampling=dict(max_new_tokens=int(rng.integers(4, 14)),
                      temperature=0.8 if uid % 4 == 1 else 0.0,
                      top_k=16, seed=uid)) for uid in range(n)]


def _scenario(name):
    """(engine kwargs, requests, legacy eos probe): requests are dicts of
    Request fields, `sampling` as SamplingParams keywords or None."""
    kw = dict(FRONT_KW, tick_token_budget=16, tenant_weights=WEIGHTS)
    if name == "saturation":
        return kw, _saturation(lambda uid: dict(
            max_new_tokens=12, temperature=0.8 if uid % 3 == 0 else 0.0,
            seed=uid))
    if name == "speculative":
        kw.update(speculate_k=2, draft="self:1")
        reqs = _saturation(lambda uid: dict(
            max_new_tokens=12, temperature=0.8 if uid % 3 == 0 else 0.0,
            seed=uid, speculative=uid != 5))
        return kw, reqs
    if name == "mixed":
        return kw, _mixed()
    if name == "tier":
        # a small pool under a watermark: slots preempt, spill to the
        # host tier and are restored in the tenants' admission order
        kw.update(page_size=8, pool_pages=16, prefill_chunk=8,
                  high_watermark=0.75, host_tier_pages=64)
        return kw, _mixed(8, seed=5)
    if name == "contiguous":
        kw.update(layout="contiguous")
        return kw, _mixed(8, seed=7)
    if name == "legacy":
        # no tenants: requests without params take the engine's default
        # temperature; eos_token joins the stop set with and without
        # params (the eos of uids 1 and 3 is a token their stream emits)
        kw = dict(FRONT_KW, temperature=0.8)
        rng = np.random.default_rng(11)
        reqs = []
        for uid in range(5):
            reqs.append(dict(
                uid=uid, max_new_tokens=10,
                prompt=rng.integers(1, CFG.vocab_size, 9 + 3 * uid)
                .astype(np.int32),
                sampling=(dict(max_new_tokens=10, seed=40 + uid)
                          if uid in (2, 3) else None)))
        return kw, reqs
    raise ValueError(name)


SCENARIOS = ("saturation", "speculative", "mixed", "tier", "contiguous",
             "legacy")


def _run_engine(engine, request_cls, sp_cls, reqs, eos):
    for r in reqs:
        r = dict(r)
        if r["sampling"] is not None:
            r["sampling"] = sp_cls(**r["sampling"])
        if r["uid"] in eos:
            r["eos_token"] = eos[r["uid"]]
        engine.submit(request_cls(**r))
    log, finish_step, step = [], {}, 0
    while engine.pending or engine.slots:
        engine.step()
        step += 1
        for ev in _events(engine.events()):
            log.append(ev)
            if ev[0] == "finish":
                finish_step[ev[1]] = step
        assert step < 500
    st = engine.stats()
    stats = {k: st.get(k) for k in ("tenants", "steps", "tokens_out",
                                    "prefill_tokens", "admitted",
                                    "preemptions", "prefill_decode_ratio",
                                    "host_tier", "speculative")}
    stats["pool"] = {k: st["pool"][k] for k in ("allocated_pages",
                                                "peak_allocated_pages")}
    return log, finish_step, stats


def _legacy_eos(pp):
    """An emitted token for uids 1 and 3 to stop at: the port's own run
    without eos (its streams are the reference's, held below)."""
    kw, reqs = _scenario("legacy")
    eng = ServingEngine(port_cfg(CFG), pp, device="cpu", **kw)
    log, _, _ = _run_engine(eng, Request, SamplingParams, reqs, {})
    toks = {e[1]: e[3] for e in log if e[0] == "finish"}
    return {1: toks[1][4], 3: toks[3][3]}


@pytest.fixture(scope="module", params=SCENARIOS)
def engines(request, dense):
    jp, pp = dense
    name = request.param
    kw, reqs = _scenario(name)
    eos = _legacy_eos(pp) if name == "legacy" else {}
    ref = JaxEngine(CFG, jp, **kw)
    want = _run_engine(ref, JaxRequest, JaxSP, reqs, eos)
    eng = ServingEngine(port_cfg(CFG), pp, device="cpu", **kw)
    got = _run_engine(eng, Request, SamplingParams, reqs, eos)
    return name, want, got, eng


def test_engine_streams_and_finish_steps_match_the_reference(engines):
    _, want, got, _ = engines
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # the same finish steps


def test_engine_tenant_stats_match_the_reference(engines):
    _, want, got, _ = engines
    assert got[2] == want[2]                       # tenants and counters


def test_engine_scenario_shows_its_behaviour(engines):
    """What each scenario is for, read from the port's own run."""
    name, _, (log, finish, st), eng = engines
    reasons = {e[1]: e[2] for e in log if e[0] == "finish"}
    if name == "legacy":
        assert eng.tenants is None and "tenants" not in eng.stats()
        assert eng.default_temperature == 0.8
        results = {r.uid: r for r in eng.results}
        # eos stops uid 1 (no params) and uid 3 (params) where it lands
        assert reasons[1] == reasons[3] == "stop"
        assert len(results[1].tokens) == 5 and len(results[3].tokens) == 4
        assert {reasons[u] for u in (0, 2, 4)} == {"length"}
        return
    assert st["prefill_decode_ratio"] == 0.5      # tenants turn it on
    tenants = st["tenants"]
    assert set(tenants) >= set(WEIGHTS)
    assert sum(v["tokens"] for v in tenants.values()) == st["tokens_out"]
    if name in ("saturation", "speculative"):
        alpha = [finish[u] for u in range(8) if u % 2 == 0]
        beta = [finish[u] for u in range(8) if u % 2 == 1]
        assert np.mean(alpha) < np.mean(beta), (alpha, beta)
        assert tenants["alpha"]["tokens"] == tenants["beta"]["tokens"]
    if name == "speculative":
        assert st["speculative"]["windows"] > 0
    if name == "tier":
        assert st["preemptions"] > 0 and st["host_tier"]["restores"] > 0
    if name == "contiguous":
        # contiguous admission stays first in, first out
        order = [s for s in (e[1] for e in log if e[0] == "token")]
        firsts = list(dict.fromkeys(order))
        assert firsts[:4] == [0, 1, 2, 3]
    assert st["pool"]["allocated_pages"] == 0


def test_admission_picks_the_least_served_tenant(dense):
    """`_next_admission` on a queue the tick never saw: the head of the
    tenant with the smallest weighted occupancy, as the reference."""
    jp, pp = dense
    got = ServingEngine(port_cfg(CFG), pp, device="cpu", **FRONT_KW,
                        tenant_weights=WEIGHTS)
    want = JaxEngine(CFG, jp, **FRONT_KW, tenant_weights=WEIGHTS)
    rng = np.random.default_rng(2)
    for uid, tenant in enumerate(["beta", "beta", "alpha", "gamma",
                                  "alpha", "beta", "gamma"]):
        prompt = rng.integers(1, 100, 6).astype(np.int32)
        got.submit(Request(uid=uid, prompt=prompt, tenant=tenant))
        want.submit(JaxRequest(uid=uid, prompt=prompt, tenant=tenant))
    order = []
    for eng in (got, want):
        picks = []
        while eng.pending:
            eng._admit_paged()
            picks.append([s.request.uid for s in eng.slots.values()])
            for i in list(eng.slots)[:1]:          # free the oldest slot
                eng._finish_slot(i, eng.slots[i], "cancelled")
        order.append(picks)
    assert order[0] == order[1]
    assert got.pending == [] and got.stats()["tenants"] == \
        want.stats()["tenants"]


# ------------------------------------------------------------ over the wire

@pytest.fixture(scope="module")
def front(dense):
    _, pp = dense
    srv = FrontendServer(port_cfg(CFG), pp, device="cpu", **FRONT_KW,
                         tenant_weights=WEIGHTS)
    srv.start()
    yield srv
    srv.stop()
    assert not srv._engine_thread.is_alive() and not srv.tick_errors


@pytest.fixture(scope="module")
def ref_oracle(dense):
    jp, _ = dense
    return JaxServer(CFG, jp, **FRONT_KW)


def _stats(srv) -> dict:
    """The engine's stats, read through the engine thread."""
    return asyncio.run(ServeClient("127.0.0.1", srv.port).stats())["engine"]


def _drain_quiet(srv, timeout=15.0):
    """Wait until the engine is idle and every page is back (pinned
    prefix pages excepted)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = _stats(srv)
        pool = s["pool"]
        if (not s["pending"] and not s["active_slots"]
                and pool["allocated_pages"] == pool["pinned_pages"]):
            return s
        time.sleep(0.02)
    raise AssertionError(f"engine never drained: {_stats(srv)}")


def test_concurrent_clients_match_the_reference_engine(front, ref_oracle):
    """Concurrent network clients, mixed greedy/sampled, two tenants:
    every stream equals the reference engine's in-process stream."""
    rng = np.random.default_rng(1)
    jobs = []
    for i in range(6):
        prompt = rng.integers(1, CFG.vocab_size, 6 + 3 * i).tolist()
        kw = dict(max_new_tokens=6 + i,
                  temperature=0.0 if i % 2 == 0 else 0.8, top_k=16,
                  top_p=0.9 if i == 3 else 1.0, seed=100 + i)
        jobs.append((prompt, kw, "alpha" if i % 2 == 0 else "beta"))

    async def go():
        client = ServeClient("127.0.0.1", front.port)

        async def one(prompt, kw, tenant):
            stream = await client.submit(prompt, SamplingParams(**kw),
                                         tenant=tenant)
            toks, reason, start = [], None, None
            async for event, data in stream:
                if event == "start":
                    start = data
                elif event == "token":
                    assert data["i"] == len(toks)
                    toks.append(data["t"])
                elif event == "finish":
                    reason = data["reason"]
                    assert data["tokens"] == toks   # finish echoes stream
                    assert data["prompt_len"] == len(prompt)
            assert start["tenant"] == tenant and start["schema"] == 1
            return toks, reason

        return await asyncio.gather(*[one(*j) for j in jobs])

    got = asyncio.run(go())
    for (prompt, kw, _t), (toks, reason) in zip(jobs, got):
        res = ref_oracle.generate(prompt, JaxSP(**kw)).drain()
        assert toks == list(res.tokens)
        assert reason == res.finish_reason
    st = _drain_quiet(front)
    assert st["tenants"]["alpha"]["tokens"] > 0
    assert st["tenants"]["beta"]["tokens"] > 0


def test_disconnect_frees_pages(front):
    """A mid-stream socket drop (no cancel frame) cancels the request
    and hands every page back."""
    before = _stats(front)["cancellations"]
    cancelled = front.counters["cancelled"]

    async def go():
        client = ServeClient("127.0.0.1", front.port)
        stream = await client.submit(list(range(1, 9)),
                                     SamplingParams(max_new_tokens=40),
                                     tenant="beta")
        n = 0
        async for event, _data in stream:
            if event == "token":
                n += 1
                if n >= 2:
                    await stream.abort()
                    break
        return n

    assert asyncio.run(go()) == 2
    stats = _drain_quiet(front)
    assert stats["cancellations"] == before + 1
    assert front.counters["cancelled"] == cancelled + 1
    assert stats["pool"]["allocated_pages"] == stats["pool"]["pinned_pages"]


def test_explicit_cancel_endpoint(front):
    async def go():
        client = ServeClient("127.0.0.1", front.port)
        stream = await client.submit(list(range(1, 7)),
                                     SamplingParams(max_new_tokens=40))
        uid, reason, asked, toks = None, None, False, None
        async for event, data in stream:
            if event == "start":
                uid = data["uid"]
            elif event == "token" and data["i"] >= 1 and not asked:
                asked = True
                assert await client.cancel(uid)
            elif event == "finish":
                reason, toks = data["reason"], data["tokens"]
        return uid, reason, toks

    uid, reason, toks = asyncio.run(go())
    assert uid is not None and reason == "cancelled" and 2 <= len(toks) < 40
    assert asyncio.run(ServeClient("127.0.0.1", front.port).cancel(uid)) \
        is False                                 # already finished
    st = _drain_quiet(front)
    assert st["pool"]["allocated_pages"] == st["pool"]["pinned_pages"]


def test_rejected_submit_is_an_error_not_a_stream(front):
    rejected = front.counters["rejected"]
    with pytest.raises(ProtocolError) as ei:
        collect("127.0.0.1", front.port, [1, 2, 3],
                SamplingParams(max_new_tokens=500))   # footprint > max_seq
    assert ei.value.code == "rejected"
    assert front.counters["rejected"] == rejected + 1
    with pytest.raises(ProtocolError) as ei:        # rejected by the parser
        asyncio.run(ServeClient("127.0.0.1", front.port).submit(
            [1, 2], tenant=""))
    assert ei.value.code == "bad_request"


def test_fanout_over_one_socket_matches_the_reference_fork(front,
                                                           ref_oracle):
    """fanout=[...] multiplexes the parent (sid 0) and forked children
    over one SSE connection; each sid's stream equals the reference's
    in-process fork at the first token."""
    prompt = list(range(1, 9))
    kws = [dict(max_new_tokens=5, seed=1),
           dict(max_new_tokens=5, seed=2, temperature=0.9),
           dict(max_new_tokens=5, seed=3, temperature=0.9, top_p=0.8)]
    forks = front.counters["forks"]
    out = collect("127.0.0.1", front.port, prompt,
                  SamplingParams(**kws[0]),
                  fanout=[SamplingParams(**kw) for kw in kws[1:]])
    assert set(out["streams"]) == {0, 1, 2}
    assert front.counters["forks"] == forks + 2
    parent = ref_oracle.generate(prompt, JaxSP(**kws[0]))
    children = [parent.fork(JaxSP(**kw)) for kw in kws[1:]]
    want = [parent.drain()] + [c.drain() for c in children]
    for sid, res in enumerate(want):
        st = out["streams"][sid]
        assert st["reason"] == res.finish_reason
        assert st["final_tokens"] == list(res.tokens)
        # a child's wire stream starts at the fork point
        assert st["tokens"] == list(res.tokens)[len(res.tokens)
                                                - len(st["tokens"]):]
    _drain_quiet(front)


def test_speculative_and_prefix_cache_over_wire(dense, ref_oracle):
    """A speculative, prefix-cached port server streams the reference
    engine's plain tokens, and the second identical prompt hits the
    prefix store."""
    _, pp = dense
    srv = FrontendServer(port_cfg(CFG), pp, device="cpu", **FRONT_KW,
                         speculate_k=2, prefix_cache=True)
    srv.start()
    try:
        prompt = list(range(1, 20))
        kw = dict(max_new_tokens=8, temperature=0.8, top_k=16, seed=5)
        first = collect("127.0.0.1", srv.port, prompt, SamplingParams(**kw))
        second = collect("127.0.0.1", srv.port, prompt,
                         SamplingParams(**kw))
        assert (first["streams"][0]["tokens"]
                == second["streams"][0]["tokens"])
        res = ref_oracle.generate(prompt, JaxSP(**kw)).drain()
        assert first["streams"][0]["tokens"] == list(res.tokens)
        st = _drain_quiet(srv)
        assert st["prefix_store"]["cross_request_hits"] > 0
        assert st["speculative"]["windows"] > 0
    finally:
        srv.stop()
    assert not srv._engine_thread.is_alive() and not srv.tick_errors


# -------------------------------------------------------------- cross-wire

def _raw_generate(port: int, body: bytes) -> bytes:
    """POST a raw submit and read the whole response to EOF."""
    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        await writer.drain()
        out = await reader.read()
        writer.close()
        return out
    return asyncio.run(go())


@pytest.fixture(scope="module")
def two_fronts(dense):
    """A fresh reference front and a fresh port front on the same
    params, one engine geometry, tenants on both."""
    jp, pp = dense
    ref = JaxFront(CFG, jp, host="127.0.0.1", port=0, **FRONT_KW,
                   tenant_weights=WEIGHTS)
    got = FrontendServer(port_cfg(CFG), pp, device="cpu", **FRONT_KW,
                         tenant_weights=WEIGHTS)
    ref.start()
    got.start()
    yield ref, got
    got.stop()
    ref.stop()


def test_the_bytes_on_the_wire_are_the_reference_servers(two_fronts):
    ref, got = two_fronts
    body = (b'{"prompt": [5, 9, 33, 2, 71, 8, 8, 19, 4], "tenant": "alpha",'
            b' "params": {"temperature": 0.8, "top_k": 12, "seed": 9,'
            b' "max_new_tokens": 7}}')
    want = _raw_generate(ref.port, body)
    assert want.startswith(b"HTTP/1.1 200 OK") and b"event: finish" in want
    assert _raw_generate(got.port, body) == want
    bad = b'{"prompt": [1], "nope": 2}'
    assert _raw_generate(got.port, bad) == _raw_generate(ref.port, bad)


def test_each_client_reads_the_other_packages_server(two_fronts):
    ref, got = two_fronts
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=20, seed=3)
    # the reference's client against the port's server, and back
    a = jax_collect("127.0.0.1", got.port, prompt, JaxSP(**kw),
                    tenant="beta")
    b = collect("127.0.0.1", ref.port, prompt, SamplingParams(**kw),
                tenant="beta")
    assert a == b and a["streams"][0]["reason"] == "length"
    ga = asyncio.run(JaxClient("127.0.0.1", got.port).stats())
    gb = asyncio.run(ServeClient("127.0.0.1", ref.port).stats())
    assert ga["frontend"] == gb["frontend"]
    assert ga["engine"]["tenants"] == gb["engine"]["tenants"]


# ------------------------------------------------------------------- tools

@pytest.mark.parametrize("spec", [None, "", "alpha:3,beta:1", "solo",
                                  " a:0.5 , b ,, c:2 ", "x:1e3"])
def test_parse_tenant_budget_matches_the_reference(spec):
    assert parse_tenant_budget(spec) == jax_parse_budget(spec)


@pytest.mark.parametrize("spec", ["alpha:three", "a:1,b:x"])
def test_parse_tenant_budget_refuses_bad_weights(spec):
    with pytest.raises(SystemExit):
        jax_parse_budget(spec)
    with pytest.raises(SystemExit):
        parse_tenant_budget(spec)


def _jax_traffic():
    """The reference's `benchmarks/traffic_gen.py`, loaded from its file."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "traffic_gen.py"
    spec = importlib.util.spec_from_file_location("jax_traffic_gen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", range(4))
def test_traffic_trace_is_the_references(seed):
    jax_traffic = _jax_traffic()

    def plain(entries):
        return [dict(e, params=e["params"].to_wire(),
                     fanout=e["fanout"] and [p.to_wire()
                                             for p in e["fanout"]])
                for e in entries]

    got = traffic_gen.build_trace(np.random.default_rng(seed), 24, 1.5, 256)
    want = jax_traffic.build_trace(np.random.default_rng(seed), 24, 1.5, 256)
    assert plain(got) == plain(want)


def test_traffic_gen_run_passes_its_gates_on_the_cpu():
    """The four gates and what does not depend on timing: a fanout
    parent that retires before a slot frees errors its children out
    with `fork_failed` (the protocol), so the forks made are not held."""
    res = traffic_gen.run(json_path=None, device="cpu")
    assert res["ok"], res["gates"]
    assert res["gates"]["identity_checked"] == 3
    assert all(e.startswith("fork_failed") for e in res["error_frames"])
    assert res["counters"]["cancellations"] == 2
    assert res["counters"]["frontend"]["cancelled"] == 2
    assert {r["tenant"] for r in res["rows"]} == set(WEIGHTS)
    assert traffic_gen.CFG == port_cfg(_jax_traffic().CFG)
    assert traffic_gen.TENANT_WEIGHTS == WEIGHTS


def test_the_serving_example_streams_and_connects(dense):
    """`examples/serve_lm_torch.py` on the CPU: the stream-and-fork demo,
    then the client demo against a fresh two-tenant front."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--stream", "--temperature", "0.8",
                     "--host-tier-pages", "8"]) is None
    _, pp = dense
    srv = FrontendServer(port_cfg(CFG), pp, device="cpu", **FRONT_KW,
                         tenant_weights=WEIGHTS)
    srv.start()
    try:
        stats = mod.main(["--connect", f"127.0.0.1:{srv.port}"])
    finally:
        srv.stop()
    eng = stats["engine"]
    assert eng["cancellations"] == 1 and stats["frontend"]["cancelled"] == 1
    assert set(eng["tenants"]) == set(WEIGHTS)
    assert eng["pool"]["allocated_pages"] == 0
    assert not srv._engine_thread.is_alive()
