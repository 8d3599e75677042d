"""The port's serving tools against the reference's, on the CPU.

* the reference's serving API the port lacked (`kv_cache.paged_write`,
  `gather_pages`, the multi-layer `paged_decode_attention`,
  `insert_slot`; `sampling.sample`, `registry.supports_long_context`,
  `configs.all_archs`, `unimem.scale_key`) against the reference's on
  its own tests' inputs;
* `prng.split` and `serve_step.sample_logits` bit for bit against
  `jax.random.split` and the reference's sampler, and `decode_many`
  against the reference's (greedy and sampled: tokens and the returned
  key) and against the port's engine;
* `benchmarks/serve_throughput.py`: the port's sweeps against the
  reference's (loaded from its file), with the reference's weights
  through `params_for`: `run`'s dense rows at every `SWEEP` point and
  its moe, hybrid and vlm rows, and the quantized, tier, prefix and
  sampling sweeps; every engine's token streams, KV bytes, pool,
  tier and store counters and prompt tokens, and every deterministic
  gate's verdict (no timing gate is asserted); the speculative sweep on
  the port alone;
* `benchmarks/paged_kernel_bench.py`: the port's run passes, its inputs
  are the reference's draws, and every plain row equals the reference's
  `ref.py` oracles (the reference's Pallas side does not run on this
  jax);
* the harness, `examples/quickstart_torch.py` and the batch loop of
  `examples/serve_lm_torch.py` on the CPU.

Each reference sweep runs once (`serve_sweeps.py`): in one subprocess
started with the module, four sweeps at a time on threads, with its
jitted step closures shared per config (as `test_torch_host_tier.py`
does), so that its compiles overlap the module's other tests; the
sweep comparisons come last in the file.  The module runs torch on one
thread.  The two port-only runs that need no reference (the speculative
sweep and the quickstart) start on a worker thread when the module
starts; their tests check the results.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import all_archs as ref_all_archs
from repro.core.unimem import scale_key as ref_scale_key
from repro.kernels.paged_attention.ref import paged_decode_attention_ref
from repro.kernels.paged_prefill.ref import paged_prefill_attention_ref
from repro.models import registry as jreg
from repro.models.config import ModelConfig as RefModelConfig
from repro.serve import kv_cache as jkv
from repro.serve import sampling as jsampling
from repro.serve import serve_step as jss
from repro.serve.sampling import SamplingParams as JaxSamplingParams

from repro_torch.benchmarks import paged_kernel_bench as PKB
from repro_torch.benchmarks import quant_margin
from repro_torch.benchmarks import run as port_run
from repro_torch.benchmarks import serve_throughput as ST
from repro_torch.configs import all_archs
from repro_torch.core.unimem import scale_key
from repro_torch.models import registry, supports_long_context
from repro_torch.serve import (Request, SamplingParams, ServingEngine,
                               gather_pages, insert_slot,
                               paged_decode_attention, paged_write, prng,
                               sample_logits)
from repro_torch.serve import sampling as psampling
from repro_torch.serve.serve_step import init_cache, make_serve_fns

from conftest import TINY
from serve_sweeps import (FAMILY_ROWS, ROW_NAMES, jax_params, kept_engines,
                          reference_benchmark, sweep_jobs, tapped)
from torch_port_helpers import (one_torch_thread,  # noqa: F401
                                port_cfg, port_params, tensor_to_numpy)

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return np.asarray(t)


@pytest.fixture(scope="module", autouse=True)
def port_only(one_torch_thread, tmp_path_factory):  # noqa: F811
    """The speculative sweep and the quickstart, started on one worker
    thread as the module starts: name -> future."""
    ckpt = tmp_path_factory.mktemp("quickstart_ckpt")
    with ThreadPoolExecutor(1) as pool:
        yield {"speculative": pool.submit(ST._speculate_sweep, 4, "self:1",
                                          device="cpu"),
               "quickstart": pool.submit(
                   _example("quickstart_torch").main,
                   ["--device", "cpu", "--ckpt-dir", str(ckpt)]),
               "ckpt": ckpt}


# ------------------------------------------------------------- repairs

def test_paged_write_then_gather_pages_equal_the_reference():
    """`tests/test_serve.py::test_paged_write_then_gather_roundtrip`'s
    inputs through both packages."""
    cfg = TINY["dense"]
    page, b = 4, 2
    arena = jkv.PagedKVArena(cfg, num_pages=8, page_size=page)
    seqs = [arena.new_sequence() for _ in range(b)]
    for s in seqs:
        s.append_tokens(8)
    bt = np.asarray(arena.block_table(seqs, max_pages=2))
    shape = (cfg.num_layers, 8, page, cfg.num_kv_heads, cfg.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(1)
    for pos in range(6):
        k_new = rng.standard_normal(
            (cfg.num_layers, b, cfg.num_kv_heads, cfg.head_dim)
        ).astype(np.float32)
        v_new = -k_new
        jk, jv = jkv.paged_write(jk, jv, jnp.asarray(k_new),
                                 jnp.asarray(v_new), jnp.asarray(bt),
                                 jnp.full((b,), pos, jnp.int32))
        out = paged_write(pk, pv, torch.from_numpy(k_new),
                          torch.from_numpy(v_new), torch.from_numpy(bt),
                          torch.full((b,), pos, dtype=torch.int32))
        assert out[0] is pk and out[1] is pv            # written in place
    for j, p in ((jk, pk), (jv, pv)):
        np.testing.assert_array_equal(p.numpy(), _np(j))
        want = _np(jkv.gather_pages(j, jnp.asarray(bt)))
        got = gather_pages(p, torch.from_numpy(bt)).numpy()
        assert got.shape == want.shape == (cfg.num_layers, b, 8,
                                           cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_array_equal(got, want)


def test_multi_layer_paged_decode_attention_equals_the_reference():
    """`tests/test_serve.py::test_paged_decode_attention_matches_
    contiguous`'s inputs: random tables over a scattered arena."""
    cfg = TINY["dense"]
    rng = np.random.default_rng(0)
    b, S, hq, hkv, hd = 3, 32, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    page = 8
    num_pages = b * S // page + 2
    phys = rng.permutation(num_pages)[:b * (S // page)]
    bt = phys.reshape(b, S // page).astype(np.int32)
    k_contig = rng.standard_normal((cfg.num_layers, b, S, hkv, hd)
                                   ).astype(np.float32)
    v_contig = rng.standard_normal((cfg.num_layers, b, S, hkv, hd)
                                   ).astype(np.float32)
    k_arena = np.zeros((cfg.num_layers, num_pages, page, hkv, hd), np.float32)
    v_arena = np.zeros_like(k_arena)
    for i in range(b):
        for pi in range(S // page):
            k_arena[:, bt[i, pi]] = k_contig[:, i, pi * page:(pi + 1) * page]
            v_arena[:, bt[i, pi]] = v_contig[:, i, pi * page:(pi + 1) * page]
    positions = np.asarray([S - 1, S - 10, S - 5], np.int32)
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    for layer in (0, 1):
        want = _np(jkv.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k_arena), jnp.asarray(v_arena),
            jnp.asarray(bt), jnp.asarray(positions), layer))
        got = paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k_arena),
            torch.from_numpy(v_arena), torch.from_numpy(bt),
            torch.from_numpy(positions), layer).numpy()
        assert got.shape == want.shape == (b, hq * hd)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _random_like(tree, rng):
    """Seeded values in each leaf's shape and dtype (numpy)."""
    def one(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(0, 50, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree.map(one, tree)


@pytest.mark.parametrize("family", [f for f in TINY
                                    if jreg.has_decode(TINY[f])])
def test_insert_slot_equals_the_reference(family):
    cfg = TINY[family]
    fam = jreg.get_family(cfg)
    rng = np.random.default_rng(3)
    cache = _random_like(fam.init_cache(cfg, 3, 16), rng)
    slot_cache = _random_like(fam.init_cache(cfg, 1, 16), rng)
    want = jkv.insert_slot(jax.tree.map(jnp.asarray, cache),
                           jax.tree.map(jnp.asarray, slot_cache), 1,
                           fam.cache_axes())
    pcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    pslot = {k: torch.from_numpy(v) for k, v in slot_cache.items()}
    pfam = registry.get_family(port_cfg(cfg))
    got = insert_slot(pcache, pslot, 1, pfam.cache_axes())
    assert got is pcache
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), _np(want[name]))


def test_sample_equals_the_reference():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 97)) * 3).astype(np.float32)
    entries = [(0, JaxSamplingParams(), 0),
               (1, JaxSamplingParams(temperature=0.7, seed=3), 2),
               (2, JaxSamplingParams(temperature=1.3, top_k=5, seed=4), 0),
               (3, JaxSamplingParams(temperature=0.9, top_p=0.8, seed=5), 7),
               (5, JaxSamplingParams(temperature=0.5, top_k=3, top_p=0.9,
                                     seed=6), 1)]
    want = _np(jsampling.sample(jnp.asarray(logits),
                                jsampling.state_for_slots(6, entries)))
    pentries = [(r, SamplingParams(temperature=sp.temperature,
                                   top_k=sp.top_k, top_p=sp.top_p,
                                   seed=sp.seed), e)
                for r, sp, e in entries]
    got = psampling.sample(torch.from_numpy(logits),
                           psampling.state_for_slots(6, pentries))
    np.testing.assert_array_equal(got.numpy(), want)


def test_registry_configs_and_unimem_names_equal_the_reference():
    for cfg in TINY.values():
        assert supports_long_context(port_cfg(cfg)) == \
            jreg.supports_long_context(cfg)
    ref, port = ref_all_archs(), all_archs()
    assert list(port) == list(ref)
    for name in ref:
        assert dataclasses.asdict(port[name].model) == \
            dataclasses.asdict(ref[name].model)
    for key in ("k", "v"):
        assert scale_key(key) == ref_scale_key(key) == f"{key}_scale"


# ------------------------------------------ prng.split and sample_logits

@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 32 - 1])
def test_split_is_bit_exact_with_jax(seed):
    key = prng.key(seed)
    np.testing.assert_array_equal(
        key.numpy().astype(np.uint32),
        _np(jax.random.key_data(jax.random.key(seed))))
    for num in (2, 3, 7):
        y0, y1 = prng.split(key[0], key[1], num)
        got = np.stack([y0.numpy(), y1.numpy()], -1).astype(np.uint32)
        want = _np(jax.random.key_data(
            jax.random.split(jax.random.key(seed), num)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_logits_equals_the_reference(temperature):
    """Every token of seeded (b, V) planes; the draws' uniforms are
    bit-exact (`prng.uniform`), so a flip could only come from an ulp of
    `log` (ROADMAP.md §C standing notes)."""
    rng = np.random.default_rng(7)
    for seed in range(8):
        logits = (rng.standard_normal((4, 131)) * 2).astype(np.float32)
        want = _np(jss.sample_logits(jnp.asarray(logits),
                                     jax.random.key(seed), temperature))
        got = sample_logits(torch.from_numpy(logits), prng.key(seed),
                            temperature)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the uniforms under the draw are jax's own
    u = prng.uniform(prng.key(9)[0:1], prng.key(9)[1:2], 4 * 131)
    want_u = _np(jax.random.uniform(jax.random.key(9), (4, 131),
                                    minval=np.finfo(np.float32).tiny,
                                    maxval=1.0))
    np.testing.assert_array_equal(u.reshape(4, 131).numpy(), want_u)


# --------------------------------------------------------- decode_many

@pytest.fixture(scope="module")
def dense():
    cfg = TINY["dense"]
    jp = jreg.get_family(cfg).init(jax.random.key(0), cfg)
    return cfg, jp, port_params(jp, cfg)


def test_make_serve_fns_returns_three_closures(dense):
    cfg, _, _ = dense
    fns = make_serve_fns(port_cfg(cfg), "cpu")
    assert len(fns) == 3 and all(callable(f) for f in fns)


def test_engine_decode_matches_batch_decode_many(dense):
    """The reference's `tests/test_serve.py::test_engine_decode_matches_
    batch_decode_many` on the port's engine and `decode_many`."""
    cfg, _, pp = dense
    pcfg = port_cfg(cfg)
    prompt = np.arange(7, dtype=np.int32) % cfg.vocab_size
    eng = ServingEngine(pcfg, pp, device="cpu", max_batch=1, max_seq=64,
                        page_size=8)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    toks_engine = eng.run()[0].tokens

    prefill, decode, decode_many = make_serve_fns(pcfg, "cpu",
                                                  temperature=0.0)
    cache = init_cache(pcfg, 1, 64, device="cpu")
    cache, logits = prefill(pp, {"tokens": prompt[None]}, cache)
    first = torch.argmax(logits, -1).to(torch.int32)
    cache, rest, _ = decode_many(pp, cache, first, prng.key(0), 4)
    assert rest.shape == (1, 4) and rest.dtype == torch.int32
    want = [int(first[0])] + [int(t) for t in rest[0]]
    assert toks_engine == want


@functools.lru_cache(maxsize=None)
def _ref_serve_fns(cfg, temperature):
    return jss.make_serve_fns(cfg, temperature=temperature)


def _ref_decode_many(cfg, jp, prompts, steps, temperature):
    """The reference's prefill, then `decode_many` (key 0): (first
    tokens, the (b, steps) tokens, the returned key)."""
    jprefill, _, jmany = _ref_serve_fns(cfg, temperature)
    cache = jreg.get_family(cfg).init_cache(cfg, len(prompts), 64)
    cache, logits = jprefill(jp, {"tokens": jnp.asarray(prompts)}, cache)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    _, toks, key = jmany(jp, cache, first, jax.random.key(0), steps)
    return first, toks, key


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_many_equals_the_reference(dense, temperature):
    """Two prompts of one length through both packages' `make_serve_fns`
    prefill and `decode_many` (key 0): the same tokens and the same
    returned key.  Sampled, the reference's draws leave its greedy
    tokens, so a `decode_many` that ignored the temperature fails."""
    cfg, jp, pp = dense
    pcfg = port_cfg(cfg)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    steps = 6

    first, jtoks, jkey = _ref_decode_many(cfg, jp, prompts, steps,
                                          temperature)
    if temperature > 0:
        _, greedy, _ = _ref_decode_many(cfg, jp, prompts, steps, 0.0)
        assert (_np(jtoks) != _np(greedy)).any()

    prefill, _, many = make_serve_fns(pcfg, "cpu", temperature=temperature)
    pcache = init_cache(pcfg, 2, 64, device="cpu")
    pcache, plogits = prefill(pp, {"tokens": prompts}, pcache)
    pfirst = torch.argmax(plogits, -1).to(torch.int32)
    np.testing.assert_array_equal(pfirst.numpy(), _np(first))
    _, toks, key = many(pp, pcache, pfirst, prng.key(0), steps)
    np.testing.assert_array_equal(toks.numpy(), _np(jtoks))
    np.testing.assert_array_equal(key.numpy().astype(np.uint32),
                                  _np(jax.random.key_data(jkey)))


# -------------------------------------------------- paged_kernel_bench

FULL_WIDTH_BF16 = (("bf16", 16, 8, 128, 16, 4, 4),)


def test_paged_kernel_bench_passes_on_the_cpu():
    res = PKB.run(device="cpu", extra_geoms=FULL_WIDTH_BF16)
    assert res["ok"], [r for r in res["rows"] if not r["match"]]
    kinds = [r["kernel"] for r in res["rows"]]
    assert len(kinds) == (2 * len(PKB.GEOMS) + len(PKB.VERIFY_GEOMS)
                          + 2 * len(PKB.QUANT_GEOMS) + 3)
    assert kinds.count("verify") == len(PKB.VERIFY_GEOMS) + 1
    assert all(r["kernel_ms"] > 0 and r["ref_ms"] > 0 for r in res["rows"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PKB.run()


def _jnp(t):
    """A port tensor as a jax array of the same dtype (fp8 through its
    bits)."""
    a = tensor_to_numpy(t)
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(a).view(jnp.float8_e4m3fn)
    return jnp.asarray(a)


def test_paged_kernel_bench_inputs_are_the_reference_draws():
    ref = reference_benchmark("paged_kernel_bench")
    hq, hkv, hd, page, mp, _ = ref.GEOMS[0]
    want = ref._setup(np.random.default_rng(0), hkv, hd, page, mp)
    case = next(PKB.cases(np.random.default_rng(0)))
    q, k, v, bt, _ = case["args"]
    for g, w in zip((k, v, bt), want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert (PKB.GEOMS, PKB.VERIFY_GEOMS, PKB.QUANT_GEOMS) == \
        (ref.GEOMS, ref.VERIFY_GEOMS, ref.QUANT_GEOMS)
    assert (PKB.B, PKB.CHUNK) == (ref.B, ref.CHUNK)


DECODE_REF = jax.jit(paged_decode_attention_ref)
PREFILL_REF = jax.jit(paged_prefill_attention_ref)


def test_paged_kernel_bench_plain_rows_equal_the_reference_oracles():
    """Every row's plain side on the reference's draws against the
    reference's `ref.py` oracles (a verify row: its k+1 decode calls
    against k+1 decode oracles), at 1e-5."""
    rows = 0
    for case in PKB.cases(np.random.default_rng(0)):
        _, plain = PKB.calls(case)
        got = plain().numpy()
        args = [_jnp(t) for t in case["args"]]
        ks, vs = ([_jnp(t) for t in case["scales"]] if case["scales"]
                  else (None, None))
        if case["kernel"] == "decode":
            want = DECODE_REF(*args, k_scale=ks, v_scale=vs)
        elif case["kernel"] == "prefill":
            want = PREFILL_REF(*args, k_scale=ks, v_scale=vs)
        else:
            qc, k, v, bt, start, _ = args
            want = jnp.stack([DECODE_REF(qc[:, j], k, v, bt, start + j)
                              for j in range(qc.shape[1])], axis=1)
        np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-5)
        rows += 1
    assert rows == (2 * len(PKB.GEOMS) + len(PKB.VERIFY_GEOMS)
                    + 2 * len(PKB.QUANT_GEOMS))


# --------------------------------------------------------------- tools

def test_harness_runs_the_serving_tools_on_the_cpu(capsys):
    assert port_run.MODULES[-3:] == [ST, PKB, port_run.traffic_gen]
    assert port_run.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("serve_throughput", "paged_kernel_bench", "traffic_gen"):
        assert f"{name:<24} PASS" in out


def test_quickstart_trains_checkpoints_restores_and_serves(port_only):
    res = port_only["quickstart"].result()
    assert res["step"] == 20 and len(res["losses"]) == 20
    assert all(np.isfinite(res["losses"]))
    assert sorted(res["tokens"]) == [0, 1]
    assert all(len(t) == 8 for t in res["tokens"].values())
    assert (port_only["ckpt"] / "step_00000020").exists()


def test_quant_margin_reports_every_decoded_token_on_the_cpu():
    """`quant_margin` on the CPU: the plain route over both arenas, the
    top-2 gap of every decoded token, and each route's token and gap at
    an asked-for (uid, index)."""
    res = quant_margin.run("cpu", at=[(4, 4)])
    assert set(res["routes"]) == {"plain/bf16", "plain/int8"}
    assert res["all_streams_equal"]
    for route in res["routes"].values():
        assert len(route["tokens"]) == 8
        assert all(len(t) == 8 for t in route["tokens"].values())
        assert 0 < route["min_gap"] < float("inf")
    (point,) = res["points"]
    assert (point["uid"], point["index"]) == (4, 4)
    for name, route in res["routes"].items():
        assert point["tokens"][name] == route["tokens"][4][4]
        assert point["gaps"][name] >= route["min_gap"]


@pytest.mark.parametrize("flags", [["--prefix-cache"], ["--speculate", "2"]])
def test_serve_lm_batch_loop_runs_on_the_cpu(flags, capsys):
    st = _example("serve_lm_torch").main(["--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "served 12 requests" in out
    assert "all pages returned to the pool" in out
    if flags[0] == "--prefix-cache":
        assert st["prefix_store"]["cross_request_hits"] > 0
        assert "prefix store: wave-2 rerun reused" in out
    else:
        assert st["speculative"]["k"] == 2
        assert "speculative: k=2" in out


# ---------------------------------------------------- serve_throughput

def _on_keys_of(got, want):
    """`got` cut to `want`'s keys, nested dicts too (the port's counters
    may carry more, e.g. its copies' timings)."""
    if not isinstance(want, dict) or not isinstance(got, dict):
        return got
    return {k: _on_keys_of(got.get(k), v) for k, v in want.items()}


def _reference_weights(cfg):
    """The reference's seeded weights of a port config, converted."""
    rcfg = RefModelConfig(**dataclasses.asdict(cfg))
    return port_params(jax_params(rcfg), rcfg)


REFERENCE_TIMEOUT_S = 600


@pytest.fixture(scope="module", autouse=True)
def reference_sweeps(tmp_path_factory):
    """`serve_sweeps.write_reference_sweeps` in a subprocess started as the module
    starts, so the reference's compiles overlap the module's other
    tests: a callable that waits for it and returns its sweeps."""
    tmp = tmp_path_factory.mktemp("reference_sweeps")
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT / "tests")!r}]
        import serve_sweeps
        serve_sweeps.write_reference_sweeps({str(tmp / "sweeps.pkl")!r})
    """)
    with open(tmp / "log.txt", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=dict(os.environ, JAX_PLATFORMS="cpu"),
                                stdout=log, stderr=subprocess.STDOUT)

    def result():
        proc.wait(timeout=REFERENCE_TIMEOUT_S)
        assert proc.returncode == 0, (tmp / "log.txt").read_text()
        return pickle.loads((tmp / "sweeps.pkl").read_bytes())
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def sweeps(reference_sweeps):
    """(reference, port) sweeps: the port's engines on the reference's
    weights (converted), run here while the reference's finish."""
    with kept_engines(ST):
        port = {name: tapped(fn) for name, fn in
                sweep_jobs(ST, _reference_weights, device="cpu").items()}
    return reference_sweeps(), port


SWEEP_NAMES = [*ROW_NAMES, *(f"row {f}" for f in FAMILY_ROWS), "quant",
               "tier", "prefix", "sampling"]
# every returned key but the timings (and the verdicts that read them)
TIMED = {"contig_tok_s", "paged_tok_s", "bf16_tok_s", "int8_tok_s",
         "all_hbm_tok_s", "tiered_tok_s", "greedy_tok_s", "sampled_tok_s",
         "sampled_over_greedy", "steady_ttft_cached_s", "steady_ttft_cold_s",
         "ttft_speedup"}


@pytest.mark.parametrize("name", SWEEP_NAMES)
def test_serve_throughput_sweep_equals_the_reference(sweeps, name):
    ref, port = sweeps
    (want, want_engines), (got, got_engines) = ref[name], port[name]
    assert len(got_engines) == len(want_engines) >= 2
    for w, g in zip(want_engines, got_engines):
        assert g["tokens"] == w["tokens"]
        assert _on_keys_of(g, w) == w
    keys = set(want) - TIMED
    if name == "prefix":
        keys.discard("ok")          # it also reads the TTFT timing
    assert set(got) >= keys
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_serve_throughput_deterministic_gates_hold(sweeps):
    _, port = sweeps
    for name in SWEEP_NAMES:
        res = port[name][0]
        if name.startswith("row"):
            assert res["ok"] and res["tokens_match"]
            assert res["paged_kv_mb"] <= res["contig_kv_mb"]
    q, t = port["quant"][0], port["tier"][0]
    p, s = port["prefix"][0], port["sampling"][0]
    assert q["ok"] and q["bytes_ratio"] <= 0.55
    assert t["ok"] and t["spills"] > 0 and t["restores"] > 0
    assert (p["tokens_match"] and p["cross_request_hits"] > 0
            and p["prefill_tokens_cached"] < p["prefill_tokens_cold"])
    assert s["ok"] and s["deterministic"] and s["diverged_from_greedy"]


def test_serve_throughput_speculative_sweep_on_the_port(port_only):
    """Byte-identical streams, greedy and sampled, and an accept rate of
    1.0 under `_high_agreement` (its tokens/s ratio is a timing gate, not
    asserted here)."""
    res = port_only["speculative"].result()
    assert res["tokens_match"] and res["tokens_match_sampled"]
    assert res["accept_rate"] == 1.0
    assert res["accepted_tokens"] == res["draft_tokens"] > 0


def test_high_agreement_zeroes_every_layer_past_the_first(dense):
    cfg, _, pp = dense
    out = ST._high_agreement(pp)
    assert out["layers"][0]["attn"]["wo"] is pp["layers"][0]["attn"]["wo"]
    for p, q in zip(out["layers"][1:], pp["layers"][1:]):
        for mod in ("attn", "mlp"):
            assert not p[mod]["wo"].any() and q[mod]["wo"].any()


def test_serve_throughput_refuses_what_waits_for_later_items():
    # nothing waits now: `shards` runs (held in
    # tests/test_torch_sharded_engine.py) and so does `attn_hlo`, whose
    # kernel route ("after") needs the card and is never copied from
    # the plain route (held in tests/test_torch_dryrun.py); without a
    # card and a device the tool still refuses
    h = ST._attention_hlo_stats(ST.FAMILY_CFGS["dense"], torch.device("cpu"))
    assert h["decode_bulk_attn_bytes_before"] > 0
    assert h["decode_bulk_attn_bytes_after"] is None
    assert "needs a CUDA card" in h["after"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.run()
