"""The port's sharded serving engine (`ServingEngine(mesh=...)`, the
arena cut into banks, `serve/sharded/`) against the reference's sharded
engine at TINY["dense"].

The reference runs once, in one subprocess started with the module,
with 8 forced host devices (`--xla_force_host_platform_device_count`)
and without excess precision (`--xla_allow_excess_precision=false`);
it writes its params and every scenario's streams and statistics, and
the port serves each scenario from the same params with its banks on
the CPU (`make_mem_mesh(n, devices=["cpu"])`).  The scenarios follow
the reference's own sharded tests: greedy and per-request-sampled
streams with the banks' peaks (`tests/test_sharded_serve.py`), bf16 at
4 shards, speculative decode with a `self:1` draft
(`tests/test_speculative.py`), an int8 arena and a host-tier spill
(`tests/test_kv_quant_tier.py`) and the persistent prefix cache
(`tests/test_prefix_store.py`), each at 8 shards."""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_TIMEOUT_S = 600


def _cfg(scenario, TINY):
    cfg = TINY["dense"]
    if scenario == "bf16_4":
        cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    return cfg


def _requests(scenario, cfg, Request, SamplingParams):
    """The scenario's requests (`Request` of either package)."""
    if scenario in ("greedy_8", "bf16_4"):
        rng = np.random.default_rng(11)
        return [Request(uid=i, max_new_tokens=4,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(3, 28))
                                            ).astype(np.int32))
                for i in range(4)]
    if scenario == "sampled_8":
        rng = np.random.default_rng(77)
        return [Request(uid=i, prompt=rng.integers(
                    0, cfg.vocab_size, int(rng.integers(4, 24))
                ).astype(np.int32), sampling=SamplingParams(
                    temperature=0.6 + 0.1 * i, top_k=6 if i % 2 else 0,
                    top_p=0.9, seed=i, max_new_tokens=5))
                for i in range(4)]
    if scenario == "spec_8":
        rng = np.random.default_rng(21)
        return [Request(uid=i, prompt=rng.integers(
                    0, cfg.vocab_size, int(rng.integers(4, 24))
                ).astype(np.int32), sampling=SamplingParams(
                    temperature=0.0 if i % 2 else 0.7,
                    top_k=8 if i == 3 else 0, seed=i, max_new_tokens=8))
                for i in range(4)]
    if scenario in ("int8_8", "tier_8"):
        rng = np.random.default_rng(0)
        return [Request(uid=uid, max_new_tokens=12, prompt=np.asarray(
                    rng.integers(1, 127, int(rng.integers(8, 28))), np.int32))
                for uid in range(6)]
    if scenario.startswith("prefix_8"):
        rng = np.random.default_rng(5)
        system = rng.integers(1, 127, 24)
        r2 = np.random.default_rng(6)
        return [Request(uid=uid, max_new_tokens=6, prompt=np.concatenate(
                    [system, r2.integers(1, 127, 6)]).astype(np.int32))
                for uid in range(5)]
    raise ValueError(scenario)


SCENARIOS = ("greedy_8", "sampled_8", "bf16_4", "spec_8", "int8_8",
             "tier_8", "prefix_8_bf16", "prefix_8_int8")


def drive(scenario, params, mesh, ServingEngine, Request, SamplingParams,
          TINY):
    """One scenario on either package's engine: returns (streams, the
    statistics the two must agree on)."""
    cfg = _cfg(scenario, TINY)
    kw = dict(max_batch=2, max_seq=64, page_size=8, mesh=mesh,
              prefill_chunk=8)
    if scenario == "spec_8":
        kw.update(speculate_k=2, draft="self:1")
    if scenario in ("int8_8", "tier_8"):
        kw = dict(max_batch=4, max_seq=64, page_size=8, mesh=mesh)
        if scenario == "int8_8":
            cfg = cfg.replace(kv_dtype="int8")
        else:
            kw.update(pool_pages=16, high_watermark=0.5, host_tier_pages=64)
    if scenario.startswith("prefix_8"):
        cfg = cfg.replace(kv_dtype=scenario.rsplit("_", 1)[1])
        kw = dict(max_batch=2, max_seq=64, page_size=8, pool_pages=64,
                  mesh=mesh, prefix_cache=True)
    eng = ServingEngine(cfg, params, **kw)
    reqs = _requests(scenario, cfg, Request, SamplingParams)
    if scenario.startswith("prefix_8"):
        eng.submit(reqs[0])
        eng.run()                              # the donor retires alone
        reqs = reqs[1:]
    for r in reqs:
        eng.submit(r)
    eng.run()
    streams = {r.uid: tuple(int(t) for t in r.tokens) for r in eng.results}
    st = eng.stats()
    keep = {k: st[k] for k in ("shards", "host_tier", "prefix_store",
                               "preemptions", "prefill_tokens", "admitted")
            if k in st}
    keep["pool"] = {k: v for k, v in st["pool"].items()}
    if "speculative" in st:
        keep["speculative"] = {k: v for k, v in st["speculative"].items()
                               if k != "draft"}
    if scenario.startswith("prefix_8"):
        keep["entries"] = sorted(
            (e.index, e.rotation, eng.pool.shard_of(e.page))
            for e in eng.prefix_store._entries.values())
    return streams, keep


def write_reference(path):
    """The reference side (run in the subprocess): params and every
    scenario's result."""
    import jax
    from conftest import TINY
    from repro.launch.mesh import make_mem_mesh
    from repro.models import registry
    from repro.serve import Request, SamplingParams, ServingEngine

    import repro.serve.sharded as sharded

    assert jax.device_count() == 8
    # the jitted sharded steps depend on the config, the mesh and the
    # pool only: scenarios that share them share their compiles
    fns, make = {}, sharded.make_sharded_serve_fns

    def shared_fns(cfg, mesh, num_pages, **kw):
        key = (cfg, id(mesh), num_pages, tuple(kw.get("arena_keys", ())))
        if key not in fns:
            fns[key] = make(cfg, mesh, num_pages, **kw)
        return fns[key]
    sharded.make_sharded_serve_fns = shared_fns
    meshes = {n: make_mem_mesh(n) for n in (4, 8)}
    out = {"params": {}, "runs": {}}
    for scenario in SCENARIOS:
        cfg = _cfg(scenario, TINY)
        if cfg.dtype not in out["params"]:
            p = registry.get_family(cfg).init(jax.random.key(0), cfg)
            out["params"][cfg.dtype] = p
        params = out["params"][cfg.dtype]
        n = 4 if scenario == "bf16_4" else 8
        out["runs"][scenario] = drive(scenario, params, meshes[n],
                                      ServingEngine, Request,
                                      SamplingParams, TINY)
    out["params"] = jax.tree.map(np.asarray, out["params"])
    with open(path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_ref") / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=8"
                          + " --xla_allow_excess_precision=false").strip())
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT / "tests")!r}]
        import test_torch_sharded_engine as m
        m.write_reference({str(path)!r})
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=REFERENCE_TIMEOUT_S, cwd=ROOT,
                          env=env)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    with open(path, "rb") as f:
        return pickle.load(f)


def port_drive(reference, scenario):
    """The port's run of a scenario, from the reference's params."""
    from conftest import TINY
    from repro_torch.launch.mesh import make_mem_mesh
    from repro_torch.serve import Request, SamplingParams
    from torch_port_helpers import port_params

    cfg = _cfg(scenario, TINY)
    params = port_params(reference["params"][cfg.dtype], cfg)
    n = 4 if scenario == "bf16_4" else 8
    return drive(scenario, params, make_mem_mesh(n, devices=["cpu"]),
                 _PortEngine, Request, SamplingParams, TINY)


class _PortEngine:
    """`ServingEngine` of the port on the CPU, built from a reference
    config (converted field for field)."""

    def __new__(cls, cfg, params, **kw):
        from repro_torch.serve import ServingEngine
        from torch_port_helpers import port_cfg
        return ServingEngine(port_cfg(cfg), params, device="cpu", **kw)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sharded_engine_matches_the_reference_sharded_engine(reference,
                                                             scenario):
    want = reference["runs"][scenario]
    got = port_drive(reference, scenario)
    assert got[0] == want[0]                   # byte-identical streams
    assert got[1] == want[1]                   # banks' peaks, pool, tier...
    st = got[1]
    assert st["pool"]["allocated_pages"] == st["pool"]["pinned_pages"]
    assert sum(1 for s in st["shards"]
               if s["peak_allocated_pages"] > 0) >= 3
    if scenario == "tier_8":
        assert st["host_tier"]["spills"] > 0
        assert st["host_tier"]["restores"] > 0
    if scenario.startswith("prefix_8"):
        assert st["prefix_store"]["cross_request_hits"] > 0
        # every cached page sits in the bank its donor's rotation chose
        assert all(bank == (rot + idx) % 8 for idx, rot, bank
                   in st["entries"])
    if scenario == "spec_8":
        assert st["speculative"]["verify_calls"] > 0
