"""The sharded arena beyond the dense family, and the entry points that
reach it.

moe, hybrid and vlm at TINY serve from 2 and 8 banks on the CPU and
emit the reference's single-arena streams (whose equality with its own
sharded engine the reference's `tests/test_sharded_serve.py` holds) and
the port's own single-arena streams, with each bank holding exactly its
share of the page bytes and the pool drained; hybrid's conv/SSM state
stays on the lead device.  Then the refusals are gone: `make_mem_mesh`,
`LLMServer(mesh=)`, `launch/serve.py --shards`, `serve_throughput
--shards`, `traffic_gen --shards` and `examples/serve_lm_torch.py
--devices` serve sharded, and a 1-shard mesh takes the single-arena
path."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import registry as jax_registry
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro_torch.core.unimem import is_page_leaf
from repro_torch.launch.mesh import MEM_AXIS, make_mem_mesh
from repro_torch.serve import LLMServer, Request, ServingEngine
from repro_torch.serve.kv_cache import PagedKVArena
from repro_torch.serve.sharded import ShardedPagedKVArena

from conftest import TINY
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import port_cfg, port_params

ROOT = Path(__file__).resolve().parents[1]


def _reqs(cfg, family):
    """The reference's request mix (`test_sharded_arena_matches_single_
    device_tokens`): four prompts of 3-27 tokens, the vlm's with seeded
    image rows."""
    rng = np.random.default_rng(sum(map(ord, family)))
    out = []
    for i in range(4):
        pe = (rng.standard_normal((cfg.num_patches, cfg.frontend_dim))
              .astype(np.float32) if cfg.frontend == "patch" else None)
        out.append(dict(uid=i, max_new_tokens=4, patch_embeds=pe,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(3, 28))
                                            ).astype(np.int32)))
    return out


KW = dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module", params=["moe", "hybrid", "vlm"])
def family(request):
    """(family, reference params, the reference's single-arena streams)."""
    cfg = TINY[request.param]
    params = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
    eng = JEngine(cfg, params, **KW)
    for r in _reqs(cfg, request.param):
        eng.submit(JRequest(**r))
    want = {r.uid: tuple(int(t) for t in r.tokens) for r in eng.run()}
    return request.param, params, want


def _port(name, params, mesh):
    cfg = TINY[name]
    eng = ServingEngine(port_cfg(cfg), port_params(params, cfg),
                        device="cpu", mesh=mesh, **KW)
    for r in _reqs(cfg, name):
        eng.submit(Request(**r))
    return eng, {r.uid: tuple(r.tokens) for r in eng.run()}


@pytest.mark.parametrize("shards", [2, 8])
def test_family_serves_the_reference_streams_from_banks(family, shards):
    name, params, want = family
    eng, got = _port(name, params, make_mem_mesh(shards, devices=["cpu"]))
    _, single = _port(name, params, None)
    assert got == want
    assert got == single
    assert isinstance(eng.arena, ShardedPagedKVArena)
    assert eng.pool.stats().allocated_pages == 0
    per_bank = eng.arena.shard_kv_bytes()
    total = sum(a.numel() * a.element_size()
                for n, banks in eng.arena.kv.items() if is_page_leaf(n)
                for a in banks)
    assert per_bank == [total // shards] * shards
    peaks = [s["peak_allocated_pages"] for s in eng.stats()["shards"]]
    assert sum(p > 0 for p in peaks) >= min(3, shards)
    for n, a in eng.arena.kv.items():           # state once, on the lead
        if not is_page_leaf(n):
            assert torch.is_tensor(a) and a.device == eng.device


def test_one_shard_mesh_takes_the_single_arena_path():
    """A 1-shard mesh is the single-arena engine: same internals, same
    tokens as no mesh at all (`tests/test_sharded_serve.py:251`)."""
    cfg = TINY["dense"]
    params = port_params(
        jax_registry.get_family(cfg).init(jax.random.key(0), cfg), cfg)
    prompt = (np.arange(11, dtype=np.int32) * 11) % cfg.vocab_size

    def run(mesh, device=None):
        eng = ServingEngine(port_cfg(cfg), params, device=device,
                            max_batch=2, max_seq=64, page_size=8, mesh=mesh)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
        return eng, {r.uid: tuple(r.tokens) for r in eng.run()}

    # the mesh's device is the engine's default
    e1, t1 = run(make_mem_mesh(1, devices=["cpu"]))
    _, t0 = run(None, device="cpu")
    assert e1.mesh is None and e1.device == torch.device("cpu")
    assert type(e1.arena) is PagedKVArena
    assert t1 == t0
    assert "shards" not in e1.stats()


def test_make_mem_mesh_places_banks():
    mesh = make_mem_mesh(4, devices=["cpu"])
    assert mesh.axis_names == (MEM_AXIS,) and mesh.shape[MEM_AXIS] == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mem_mesh(devices=["cpu", "cpu"]).size == 2
    assert mesh.describe() == {"shards": 4, "mesh_axis": "mem",
                               "devices": ["cpu"] * 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mem_mesh(2)
    with pytest.raises(ValueError):
        make_mem_mesh(0, devices=["cpu"])


def test_entry_points_serve_sharded():
    """`LLMServer(mesh=)` (its device from the mesh), `launch/serve.py
    --shards`, `serve_throughput --shards`, `traffic_gen --shards` (the
    HTTP front) and the example's `--devices`: each runs, and says where
    its banks lie."""
    from repro_torch.benchmarks import serve_throughput as ST
    from repro_torch.benchmarks import traffic_gen as TG
    from repro_torch.launch import serve as launch

    cfg = port_cfg(TINY["dense"])
    srv = LLMServer(cfg, mesh=make_mem_mesh(2, devices=["cpu"]),
                    max_batch=2, max_seq=64, page_size=8)
    stream = srv.generate(np.arange(5, dtype=np.int32))
    assert len(stream.drain().tokens) > 0
    assert srv.stats["mesh"]["shards"] == 2
    assert isinstance(srv.engine.arena, ShardedPagedKVArena)

    res = launch.main(["--reduced", "--device", "cpu", "--shards", "4",
                       "--requests", "3", "--max-new", "4", "--max-seq",
                       "64", "--page-size", "8"])
    assert len(res) == 3

    out = ST.run(families=["moe"], shards=2, device="cpu")
    assert out["ok"]
    assert out["shard_topology"]["mesh_axis"] == "mem"
    assert out["shard_topology"]["bank_devices"] == ["cpu", "cpu"]
    assert len(out["rows"][0]["per_shard_kv_bytes"]) == 2

    tr = TG.run(requests=8, horizon=0.5, json_path=None, device="cpu",
                shards=2, identity_checks=2)
    assert tr["ok"], tr["gates"]
    assert tr["trace"]["shards"] == 2
    assert tr["shard_topology"]["devices"] == ["cpu", "cpu"]

    path = ROOT / "examples" / "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    st = ex.main(["--device", "cpu", "--devices", "2"])
    assert st["mesh"]["shards"] == 2 and len(st["shard_kv_bytes"]) == 2
