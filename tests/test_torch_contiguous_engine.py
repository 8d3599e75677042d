"""PyTorch port vs the JAX reference: the engine's contiguous layout.

On TINY["dense"], TINY["moe"], TINY["hybrid"] and TINY["ssm"] (f32, on
the CPU, the reference at its default `attention_impl="flash_xla"`):
greedy and sampled event streams byte-identical, the same `stats()`
(`peak_kv_bytes`, `prefill_tokens`, the pool), every cache leaf within
1e-5 at the end of the run, `fork` refused, `cancel` clearing the row,
and a run long enough that an idle row's position passes max_seq.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax

from conftest import TINY
from repro.models import registry as jax_registry
from repro.serve import ServingEngine as JaxEngine
from repro.serve.engine import FinishEvent as JaxFinish
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingParams as JaxSP
from repro_torch.serve.engine import FinishEvent, Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from torch_port_helpers import port_cfg, port_params
from torch_port_helpers import one_torch_thread  # noqa: F401

F32 = dict(atol=1e-5, rtol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("dense", "moe", "hybrid", "ssm")
STAT_KEYS = ("layout", "steps", "tokens_out", "prefill_tokens", "admitted",
             "preemptions", "cancellations", "peak_kv_bytes",
             "prefill_shapes")


@pytest.fixture(scope="module")
def family_params():
    out = {}
    for family in FAMILIES:
        cfg = TINY[family]
        params = jax_registry.get_family(cfg).init(jax.random.key(0), cfg)
        out[family] = (params, port_params(params, cfg))
    return out


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _drive(engine, request_cls, sp_cls, script):
    """Run `script` (step -> actions taken before that step: ("submit",
    uid, prompt, max_new, sampled) or ("cancel", uid)); returns the event
    log, the stats, the final cache as numpy and the largest position
    any row reached."""
    log, step, top = [], 0, 0
    while True:
        for act in script.get(step, ()):
            if act[0] == "submit":
                _, uid, prompt, n, sampled = act
                sp = (sp_cls(temperature=0.9, top_k=20, seed=40 + uid,
                             max_new_tokens=n) if sampled
                      else sp_cls(max_new_tokens=n))
                engine.submit(request_cls(uid=uid, prompt=prompt,
                                          sampling=sp))
            elif act[0] == "cancel":
                log.append(("cancel", act[1], engine.cancel(act[1])))
        if not (engine.pending or engine.slots) and step > max(script):
            break
        engine.step()
        top = max(top, int(np.asarray(engine.cache["pos"]).max()))
        for e in engine.events():
            if isinstance(e, (FinishEvent, JaxFinish)):
                log.append(("finish", e.uid, e.reason, tuple(e.result.tokens)))
            else:
                log.append(("token", e.uid, e.token, e.index))
        step += 1
        assert step < 500
    st = engine.stats()
    stats = {k: st[k] for k in STAT_KEYS}
    stats["pool"] = dict(st["pool"])
    cache = {k: np.asarray(v) for k, v in engine.cache.items()}
    return log, stats, cache, top


def _scenario(name, vocab):
    if name == "mixed":
        ps = _prompts(21, (9, 23, 4, 31, 12), vocab)
        kw = dict(max_batch=3, max_seq=48)
        script = {0: [("submit", i, p, 6, i % 2 == 1)
                      for i, p in enumerate(ps[:4])],
                  3: [("cancel", 1), ("submit", 4, ps[4], 5, True)]}
    else:   # "idle_past_max_seq": row 1 idles while row 0 serves 3 requests
        ps = _prompts(22, (3, 3, 4, 3), vocab)
        kw = dict(max_batch=2, max_seq=16)
        script = {0: [("submit", 0, ps[0], 12, False),
                      ("submit", 1, ps[1], 1, False)],
                  13: [("submit", 2, ps[2], 12, True)],
                  26: [("submit", 3, ps[3], 12, False)]}
    return kw, script


@pytest.mark.parametrize("scenario", ["mixed", "idle_past_max_seq"])
@pytest.mark.parametrize("family", FAMILIES)
def test_contiguous_engine_matches_the_reference(family_params, family,
                                                 scenario):
    cfg = TINY[family]
    jp, pp = family_params[family]
    kw, script = _scenario(scenario, cfg.vocab_size)
    kw["layout"] = "contiguous"
    want = _drive(JaxEngine(cfg, jp, **kw), JaxRequest, JaxSP, script)
    got = _drive(ServingEngine(port_cfg(cfg), pp, device="cpu", **kw),
                 Request, SamplingParams, script)
    assert got[0] == want[0]                       # byte-identical streams
    assert got[1] == want[1]                       # stats, pool included
    for k, w in want[2].items():                   # the cache, row by row
        np.testing.assert_allclose(got[2][k], w, **F32, err_msg=k)
    assert got[3] == want[3]
    assert got[1]["pool"]["allocated_pages"] == 0
    if scenario == "mixed":
        assert ("cancel", 1, True) in got[0]
    else:
        assert got[3] > kw["max_seq"]              # an idle row wrote past S


@pytest.mark.parametrize("family", FAMILIES)
def test_cancel_clears_the_row_and_fork_is_refused(family_params, family):
    cfg = TINY[family]
    _, pp = family_params[family]
    eng = ServingEngine(port_cfg(cfg), pp, device="cpu", max_batch=2,
                        max_seq=32, layout="contiguous")
    for uid, n in enumerate((7, 11)):
        eng.submit(Request(uid=uid, prompt=np.arange(1, n + 1, dtype=np.int32),
                           max_new_tokens=8))
    eng.step()
    slot = next(i for i, s in eng.slots.items() if s.request.uid == 1)
    assert eng.cache["pos"][slot] > 0
    with pytest.raises(ValueError, match="paged"):
        eng.fork(0, 9)
    assert eng.cancel(1)
    for name, a in eng.cache.items():
        axis = 2 if (family == "hybrid" and name in ("conv", "ssm")) else (
            0 if name == "pos" else 1)
        assert not a.select(axis, slot).any(), name
    assert eng.stats()["cancellations"] == 1


def test_ssm_defaults_to_contiguous_and_paged_is_refused(family_params):
    _, pp = family_params["ssm"]
    cfg = port_cfg(TINY["ssm"])
    assert ServingEngine(cfg, pp, device="cpu").layout == "contiguous"
    with pytest.raises(ValueError, match="no paged path"):
        ServingEngine(cfg, pp, device="cpu", layout="paged")
    with pytest.raises(ValueError, match="unknown layout"):
        ServingEngine(port_cfg(TINY["dense"]), family_params["dense"][1],
                      device="cpu", layout="ring")


def test_contiguous_streams_equal_paged_streams(family_params):
    """The two layouts emit the same tokens for the same requests, two
    identical prompts included (they share prefix pages when paged)."""
    cfg = port_cfg(TINY["dense"])
    _, pp = family_params["dense"]
    prompt = _prompts(23, (17,), cfg.vocab_size)[0]

    def run(layout):
        eng = ServingEngine(cfg, pp, device="cpu", max_batch=2, max_seq=64,
                            page_size=8, layout=layout)
        for uid in range(2):
            eng.submit(Request(uid=uid, prompt=prompt.copy(),
                               max_new_tokens=6))
        return {r.uid: tuple(r.tokens) for r in eng.run()}

    assert run("paged") == run("contiguous")


@pytest.mark.parametrize("args", [["--arch", "mamba2-130m"],
                                  ["--layout", "contiguous"]])
def test_launch_serve_runs_the_contiguous_layout_on_cpu(args):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args, "--reduced",
         "--device", "cpu", "--requests", "3", "--max-new", "4",
         "--max-seq", "64"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests" in proc.stdout
    assert "'layout': 'contiguous'" in proc.stdout
