"""`scripts/ep_routing_probe.py` (ROADMAP C.12) on the CPU: the forced
routing takes the experts it is given and counts the assignments that
differ from the caller's own, and the whole probe (the single rank, then
a 4-rank gloo world on (1, 4) "ep", natural and forced) agrees in f32,
where the routing cannot flip.  Imports neither JAX nor the reference."""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

from conftest import TINY
from torch_port_helpers import one_torch_thread, port_cfg  # noqa: F401

from repro_torch.models import moe

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@pytest.fixture
def probe(monkeypatch):
    # on sys.path, so the world's spawned ranks import it by name too
    monkeypatch.syspath_prepend(str(SCRIPTS))
    import ep_routing_probe
    return ep_routing_probe


def test_forced_routing_takes_the_given_experts(probe):
    cfg = port_cfg(TINY["moe"])
    orig = moe._route
    g = torch.Generator().manual_seed(0)
    w = torch.randn(cfg.d_model, cfg.num_experts, generator=g)
    xf = torch.randn(16, cfg.d_model, generator=g)
    with probe.forced_routing() as rec:
        own_w, own_e, own_aux = moe._route(w, cfg, xf, with_aux=True)
    assert rec.calls == 1 and torch.equal(rec.recorded[0], own_e)
    # its own experts: the same weights and router loss
    with probe.forced_routing([own_e]) as same:
        got_w, got_e, got_aux = moe._route(w, cfg, xf, with_aux=True)
    assert same.flips == [0] and torch.equal(got_e, own_e)
    torch.testing.assert_close(got_w, own_w)
    torch.testing.assert_close(got_aux, own_aux)
    # the next experts over on the first two tokens: taken, and counted
    other = own_e.clone()
    other[:2] = (other[:2] + 1) % cfg.num_experts
    with probe.forced_routing([other]) as moved:
        _, got_e, _ = moe._route(w, cfg, xf, with_aux=True)
    assert torch.equal(got_e, other) and moved.flips[0] > 0
    assert moe._route is orig                    # restored on leaving


def test_the_probe_agrees_in_f32_on_the_cpu(probe, tmp_path):
    rep = probe.run(probe.cpu_case(str(tmp_path / "work")))
    assert rep["dtype"] == "float32" and rep["mesh"] == (1, probe.RANKS)
    calls = rep["router_calls_single"]
    assert calls > 0
    for name in ("natural", "forced"):
        r = rep[name]
        assert r["router_calls"] == [calls] * probe.RANKS
        assert r["worst_rel_l2"] < 1e-5 and r["loss_abs_diff"] < 1e-5
    assert all(f == [0] * calls for f in rep["forced"]["flips_per_call"])
    assert rep["verdict"] == "within the dense bounds"
