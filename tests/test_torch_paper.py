"""The port's paper side against the JAX package: the analytic chip
models (`core/datapath`, `hwmodel`, `projection`, `simulator`), the
Sunrise config and every module of the paper harness, value by value.

The models are framework-free copies, so every value must be equal, not
close: the same Python arithmetic on the same constants.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro.configs import sunrise_chip as JCFG
from repro.core import datapath as JDP
from repro.core import hwmodel as JHW
from repro.core import projection as JPJ
from repro.core import simulator as JSIM
from repro.models import resnet as JR
from repro_torch.benchmarks import run as port_run
from repro_torch.benchmarks import (resnet50_throughput, table1_datapath,
                                    table4_cost, table23_diebench,
                                    table57_projection, ws_dataflow)
from repro_torch.configs import sunrise_chip as PCFG
from repro_torch.core import datapath as PDP
from repro_torch.core import hwmodel as PHW
from repro_torch.core import projection as PPJ
from repro_torch.core import simulator as PSIM
from repro_torch.models import resnet as PR

from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_BENCHMARKS = {m.__name__.rsplit(".", 1)[1]: m for m in (
    table1_datapath, table23_diebench, table4_cost, table57_projection,
    resnet50_throughput, ws_dataflow)}


def _reference_benchmark(name):
    """The reference harness's module `benchmarks/<name>.py`, loaded from
    its file (the repository's `benchmarks/` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_benchmarks_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(obj):
    """A dataclass (or a list of them) as plain values."""
    if isinstance(obj, list):
        return [_fields(o) for o in obj]
    return dataclasses.asdict(obj)


# ------------------------------------------------------------ datapath

@pytest.mark.parametrize("tech", ["INTERPOSER", "TSV", "HITOC"])
def test_datapath_equals_the_reference(tech):
    p, j = getattr(PDP, tech), getattr(JDP, tech)
    assert _fields(p) == _fields(j)
    for fn in ("wire_density", "num_wires", "bandwidth_TBps",
               "transfer_power_w"):
        assert getattr(PDP, fn)(p) == getattr(JDP, fn)(j)
    assert PDP.transfer_power_w(p, 0.5) == JDP.transfer_power_w(j, 0.5)
    assert _fields(PDP.report(p)) == _fields(JDP.report(j))


def test_table1_and_its_published_values_equal_the_reference():
    assert _fields(PDP.table1()) == _fields(JDP.table1())
    assert PDP.PAPER_TABLE1 == JDP.PAPER_TABLE1


# ------------------------------------------------------------- hwmodel

@pytest.mark.parametrize("i", range(4))
def test_chip_specs_and_tables_iii_iv_equal_the_reference(i):
    p, j = PHW.ALL_CHIPS[i], JHW.ALL_CHIPS[i]
    assert _fields(p) == _fields(j)
    assert _fields(PHW.die_normalized(p)) == _fields(JHW.die_normalized(j))
    assert _fields(PHW.cost_report(p)) == _fields(JHW.cost_report(j))
    assert (PHW.gross_dies_per_wafer(p.die_area_mm2)
            == JHW.gross_dies_per_wafer(j.die_area_mm2))
    assert (PHW.poisson_yield(p.die_area_mm2, 0.001)
            == JHW.poisson_yield(j.die_area_mm2, 0.001))


def test_hwmodel_constants_and_tables_equal_the_reference():
    for name in ("PAPER_TABLE3", "PAPER_TABLE4", "WAFER_PRICE_USD", "NRE_USD",
                 "DEFECT_DENSITY", "WAFER_DIAMETER_MM", "BONDING_OVERHEAD"):
        assert getattr(PHW, name) == getattr(JHW, name), name
    assert _fields(PHW.table3()) == _fields(JHW.table3())
    assert _fields(PHW.table4()) == _fields(JHW.table4())


def test_the_port_states_no_tpu_target():
    # the port now states the reference's TPU v5e target (the roofline's
    # default, `launch/roofline.py`) with the reference's constants, and
    # its own card beside it; it states no TPU figure as the port's
    assert hasattr(JHW, "TpuTarget") and hasattr(JCFG, "TARGET")
    assert _fields(PHW.TPU_V5E) == _fields(JHW.TPU_V5E)
    assert PCFG.TARGET is PHW.TPU_V5E
    assert PHW.H100.name == "h100-sxm5-80gb" and PHW.H100.hbm_bw_Bps \
        != JHW.TPU_V5E.hbm_bw_Bps


# ---------------------------------------------------------- projection

@pytest.mark.parametrize("node", [40, 28, 16, 12, 10, 7])
def test_node_paths_equal_the_reference(node):
    assert _fields(PPJ.path_to_7nm(node)) == _fields(JPJ.path_to_7nm(node))


@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("budget", [None, 0.2, 2.0])
def test_projection_equals_the_reference(i, budget):
    kw = {} if budget is None else {"power_budget_w_mm2": budget}
    p, j = PHW.ALL_CHIPS[i], JHW.ALL_CHIPS[i]
    assert _fields(PPJ.project_to_7nm(p, **kw)) == _fields(
        JPJ.project_to_7nm(j, **kw))
    assert _fields(PPJ.project_to_7nm(p, "3x", "1x", **kw)) == _fields(
        JPJ.project_to_7nm(j, "3x", "1x", **kw))


def test_projection_constants_table7_and_capacity_equal_the_reference():
    for name in ("NODE_STEPS", "DRAM_DENSITY_GB_MM2", "PAPER_TABLE7",
                 "DEFAULT_POWER_BUDGET_W_MM2", "PERF_POWER_COST"):
        want = getattr(JPJ, name)
        got = getattr(PPJ, name)
        assert (_fields(got) if name == "NODE_STEPS" else got) == (
            _fields(want) if name == "NODE_STEPS" else want), name
    assert _fields(PPJ.table7()) == _fields(JPJ.table7())
    for area in (110.0, 800.0):
        assert (PPJ.sunrise_big_die_capacity_gb(area)
                == JPJ.sunrise_big_die_capacity_gb(area))


# ----------------------------------------------------------- simulator

def _report(rep):
    return {"layers": _fields(rep.layers), "batch": rep.batch,
            "total_s": rep.total_s, "throughput": rep.throughput_per_s,
            "util": rep.mac_utilization, "bounds": rep.bound_histogram(),
            "layer_bounds": [l.bound for l in rep.layers]}


def test_sunrise_chip_equals_the_reference():
    p, j = PSIM.SunriseChip(), JSIM.SunriseChip()
    assert _fields(p) == _fields(j)
    for prop in ("clock_hz", "channel_parallelism", "macs_per_s"):
        assert getattr(p, prop) == getattr(j, prop)
    assert _fields(PSIM.sram_cache_chip()) == _fields(JSIM.sram_cache_chip())


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("chip", ["sunrise", "sram"])
def test_schedule_equals_the_reference(batch, chip):
    pc = PSIM.SunriseChip() if chip == "sunrise" else PSIM.sram_cache_chip()
    jc = JSIM.SunriseChip() if chip == "sunrise" else JSIM.sram_cache_chip()
    ps, js = PR.resnet50_layer_specs(), JR.resnet50_layer_specs()
    assert _report(PSIM.schedule(pc, ps, batch)) == _report(
        JSIM.schedule(jc, js, batch))
    for p, j in zip(ps, js):
        assert (PSIM.compute_cycles(pc, p, batch)
                == JSIM.compute_cycles(jc, j, batch))


@pytest.mark.parametrize("batch", [1, 8])
def test_no_weight_stationarity_ablation_equals_the_reference(batch):
    ps, js = PR.resnet50_layer_specs(), JR.resnet50_layer_specs()
    assert _report(PSIM.no_weight_stationarity(PSIM.SunriseChip(), ps, batch)) \
        == _report(JSIM.no_weight_stationarity(JSIM.SunriseChip(), js, batch))


@pytest.mark.parametrize("batch", [1, 8])
def test_resnet50_throughput_equals_the_reference(batch):
    assert _report(PSIM.resnet50_throughput(batch=batch)) == _report(
        JSIM.resnet50_throughput(batch=batch))


def test_sunrise_config_equals_the_reference():
    assert _fields(PCFG.CHIP) == _fields(JCFG.CHIP)
    assert _fields(PCFG.SPEC) == _fields(JCFG.SPEC)
    assert PCFG.PAPER_CLAIMS == JCFG.PAPER_CLAIMS


# ---------------------------------------------------------- benchmarks

@pytest.mark.parametrize("name", list(PORT_BENCHMARKS))
def test_benchmark_rows_equal_the_reference_benchmarks(name):
    port = PORT_BENCHMARKS[name]
    got = port.run("cpu") if port is ws_dataflow else port.run()
    want = _reference_benchmark(name).run()
    timing = {"check_ms", "interpret_ms", "device", "check_err_over_bound",
              "twin_err_over_bound"}
    assert got["name"] == want["name"] and got["ok"] == want["ok"] is True
    assert got["rows"] == want["rows"]
    assert ({k: v for k, v in got.items() if k not in timing}
            == {k: v for k, v in want.items() if k not in timing})


def test_ws_dataflow_holds_both_kernels_on_its_device():
    res = ws_dataflow.run(device="cpu")
    assert res["device"] == "cpu" and res["check_ms"] >= 0
    assert res["check_err_over_bound"] <= 1 and res["twin_err_over_bound"] <= 1


def test_ws_dataflow_wants_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ws_dataflow.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.main([])


def test_harness_runs_every_benchmark_and_exits_zero_on_the_cpu(capsys):
    assert port_run.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in PORT_BENCHMARKS:
        assert f"{name:<24} PASS" in out


def test_harness_exits_nonzero_on_a_failed_claim(monkeypatch, capsys):
    monkeypatch.setattr(table4_cost, "run",
                        lambda: {"name": "table4_cost", "ok": False,
                                 "rows": []})
    monkeypatch.setattr(table4_cost, "pretty", lambda res: None)
    assert port_run.main(["--device", "cpu"]) == 1
    assert "table4_cost              FAIL" in capsys.readouterr().out
