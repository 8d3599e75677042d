"""The traced half of the port's XLA tools (`launch/trace.py`,
`launch/cells.py` `build_cell`/`lower_cell`, `launch/dryrun.py`,
`launch/inspect.py`, the paged and sharded step probes,
`serve_throughput`'s `attention_hlo`, `scripts/fill_experiments_torch.py`),
on the CPU and on "meta".

The FLOPs a reduced cell's trace counts are held to the reference's
`hlo_analysis.summarize(...).flops` of the same cell compiled by jax:
exactly, for every cell whose dots both count.  The one difference is
named and left out: the Mamba mixer's depthwise causal conv, in the
reference an HLO `convolution` (prefill) or a dot over the conv window
(decode, 2 b width channels a layer), both counted there, and shifted
multiply-adds in the port (elementwise, counted nowhere); so for the ssm
and hybrid cells those FLOPs are subtracted from the reference's first.
The probes run at the reference tests' geometries
(`tests/test_paged_attention.py`, `tests/test_sharded_serve.py`,
`tests/test_sampling.py`); `tests/test_torch_trace_card.py` holds the
kernel route's traces on the card."""
from __future__ import annotations

import ast
import dataclasses
import gc
import importlib.util
import json
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs.base as RB
from repro.configs.base import ArchSpec as RefArch, ShapeSpec as RefShape
from repro.launch import hlo_analysis as RH
from repro.launch.cells import build_cell as ref_build, lower_cell as ref_lower
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.serve.serve_step import bulk_attn_shapes as ref_bulk_shapes

from conftest import TINY
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core import dataflow as PD
from repro_torch.distribution import collectives as C
from repro_torch.launch import dryrun, roofline, trace as T
from repro_torch.launch import inspect as port_inspect
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.mesh import Mesh, make_mem_mesh
from repro_torch.serve.sampling import SamplingParams, state_for_slots
from repro_torch.serve.serve_step import (HLO_PROBE_GEOM, bulk_attn_shapes,
                                          lowered_paged_hlo)
from repro_torch.serve.sharded import lowered_sharded_hlo
from torch_port_helpers import one_torch_thread, port_cfg  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"

# the reduced cells: (family, kind, seq_len, batch)
CELLS = [(f, k, 64 if k == "decode" else 32, 2)
         for f in ("dense", "moe", "ssm", "hybrid", "vlm")
         for k in ("prefill", "decode")] + [("encoder", "prefill", 32, 2),
                                            ("dense", "train", 32, 2),
                                            ("encoder", "train", 32, 2)]


def _ref_flops(fam, kind, seq, b):
    """(dot + conv FLOPs, conv FLOPs) of the reference's compiled cell."""
    name = f"tiny_{kind}"
    RB.SHAPES[name] = RefShape(name, kind, seq, b)
    try:
        mesh = ref_make_mesh((1, 1), ("data", "model"))
        cell = ref_build("x", name, mesh, spec=RefArch(model=TINY[fam]))
        text = ref_lower(cell, mesh).compile().as_text()
    finally:
        del RB.SHAPES[name]
    prog = RH.parse_hlo(text)
    conv = sum(RH._conv_flops(prog, op) * prog.multipliers.get(
        op.computation, 0.0) for op in prog.ops.values()
        if op.opcode == "convolution")
    return RH.summarize(text).flops, conv


@pytest.fixture(scope="module")
def ref_flops():
    """The module's one batch of reference compiles: every reduced cell."""
    return {c: _ref_flops(*c) for c in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(map(str, c)))
def test_traced_matmul_flops_equal_the_reference_hlo(cell, ref_flops):
    fam, kind, seq, b = cell
    want, conv = ref_flops[cell]
    c = build_cell("x", ShapeSpec(f"tiny_{kind}", kind, seq, b), None,
                   spec=ArchSpec(model=port_cfg(TINY[fam])))
    got = lower_cell(c).summary().flops
    cfg = TINY[fam]
    if fam in ("ssm", "hybrid") and kind == "decode":
        # the reference's decode conv is a dot over the window
        assert conv == 0
        conv = 2 * b * cfg.conv_width * cfg.conv_channels * cfg.num_layers
    elif fam in ("ssm", "hybrid"):
        assert conv > 0
    else:
        assert conv == 0
    assert got == want - conv


# ------------------------------------------------------------ the trace

def test_types_wire_bytes_and_pairs():
    assert T.type_str((2, 8, 8, 4, 16), torch.float32) == "f32[2,8,8,4,16]"
    assert T.tensor_type(torch.empty(3, dtype=torch.int32)) == "s32[3]"
    assert T.tensor_type(torch.empty((), dtype=torch.bfloat16)) == "bf16[]"
    line = "  %x = f32[8,64]{1,0} %s(%p), replica_groups=[2,4]<=[8]\n"
    for kind in T.COLLECTIVE_KINDS:
        op = RH.parse_hlo(line.replace("%s", kind)).ops["x"]
        assert T.wire_bytes(kind, op.result_bytes, op.group_size) == \
            op.wire_bytes
    assert T.seen_pairs(4, 4, True) == 10
    assert T.seen_pairs(2, 6, True, q_offset=3) == 4 + 5
    assert T.seen_pairs(3, 5, False) == 15


def test_a_trace_counts_views_fresh_buffers_and_matmul_flops():
    x, w = torch.randn(4, 8), torch.randn(8, 6)
    with T.Trace() as tr:
        y = (x @ w).relu()
        z = y.view(2, 12)
        del y
    s = tr.summary()
    assert s.flops == 2 * 4 * 8 * 6
    assert tr.allocates("f32[4,6]")
    assert "f32[2,12]" in tr.result_types()
    assert not tr.allocates("f32[2,12]")                 # a view
    assert s.bytes_written == 2 * 4 * 6 * 4               # mm, relu
    assert s.bytes_by_shape["f32[4,8]"] == 4 * 8 * 4
    assert tr.peak_live_bytes >= 4 * 6 * 4
    assert z.shape == (2, 12) and not T._ACTIVE


def test_a_dropped_trace_keeps_its_call_s_buffers_alive_no_longer():
    """The live-bytes finalizers hold no reference to the trace, whose
    `output` would otherwise outlive every caller."""
    x = torch.randn(4, 8)
    out, tr = T.trace_call(lambda: x * 2)
    assert tr.live_bytes == 4 * 8 * 4 and tr.output is out
    alive = weakref.ref(out)
    del out, tr
    gc.collect()
    assert alive() is None


def test_a_trace_sees_every_copy_to_the_host_and_every_scalar_read():
    """Card stand-ins (fake CUDA tensors): a copy into a host buffer, a
    `.to("cpu")`, a scalar read and a copy in are each recorded; a 0-dim
    host operand of a card op is a scalar argument, not a copy."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               FakeTensorMode)
    with FakeTensorMode():
        card = torch.empty(4, 8, device="cuda")
        host = torch.empty(4, 8)
        with T.Trace() as tr:
            host.copy_(card)
            card.to("cpu")
            with pytest.raises(DataDependentOutputException):
                card.sum().item()
            host.to(card.device)
            card.mul(torch.tensor(2.0))
    assert tr.transfers == [("f32[4,8]", "cuda", "cpu"),
                            ("f32[4,8]", "cuda", "cpu"),
                            ("f32[]", "cuda", "cpu"),
                            ("f32[4,8]", "cpu", "cuda")]


def test_meta_tensors_take_every_kernel_wrappers_plain_version():
    from repro_torch.kernels.paged_attention import ops as pa
    meta = dict(device="meta")
    q = torch.empty(2, 4, 16, **meta)
    kp = torch.empty(9, 8, 2, 16, **meta)
    bt = torch.empty(2, 4, dtype=torch.int32, **meta)
    pos = torch.empty(2, dtype=torch.int32, **meta)
    out = pa.paged_decode_attention(q, kp, kp, bt, pos)
    assert out.device.type == "meta" and out.shape == q.shape


# ------------------------------------------- kernel launches in a trace

def _launch_sites(path: Path):
    """(function, names of the calls after each `launches += 1`)."""
    tree = ast.parse(path.read_text())
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        body = fn.body
        for i, st in enumerate(body):
            if (isinstance(st, ast.AugAssign)
                    and ast.unparse(st.target).endswith("launches")):
                calls = [ast.unparse(n.func) for s in body[i + 1:]
                         for n in ast.walk(s) if isinstance(n, ast.Call)]
                yield fn.name, calls


@pytest.mark.parametrize("ops", sorted(KERNELS.glob("*/ops.py")),
                         ids=lambda p: p.parent.name)
def test_every_kernel_launch_reports_to_the_trace(ops):
    """Each launcher that counts a launch reports it (its `_report*`
    function, decorated `trace.reporter`) right after: a launch missing
    from a trace would count zero FLOPs for its kernel."""
    sites = list(_launch_sites(ops))
    assert sites
    for fn, calls in sites:
        assert any(c.split(".")[-1].startswith("_report") for c in calls), fn
    src = ops.read_text()
    assert src.count("@_trace.reporter") == src.count("\ndef _report")


def test_the_reports_count_the_bounds_work():
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_prefill import ops as pp
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ws_matmul import ops as ws
    z = torch.zeros
    q, kp, bt = z(2, 4, 16), z(9, 8, 2, 16), z(2, 4, dtype=torch.int32)
    pos = torch.tensor([3, 20], dtype=torch.int32)
    qc, st, cl = z(2, 5, 4, 16), torch.tensor([0, 3]), torch.tensor([5, 0])
    kc, m, acc = z(2, 32, 2, 16), z(4, 8, 2), z(4, 8, 2, 16)
    qf, kf, lse = z(1, 5, 4, 16), z(1, 5, 2, 16), z(1, 4, 5)
    xg, wg, og = z(3, 4, 8), z(3, 8, 6), z(3, 4, 6)
    rows = torch.tensor([1, 0, 4], dtype=torch.int32)
    xs, dt, bs, a = z(2, 3, 4, 8), z(2, 3, 4), z(2, 3, 4, 8), z(2)
    xw, ww, ow = z(4, 8), z(8, 3), z(4, 3)
    pa._report_decode(q, kp, bt, pos, None, (q,))       # no trace: nothing
    with T.Trace() as tr:
        x = torch.ones(3)
        pa._report_decode(q, kp, bt, pos, None, (q,))
        pp._report_prefill(qc, kp, st, cl, None, (qc,))
        da._report(q, kc, pos, (q,))
        da._report_combine(m, m, acc, q)
        fa._report(qf, kf, kf, True, 0, (qf,))
        fa._report_bwd(qf, kf, kf, qf, qf, lse, True, 0, (qf, kf, kf))
        gm._report(xg, wg, rows, og)
        gm._report_bwd(xg, wg, rows, xg, wg)
        ssd._report(xs, dt, a, bs, bs, (xs,))
        ssd._report_bwd(xs, dt, a, bs, bs, xs, xs, (xs,))
        ws._report("ws_matmul", xw, ww, ow)
    flops = {k.name: k.flops for k in tr.kernels}
    # rows live 4 and 21 tokens (a position clipped to the table's 32)
    assert flops["paged_decode_attention"] == 4 * 4 * 16 * 25
    assert flops["paged_prefill_attention"] == 4 * 4 * 16 * 15
    assert flops["decode_attention"] == 4 * 4 * 16 * 25
    assert flops["flash_attention"] == 4 * 4 * 16 * 15
    assert flops["flash_attention_backward"] == 2.5 * 4 * 4 * 16 * 15
    assert flops["grouped_matmul"] == 2 * 5 * 8 * 6
    assert flops["grouped_matmul_backward"] == 4 * 5 * 8 * 6
    assert flops["ssd_intra_chunk"] == 6 * (2 * 10 * 16 + 2 * 4 * 8 * 8)
    assert flops["ws_matmul"] == 2 * 4 * 8 * 3
    assert len(tr.kernels) == 11
    # the reports' own reads are not the step's ops
    assert [op.name for op in tr.ops] == ["aten.ones.default"]
    assert x.sum() == 3


# --------------------------------------------------------- the probes

@pytest.mark.parametrize("fam", ["dense", "moe", "hybrid", "vlm"])
def test_bulk_attn_shapes_equal_the_reference(fam):
    cfg = TINY[fam]
    assert bulk_attn_shapes(port_cfg(cfg), **HLO_PROBE_GEOM) == \
        ref_bulk_shapes(cfg, **HLO_PROBE_GEOM)
    bf16 = port_cfg(cfg).replace(dtype="bfloat16")
    got = bulk_attn_shapes(bf16, **HLO_PROBE_GEOM)
    assert got[:3] == ref_bulk_shapes(cfg, **HLO_PROBE_GEOM)
    assert len(got) == 5 and all(s.startswith("bf16[") for s in got[3:])


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_the_plain_route_gathers_and_only_tokens_leave(which):
    """The reference's oracle check (tests/test_paged_attention.py): the
    plain route's step does gather the K/V; and (tests/test_sampling.py)
    int32 tokens, not (b, vocab) logits, leave the step."""
    cfg = port_cfg(TINY["dense"])
    b = HLO_PROBE_GEOM["max_batch"]
    gather, flat, partials = bulk_attn_shapes(cfg, **HLO_PROBE_GEOM)
    states = [None]
    if which == "decode":
        states.append(state_for_slots(b, [
            (i, SamplingParams(temperature=0.8, top_k=4, top_p=0.9, seed=i),
             i) for i in range(b)]))
    for st in states:
        tr = lowered_paged_hlo(cfg, which, device="cpu", sampling=st,
                               **HLO_PROBE_GEOM)
        types = tr.result_types()
        assert tr.allocates(gather) and flat in types
        assert partials not in types
        assert tr.kernels == [] and tr.transfers == []
        _, tokens = tr.output
        assert T.tensor_type(tokens) == f"s32[{b}]"
        assert tr.summary().bytes_by_shape[gather] > 0


def test_the_sharded_step_moves_only_summaries():
    """tests/test_sharded_serve.py:340-365 at its geometry: every
    cross-bank move (`collectives.hand`) is orders below a page bank."""
    cfg = port_cfg(TINY["dense"])
    mesh = make_mem_mesh(8, devices=["cpu"] * 8)
    geom = dict(max_batch=2, max_seq=512, page_size=32)
    C.STATS.reset()
    tr = lowered_sharded_hlo(cfg, mesh, "decode", device="cpu", **geom)
    hands = [c for c in tr.collectives if c.kind == T.HAND]
    assert hands, "the sharded decode step must merge partials"
    assert C.STATS.calls["hand"] >= len(hands)
    pps = (geom["max_batch"] * geom["max_seq"] // geom["page_size"]) // 8
    bank_bytes = (pps + 1) * geom["page_size"] * cfg.num_kv_heads \
        * cfg.head_dim * 4
    bulk_bytes = geom["max_batch"] * geom["max_seq"] * cfg.num_kv_heads \
        * cfg.head_dim * 4
    worst = max(c.result_bytes for c in hands)
    assert worst < bank_bytes / 2, (worst, bank_bytes)
    assert worst < bulk_bytes / 8, (worst, bulk_bytes)
    _, tokens = tr.output
    assert T.tensor_type(tokens) == f"s32[{geom['max_batch']}]"
    pre = lowered_sharded_hlo(cfg, mesh, "prefill", device="cpu", **geom)
    assert max(c.result_bytes for c in pre.collectives) < bank_bytes / 2


def test_attention_hlo_holds_the_plain_route_and_leaves_after_to_the_card():
    from repro_torch.benchmarks import serve_throughput as ST
    h = ST.attention_hlo(torch.device("cpu"))
    assert h["ok"]
    ref_keys = {f"{w}_{m}_{t}" for w in ("decode", "prefill")
                for m in ("bulk_attn_bytes", "hbm_bytes")
                for t in ("before", "after")}
    assert ref_keys | {"bulk_attn_shapes", "backend", "hbm_bytes_note"} \
        <= set(h)
    assert h["decode_bulk_attn_bytes_before"] > 0
    assert h["prefill_bulk_attn_bytes_before"] > 0
    assert h["decode_bulk_attn_bytes_after"] is None
    assert h["prefill_hbm_bytes_after"] is None
    assert "needs a CUDA card" in h["after"]


# ------------------------------------------ collectives on a dry mesh

def test_dry_collectives_move_nothing_and_count_their_bytes():
    mesh = Mesh((2, 4), ("data", "model"), ["meta"] * 8).bind_dry(5)
    g = mesh.group("model")
    assert (g.size, g.index, g.pg) == (4, 1, C.DRY)
    x = torch.empty(8, 3, device="meta")
    C.STATS.reset()
    with T.Trace() as tr:
        assert C.all_gather(x, g, dim=1).shape == (8, 12)
        assert C.all_reduce(x, mesh.group("data")).shape == (8, 3)
        assert C.reduce_scatter(x, g, dim=0).shape == (2, 3)
        assert C.ring_shift(x, g).shape == (8, 3)
    assert dict(C.STATS.calls) == {"all_gather": 1, "all_reduce": 1,
                                   "reduce_scatter": 1, "ring": 1}
    assert [(c.kind, c.result_type, c.group_size) for c in tr.collectives] \
        == [("all-gather", "f32[8,12]", 4), ("all-reduce", "f32[8,3]", 2),
            ("reduce-scatter", "f32[2,3]", 4),
            ("collective-permute", "f32[8,3]", 4)]
    s = tr.summary()
    assert s.collective_bytes["all-gather"] == 8 * 12 * 4 * 3 / 4
    assert s.collective_bytes["reduce-scatter"] == 2 * 3 * 4 * 3


# ------------------------------------------------ dryrun, roofline, inspect

def _reduced_production_record(tmp_path):
    out = tmp_path / "dr"
    rc = dryrun.main(["--arch", "yi-9b", "--shape", "train_4k", "--mesh",
                      "single", "--device", "meta", "--out", str(out),
                      "--override", "num_layers=2"])
    assert rc == 0
    with open(out / "yi-9b__train_4k__single.json") as f:
        return out, json.load(f)


def test_the_production_dry_run_writes_the_reference_record(tmp_path,
                                                            capsys):
    out, rec = _reduced_production_record(tmp_path)
    ref_keys = {"arch", "shape", "mesh", "mesh_shape", "ok", "meta",
                "model_flops", "memory_analysis", "cost_analysis", "hlo",
                "timing_s", "overrides"}
    assert ref_keys <= set(rec) and rec["ok"], rec.get("error")
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    h = rec["hlo"]
    assert set(h) == {"flops_per_device", "flops_raw_unscaled",
                      "bytes_read_per_device", "bytes_written_per_device",
                      "collective_bytes_per_device", "collective_count"}
    assert h["flops_per_device"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    coll = h["collective_bytes_per_device"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0 \
        and coll["reduce-scatter"] > 0
    assert rec["trace"]["collective_calls_by_name"]["fsdp_all_gather"] > 0
    # both targets
    tpu = roofline.row_from_record(rec, target="tpu-v5e")
    h100 = roofline.row_from_record(rec)
    assert h100.target == "h100" and tpu.target == "tpu-v5e"
    assert h100.compute_s == pytest.approx(h["flops_per_device"] / 989e12)
    assert tpu.compute_s == pytest.approx(h["flops_per_device"] / 197e12)
    assert h100.chips == 256 and 0 < h100.useful_ratio
    assert roofline.main(["--dryrun-dir", str(out), "--target",
                          "tpu-v5e"]) == 0
    assert "| yi-9b | train_4k |" in capsys.readouterr().out
    # the tables script
    spec = importlib.util.spec_from_file_location(
        "fill_experiments_torch", ROOT / "scripts" / "fill_experiments_torch.py")
    fill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fill)
    tables = tmp_path / "tables.md"
    assert fill.main(["--dryrun-dir", str(out), "--out", str(tables)]) == 0
    text = tables.read_text()
    assert "| yi-9b | train_4k | single | meta |" in text
    assert "memory-bound" in text or "compute-bound" in text \
        or "collective-bound" in text


def test_the_stationarity_audit_of_a_sharded_step():
    from repro_torch.configs import get_arch
    from repro_torch.utils.tree import tree_leaves
    from repro_torch.launch.mesh import make_production_mesh
    spec = dryrun.apply_overrides(get_arch("yi-9b"), {"num_layers": 1})
    mesh = make_production_mesh()
    cell = build_cell("yi-9b", "train_4k", mesh, spec=spec)
    tr = lower_cell(cell, mesh)
    # this rank's parameter shards; their data-axis gathers are FSDP's
    shards = {T.nbytes(t) for t in tree_leaves(cell.args[0].params)}
    fsdp = {c.result_bytes for c in tr.collectives
            if c.name == "fsdp_all_gather"}
    rep = PD.audit_collective_records(tr.collectives, shards, fsdp)
    total = sum(c.result_bytes for c in tr.collectives
                if c.kind in T.COLLECTIVE_KINDS)
    assert rep.param_collective_bytes + rep.fsdp_gather_bytes \
        + rep.activation_collective_bytes == total > 0
    assert rep.fsdp_gather_bytes > 0 and rep.activation_collective_bytes > 0
    assert 0 < rep.stationarity_fraction <= 1.0


def test_inspect_prints_the_top_tables(capsys):
    # yi-9b's own rules are sequence-parallel, whose step all-reduces no
    # activation over "model"; the default rules' tensor-parallel one
    # does (tp_all_reduce)
    s = port_inspect.profile("yi-9b", "train_4k", "single",
                             {"num_layers": 1, "rules": "default"}, top=5,
                             device="meta")
    out = capsys.readouterr().out
    for part in ("terms (h100-sxm5-80gb)", "top collectives",
                 "top traffic", "top matmuls", "tp_all_reduce"):
        assert part in out
    assert s.flops > 0


def test_the_card_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("internlm2-1.8b", "decode_card", "one", "")
    with pytest.raises(ValueError, match="production mesh"):
        dryrun.run_cell("yi-9b", "train_4k", "single", "", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lowered_paged_hlo(port_cfg(TINY["dense"]), "decode",
                          **HLO_PROBE_GEOM)


def test_a_cpu_record_runs_the_step_for_real(tmp_path):
    """A reduced cell on the CPU: the step runs, the record carries its
    trace; `measured` is the card's only."""
    rec = dryrun.run_cell("internlm2-1.8b", "decode_card", "one",
                          str(tmp_path), {"num_layers": 1, "d_model": 64,
                                          "num_heads": 4, "num_kv_heads": 2,
                                          "head_dim": 16, "d_ff": 128,
                                          "vocab_size": 256},
                          device="cpu")
    assert rec["ok"], rec.get("error")
    assert "measured" not in rec and rec["hlo"]["flops_per_device"] > 0
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0   # the cache
