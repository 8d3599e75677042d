"""The port's XLA tools that read text and configs, held to the
reference's outputs: `launch/hlo_analysis.py`, `core/dataflow.py` and
`launch/roofline.py` on the reference tests' own inputs
(`tests/test_launch.py`'s SYNTH_HLO and record, `tests/test_sharding.py`'s
strings) and on the HLO text of small programs compiled by jax here;
the H100 target and the MFU; `core/hwmodel.py`'s `TpuTarget`; the spec
builders of `configs/base.py` and `cells.py`'s model-FLOPs accounting
for every arch and shape.  Equality is exact throughout."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import (SHAPES as REF_SHAPES, all_archs as ref_archs,
                           applicable_cells as ref_cells,
                           input_specs as ref_input_specs,
                           param_specs as ref_param_specs,
                           shape_applicable as ref_applicable)
from repro.core import dataflow as RD
from repro.core import hwmodel as RHW
from repro.launch import cells as RC
from repro.launch import hlo_analysis as RH
from repro.launch import roofline as RR
from repro.launch.mesh import make_mesh as ref_make_mesh

from repro_torch import core as port_core
from repro_torch.configs import (SHAPES, all_archs, applicable_cells,
                                 cache_specs, input_specs, param_specs,
                                 prefill_batch_specs, shape_applicable)
from repro_torch.configs.base import decode_token_specs
from repro_torch.configs import sunrise_chip
from repro_torch.core import dataflow as PD
from repro_torch.core import hwmodel as PHW
from repro_torch.launch import cells as PC
from repro_torch.launch import hlo_analysis as PH
from repro_torch.launch import roofline as PR
from repro_torch.models.convert import stacked_axes
from repro_torch.utils.tree import tree_num_params, tree_size_bytes
from test_launch import SYNTH_HLO
from torch_port_helpers import one_torch_thread  # noqa: F401

# tests/test_sharding.py's strings
SHARDING_HLO = '''
ENTRY %main (p: f32[8,64]) -> f32[8,64] {
  %ag = f32[8,64]{1,0} all-gather(%p), dimensions={1}
  ROOT %ar = f32[8,64]{1,0} all-reduce(%ag), to_apply=%add
}
'''
SHAPE_STRINGS = ("f32[8,64]{1,0}", "(s32[], f32[2,2])", "bf16[10]",
                 "bf16[16,1024]", "f32[8]", "(f32[2,2], s8[4])",
                 "f8e4m3fn[3,5]", "pred[7]", "u32[]", "token[]")
# tests/test_launch.py's record
RECORD = {
    "arch": "x", "shape": "train_4k", "mesh": "single",
    "mesh_shape": {"data": 16, "model": 16}, "ok": True,
    "hlo": {
        "flops_per_device": 197e12,
        "bytes_read_per_device": 819e9 / 2,
        "bytes_written_per_device": 819e9 / 2,
        "collective_bytes_per_device": {"all-reduce": 100e9},
    },
    "memory_analysis": {"argument_size_in_bytes": 1e9,
                        "temp_size_in_bytes": 2e9},
    "model_flops": 197e12 * 256 * 0.5,
}
ROW_PROPS = ("dominant", "step_s", "useful_ratio", "roofline_fraction",
             "bw_fraction")


def _compiled_texts():
    """HLO text of two small programs compiled here: test_sharding's
    Megatron pair on a (1, 1) mesh, and a scanned MLP (a while loop with
    a known trip count, dots and a convolution)."""
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    w1 = jax.ShapeDtypeStruct((64, 256), jnp.float32)
    w2 = jax.ShapeDtypeStruct((256, 64), jnp.float32)
    x = jax.ShapeDtypeStruct((8, 64), jnp.float32)

    def tp(x, w1, w2):
        return jax.nn.relu(x @ w1) @ w2

    def sh(spec):
        return NamedSharding(mesh, spec)
    tp_text = jax.jit(tp, in_shardings=(
        sh(P("data", None)), sh(P(None, "model")), sh(P("model", None))
    )).lower(x, w1, w2).compile().as_text()

    def scanned(x, ws, k):
        def body(h, w):
            h = jnp.tanh(h @ w)
            return h, h.sum()
        h, sums = jax.lax.scan(body, x, ws)
        img = h.reshape(1, 8, 8, 8)
        c = jax.lax.conv_general_dilated(img, k, (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO",
                                                            "NHWC"))
        return c.sum() + sums.sum()
    scan_text = jax.jit(scanned).lower(
        jax.ShapeDtypeStruct((8, 64), jnp.float32),
        jax.ShapeDtypeStruct((6, 64, 64), jnp.float32),
        jax.ShapeDtypeStruct((3, 3, 8, 4), jnp.float32)).compile().as_text()
    return {"tp": tp_text, "scan": scan_text}


@pytest.fixture(scope="module")
def compiled():
    """The module's one batch of reference compiles."""
    return _compiled_texts()


# ------------------------------------------------------------ hlo_analysis

@pytest.mark.parametrize("s", SHAPE_STRINGS)
def test_shape_parsing_equals_the_reference(s):
    assert PH.shape_dims(s) == RH.shape_dims(s)
    assert PH.shape_bytes(s) == RH.shape_bytes(s)
    assert PD.parse_shape_bytes(s) == RD.parse_shape_bytes(s)


def _program(mod, text):
    prog = mod.parse_hlo(text)
    ops = {n: (o.name, o.opcode, o.result_type, o.args, o.attrs,
               o.computation, o.result_bytes, o.group_size, o.wire_bytes,
               o.result_elems) for n, o in prog.ops.items()}
    return ops, prog.comps, prog.entry, prog.multipliers


def _summary(mod, text):
    s = mod.summarize(text)
    return (dataclasses.asdict(s), s.hbm_bytes, s.total_collective_bytes)


@pytest.mark.parametrize("which", ["synth", "sharding", "tp", "scan"])
def test_hlo_analysis_equals_the_reference(which, compiled):
    text = {"synth": SYNTH_HLO, "sharding": SHARDING_HLO, **compiled}[which]
    assert _program(PH, text) == _program(RH, text)
    assert _summary(PH, text) == _summary(RH, text)
    prog = PH.parse_hlo(text)
    rprog = RH.parse_hlo(text)
    for name, op in prog.ops.items():
        if op.opcode == "dot":
            assert PH._dot_flops(prog, op) == RH._dot_flops(rprog,
                                                          rprog.ops[name])
        if op.opcode == "convolution":
            assert PH._conv_flops(prog, op) == RH._conv_flops(
                rprog, rprog.ops[name])
    assert PH.COLLECTIVE_KINDS == RH.COLLECTIVE_KINDS


def test_the_synthetic_program_reads_as_the_reference_tests_say():
    s = PH.summarize(SYNTH_HLO)
    assert s.flops == 6 * 2 * 8 * 64 * 64
    r = 8 * 64 * 4
    assert s.collective_bytes["all-gather"] == pytest.approx(6 * r * 3 / 4)
    assert s.collective_bytes["all-reduce"] == pytest.approx(r)


def test_the_scanned_program_scales_its_loop(compiled):
    prog = PH.parse_hlo(compiled["scan"])
    assert 6.0 in prog.multipliers.values()
    s = PH.summarize(compiled["scan"])
    assert s.flops > s.raw_flops > 0


# ---------------------------------------------------------------- dataflow

@pytest.mark.parametrize("which", ["synth", "sharding", "tp", "scan"])
def test_dataflow_audit_equals_the_reference(which, compiled):
    text = {"synth": SYNTH_HLO, "sharding": SHARDING_HLO, **compiled}[which]
    assert [dataclasses.asdict(o) for o in PD.parse_collectives(text)] == \
        [dataclasses.asdict(o) for o in RD.parse_collectives(text)]
    param_bytes = {64 * 256 * 4, 256 * 64 * 4, 64 * 16 * 4, 16 * 64 * 4,
                   8 * 64 * 4}
    for fsdp in (frozenset(), frozenset({8 * 64 * 4})):
        got = PD.audit_stationarity(text, param_bytes, fsdp)
        want = RD.audit_stationarity(text, param_bytes, fsdp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.stationarity_fraction == want.stationarity_fraction


def test_the_audit_of_collective_records_attributes_bytes_alike():
    """The port-side entry: the same attribution from a trace's records
    as from the text whose collectives they describe."""
    from repro_torch.launch.trace import CollectiveRecord
    recs = [CollectiveRecord("all-gather", "fsdp_all_gather", "f32[8,64]",
                             2048, 4),
            CollectiveRecord("all-reduce", "tp_all_reduce", "f32[8,64]",
                             2048, 2),
            CollectiveRecord("hand", "hand", "f32[2,4]", 32, 1)]
    got = PD.audit_collective_records(recs, {2048}, frozenset({2048}))
    want = RD.audit_stationarity(SHARDING_HLO, {2048}, frozenset({2048}))
    assert (got.fsdp_gather_bytes, got.param_collective_bytes,
            got.activation_collective_bytes) == (
        want.fsdp_gather_bytes, want.param_collective_bytes,
        want.activation_collective_bytes)
    assert [o.kind for o in got.ops] == [o.kind for o in want.ops]


# ---------------------------------------------------------------- roofline

def _row(mod, rec, **kw):
    r = mod.row_from_record(rec, **kw)
    fields = {f.name: getattr(r, f.name)
              for f in dataclasses.fields(RR.RooflineRow)}
    return fields, {p: getattr(r, p) for p in ROW_PROPS}


def _records():
    fail = dict(RECORD, ok=False, error="boom")
    multi = dict(RECORD, mesh="multi",
                 mesh_shape={"pod": 2, "data": 16, "model": 16})
    mem = dict(RECORD, hlo=dict(RECORD["hlo"],
                                collective_bytes_per_device={}),
               model_flops=1e9)
    comp = dict(RECORD, hlo=dict(RECORD["hlo"], flops_per_device=1e16,
                                 collective_bytes_per_device={}))
    return [RECORD, fail, multi, mem, comp]


@pytest.mark.parametrize("i", range(5))
def test_roofline_rows_equal_the_reference(i):
    rec = _records()[i]
    assert _row(PR, rec) == _row(RR, rec)
    assert _row(PR, rec, target=PHW.TPU_V5E) == _row(RR, rec)
    if rec["ok"]:
        assert PR.advice(PR.row_from_record(rec)) == \
            RR.advice(RR.row_from_record(rec))


def test_roofline_tables_and_loading_equal_the_reference(tmp_path, capsys):
    for i, rec in enumerate(_records()):
        with open(tmp_path / f"a{i}__s__{rec['mesh']}.json", "w") as f:
            json.dump(rec, f)
    for mesh in ("single", "multi"):
        prow = PR.load_rows(str(tmp_path), mesh)
        rrow = RR.load_rows(str(tmp_path), mesh)
        assert [dataclasses.astuple(r)[:12] for r in prow] == \
            [dataclasses.astuple(r) for r in rrow]
        assert PR.markdown_table(prow) == RR.markdown_table(rrow)
    for x in (0, 3e-7, 5e-4, 0.02, 0.999, 1.0, 12.345):
        assert PR.fmt_s(x) == RR.fmt_s(x)
    PR.main(["--dryrun-dir", str(tmp_path)])
    port_out = capsys.readouterr().out
    RR.main(["--dryrun-dir", str(tmp_path)])
    assert port_out == capsys.readouterr().out
    PR.main(["--dryrun-dir", str(tmp_path), "--json"])
    port_json = json.loads(capsys.readouterr().out)
    RR.main(["--dryrun-dir", str(tmp_path), "--json"])
    ref_json = json.loads(capsys.readouterr().out)
    assert [{k: r[k] for k in q} for r, q in zip(port_json, ref_json)] == \
        ref_json


def test_the_h100_target_and_the_mfu():
    """The H100 row: the datasheet's constants (989 TFLOP/s bf16, 67 f32,
    3.35 TB/s, NVLink 4 at 450 GB/s); a measured step gives the MFU."""
    h = PHW.H100
    assert (h.peak_flops_bf16, h.peak_flops_f32, h.hbm_bw_Bps, h.hbm_bytes,
            h.ici_link_Bps) == (989e12, 67e12, 3.35e12, 80e9, 450e9)
    row = PR.row_from_record(RECORD, target="h100")
    assert row.compute_s == pytest.approx(197e12 / 989e12)
    assert row.memory_s == pytest.approx(819e9 / 3.35e12)
    assert row.collective_s == pytest.approx(100e9 / 450e9)
    assert row.mfu is None
    card = dict(RECORD, target="h100", mesh="one", mesh_shape={},
                measured={"step_s": 2.0}, meta={"dtype": "bfloat16"})
    row = PR.row_from_record(card)
    assert row.target == "h100" and row.chips == 1
    assert row.mfu == pytest.approx(RECORD["model_flops"] / (2.0 * 989e12))
    f32 = dict(card, meta={"dtype": "float32"})
    assert PR.row_from_record(f32).mfu == pytest.approx(
        RECORD["model_flops"] / (2.0 * 67e12))
    # the same record against the reference's target
    tpu = PR.row_from_record(card, target="tpu-v5e")
    assert tpu.mfu == pytest.approx(RECORD["model_flops"] / (2.0 * 197e12))
    table = PR.markdown_table([row])
    assert "MFU" in table and f"{row.mfu:.2%}" in table


# ---------------------------------------------------- hwmodel and configs

def test_the_tpu_target_equals_the_reference():
    assert dataclasses.asdict(PHW.TPU_V5E) == dataclasses.asdict(RHW.TPU_V5E)
    assert dataclasses.asdict(PHW.TpuTarget()) == \
        dataclasses.asdict(RHW.TpuTarget())
    assert port_core.TPU_V5E is PHW.TPU_V5E
    assert sunrise_chip.TARGET is PHW.TPU_V5E
    assert PHW.TARGETS["tpu-v5e"] is PHW.TPU_V5E


def test_the_cells_and_the_skip_table_equal_the_reference():
    assert applicable_cells(all_archs()) == ref_cells(ref_archs())
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    for name, spec in all_archs().items():
        rspec = ref_archs()[name]
        for s in SHAPES:
            assert shape_applicable(spec.model, SHAPES[s]) == \
                ref_applicable(rspec.model, REF_SHAPES[s])


def _port_leaves(tree, cfg=None, name=""):
    """{path: (shape, dtype)} of the port's tree, the stacked keys
    restacked over their leading axes as the reference stores them."""
    out = {}
    stacked = stacked_axes(cfg) if cfg is not None else {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            path = f"{name}/{k}" if name else k
            out.update(_port_leaves(_restack(v) if k in stacked and not name
                                    else v, None, path))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, None, f"{name}/{i}"))
    else:
        out[name] = (tuple(tree.shape), str(tree.dtype).split(".")[-1])
    return out


def _restack(parts):
    first = parts[0] if isinstance(parts, list) else parts
    if not isinstance(parts, list):
        return parts
    inner = [_restack(p) for p in parts]
    first = inner[0]
    if isinstance(first, dict):
        return {k: _restack_list([p[k] for p in inner]) for k in first}
    return _restack_list(inner)


def _restack_list(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: _restack_list([p[k] for p in items]) for k in first}
    return torch.empty((len(items),) + tuple(first.shape), dtype=first.dtype,
                       device="meta")


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


@pytest.fixture(scope="module")
def ref_counts():
    """The reference's param specs and model-FLOPs figures of every arch
    and applicable shape (one pass of its eval_shape inits)."""
    out = {}
    for name, spec in ref_archs().items():
        cfg = spec.model
        figs = {"params": _ref_leaves(ref_param_specs(cfg)),
                "active": RC.active_params(cfg)}
        for s, shape in REF_SHAPES.items():
            figs[s] = RC.model_flops(cfg, shape)
            for b, sq, skv, train in ((2, 128, 128, True), (3, 1, 512, False)):
                figs[(b, sq, skv, train)] = RC.attention_flops(cfg, b, sq,
                                                               skv, train)
        out[name] = figs
    return out


@pytest.mark.parametrize("arch", list(all_archs()))
def test_param_specs_and_model_flops_equal_the_reference(arch, ref_counts):
    spec = all_archs()[arch]
    cfg = spec.model
    want = ref_counts[arch]
    p = param_specs(cfg)
    assert all(t.device.type == "meta" for t in
               _flat_tensors(p))
    assert _port_leaves(p, cfg) == want["params"]
    assert tree_num_params(p) == sum(np.prod(s) for s, _ in
                                     want["params"].values())
    assert tree_size_bytes(p) > 0
    assert PC.active_params(cfg) == want["active"]
    for s, shape in SHAPES.items():
        assert PC.model_flops(cfg, shape) == want[s]
    for key in ((2, 128, 128, True), (3, 1, 512, False)):
        assert PC.attention_flops(cfg, *key) == want[key]


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat_tensors(v)]
    return [tree]


@pytest.mark.parametrize("arch", list(all_archs()))
def test_input_specs_equal_the_reference_leaf_for_leaf(arch):
    spec, rspec = all_archs()[arch], ref_archs()[arch]
    for s, shape in SHAPES.items():
        if not shape_applicable(spec.model, shape)[0]:
            continue
        got = input_specs(spec.model, shape)
        want = ref_input_specs(rspec.model, REF_SHAPES[s])
        assert _port_leaves(got) == _ref_leaves(want), (arch, s)
        assert all(t.device.type == "meta" for t in _flat_tensors(got))
    shape = SHAPES["decode_32k"]
    assert tuple(decode_token_specs(shape).shape) == (128,)
    assert decode_token_specs(shape).dtype == torch.int32
    if spec.model.family != "encoder":
        assert _port_leaves(cache_specs(spec.model, 2, 64)) == _ref_leaves(
            ref_input_specs(rspec.model, dataclasses.replace(
                REF_SHAPES["decode_32k"], seq_len=64, global_batch=2)
            )["cache"])
    assert _port_leaves(prefill_batch_specs(spec.model,
                                            SHAPES["prefill_32k"])) == \
        _ref_leaves(ref_input_specs(rspec.model,
                                    REF_SHAPES["prefill_32k"])["batch"])
