"""The port's sharding rules against the reference's, with no process
group: spec resolution on abstract meshes, every family's parameter and
optimizer-state axes leaf by leaf, the shard/unshard arithmetic of a
`NamedSharding`, and the elastic plan."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import jax

from conftest import TINY
from torch_port_helpers import port_cfg

from repro.configs import get_arch as ref_arch
from repro.distribution import sharding as RS
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models import registry as ref_registry
from repro.train import elastic as RE
from repro.train import train_step as RTS
from repro.train.optimizer import OptimizerConfig as RefOptConfig
from repro.train.optimizer import make_optimizer as ref_optimizer

from repro_torch.configs import get_arch
from repro_torch.distribution import sharding as S
from repro_torch.distribution.sharding import P
from repro_torch.launch.mesh import (dp_width, make_abstract_mesh,
                                     make_production_mesh)
from repro_torch.models import registry
from repro_torch.train import elastic as E
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.utils.tree import named_groups

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
TABLES = {"default": S.DEFAULT_RULES, "seq_parallel": S.SEQUENCE_PARALLEL_RULES}
DIMS = [1, 2, 3, 7, 15, 16, 17, 32, 96, 100, 256, 1000, 4096, 65536,
        (1 << 20) - 1, 1 << 20]
MESH_1POD = make_abstract_mesh((16, 16), ("data", "model"))
MESH_2POD = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
RULES = S.AxisRules(dict(S.DEFAULT_RULES))


def _meshes(key):
    shape, axes = MESHES[key]
    return make_abstract_mesh(shape, axes), ref_abstract_mesh(shape, axes)


def _rules(key):
    return S.AxisRules(dict(TABLES[key])), RS.AxisRules(dict(TABLES[key]))


# ---------------------------------------- the reference's cases, ported

def test_the_rule_tables_are_the_reference_s():
    assert S.DEFAULT_RULES == RS.DEFAULT_RULES
    assert S.SEQUENCE_PARALLEL_RULES == RS.SEQUENCE_PARALLEL_RULES


def test_basic_resolution_single_pod():
    spec = S.logical_to_spec(("embed", "mlp"), (8192, 22016), MESH_1POD,
                             RULES)
    assert spec == P("data", "model")


def test_batch_uses_pod_and_data_on_multipod():
    spec = S.logical_to_spec(("act_batch", "act_seq"), (256, 4096),
                             MESH_2POD, RULES)
    assert spec == P(("pod", "data"), None)


def test_divisibility_fallback_replicates():
    spec = S.logical_to_spec(("embed", "kv_heads"), (8192, 8), MESH_1POD,
                             RULES)
    assert spec == P("data", None)


def test_axis_used_at_most_once():
    spec = S.logical_to_spec(("mlp", "heads"), (4096, 4096), MESH_1POD,
                             RULES)
    assert spec == P("model", None)


def test_unknown_axis_raises():
    with pytest.raises(KeyError):
        S.logical_to_spec(("nonsense",), (8,), MESH_1POD, RULES)


def test_seq_parallel_rules_shard_seq():
    rules = S.AxisRules(dict(S.SEQUENCE_PARALLEL_RULES))
    spec = S.logical_to_spec(("act_batch", "act_seq", "act_embed"),
                             (256, 4096, 8192), MESH_1POD, rules)
    assert spec == P("data", "model", None)


def test_no_mesh_replicates_everything():
    assert S.logical_to_spec(("embed", "mlp"), (8, 8)) == P(None, None)


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_axis_and_size_resolves_as_the_reference(mesh, table):
    """Every logical name at every size: the port's spec is the
    reference's, and its axis product divides the dimension."""
    pm, rm = _meshes(mesh)
    pr, rr = _rules(table)
    for name in TABLES[table]:
        for dim in DIMS:
            got = S.logical_to_spec((name,), (dim,), pm, pr)
            assert tuple(got) == tuple(RS.logical_to_spec((name,), (dim,),
                                                          rm, rr)), (name, dim)
            axes = S.spec_axes(got[0])
            prod = int(np.prod([pm.shape[a] for a in axes]))
            assert dim % prod == 0 and dim >= prod


@pytest.mark.parametrize("seed", range(50))
def test_random_logical_shapes_resolve_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    names = list(rng.choice(list(S.DEFAULT_RULES), rng.integers(1, 5)))
    shape = tuple(int(rng.choice([1, 8, 16, 64, 256, 4096])) for _ in names)
    for mesh in MESHES:
        pm, rm = _meshes(mesh)
        for table in TABLES:
            pr, rr = _rules(table)
            got = S.logical_to_spec(tuple(names), shape, pm, pr)
            assert tuple(got) == tuple(RS.logical_to_spec(
                tuple(names), shape, rm, rr))
            used = [a for e in got for a in S.spec_axes(e)]
            assert len(used) == len(set(used)), f"reused mesh axis {got}"


def test_meshes_match_the_reference():
    pm = make_production_mesh(multi_pod=True)
    assert pm.shape == {"pod": 2, "data": 16, "model": 16} and pm.size == 512
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert dp_width(pm) == 32
    assert dp_width(MESH_1POD) == 16


def test_with_logical_constraint_changes_nothing():
    x = torch.arange(12.0).reshape(3, 4)
    with S.use_mesh(MESH_1POD):
        assert S.with_logical_constraint(x, "act_batch", "act_embed") is x
        with pytest.raises(KeyError):
            S.with_logical_constraint(x, "act_batch", "nonsense")


# ------------------------------------------ shard / unshard arithmetic

@pytest.mark.parametrize("spec", [P("data", "model"), P(("data", "model"),
                                                          None),
                                  P(None, "model"), P(None, None)])
def test_shard_and_unshard_round_trip(spec):
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    sh = S.NamedSharding(mesh, spec)
    shards = {r: sh.shard(full, r) for r in range(mesh.size)}
    for r, s in shards.items():
        assert tuple(s.shape) == sh.shard_shape(full.shape)
    assert torch.equal(sh.unshard(shards), full)
    # a dimension over (data, model) is cut major first, as jax lays it out
    if spec == P(("data", "model"), None):
        assert torch.equal(shards[mesh.rank_at({"data": 1, "model": 2})],
                           full[6:7])


def test_local_rows_cover_each_microbatch_once():
    rows = [TS.local_rows(16, 2, i, 4) for i in range(4)]
    assert sorted(sum(rows, [])) == list(range(16))
    assert rows[1] == [2, 3, 10, 11]


# ------------------------------------------------ the models' logical axes

def _ref_axes(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): tuple(ax) for path, ax in flat}


def _port_axes(tree) -> dict:
    return {n: (tuple(parts[0]), len(lead))
            for n, parts, lead in named_groups(tree)}


def _check_family(ref_cfg, meshes):
    cfg = port_cfg(ref_cfg)
    got = _port_axes(registry.get_family(cfg).param_axes(cfg))
    want = _ref_axes(ref_registry.get_family(ref_cfg).param_axes(ref_cfg))
    assert set(got) == set(want)
    p_shapes = {n: (tuple(parts[0].shape), lead) for n, parts, lead in
                named_groups(TS.state_shapes(cfg, make_optimizer(
                    OptimizerConfig())).params)}
    r_shapes = dict(
        (n, tuple(x.shape)) for n, x in
        _flat_shapes(jax.eval_shape(lambda k: ref_registry.get_family(
            ref_cfg).init(k, ref_cfg), jax.random.key(0))))
    for name, (axes, nlead) in got.items():
        # the reference's stacked axes: "stage" once per list level
        assert want[name] == ("stage",) * nlead + axes, name
        shape, lead = p_shapes[name]
        assert tuple(lead) + shape == r_shapes[name], name
        for pm, rm in meshes:
            spec = S.logical_to_spec(axes, shape, pm)
            ref = RS.logical_to_spec(want[name], r_shapes[name], rm)
            assert tuple(spec) == tuple(ref)[nlead:], (name, spec, ref)


def _flat_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(p, "key", getattr(p, "name", p)))
                      for p in path), x) for path, x in flat]


@pytest.mark.parametrize("fam", list(TINY))
def test_param_axes_and_specs_match_the_reference(fam):
    _check_family(TINY[fam], [_meshes("2x4"), _meshes("1x4"),
                              _meshes("2x16x16")])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b",
                                  "zamba2-2.7b", "mamba2-130m"])
def test_full_size_param_specs_match_the_reference(arch):
    _check_family(ref_arch(arch).model, [_meshes("16x16"),
                                         _meshes("2x16x16")])


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgdm"])
@pytest.mark.parametrize("fam", ["dense", "moe", "hybrid"])
def test_state_axes_and_specs_match_the_reference(fam, opt):
    """The optimizer state's logical axes (stacked, as the reference's)
    and their specs on a (2, 4) mesh; Adafactor factors TINY's matrices
    at min_dim_size_to_factor 16, so its factored moments are held too."""
    ref_cfg = TINY[fam]
    cfg = port_cfg(ref_cfg)
    kw = dict(name=opt, min_dim_size_to_factor=16)
    popt, ropt = make_optimizer(OptimizerConfig(**kw)), \
        ref_optimizer(RefOptConfig(**kw))
    got = TS.state_logical_axes(cfg, popt)
    want = RTS.state_logical_axes(ref_cfg, ropt)
    got_o = {n: tuple(parts[0]) for n, parts, _ in
             named_groups(got.opt_state)}
    want_o = _ref_axes(want.opt_state)
    assert got_o == want_o
    if opt == "adafactor":
        assert any(n.endswith("/vr") for n in got_o)
    pm, rm = _meshes("2x4")
    shapes = TS.state_shapes(cfg, popt)
    sh = TS.state_shardings(cfg, popt, pm, shapes=shapes)
    ref_shapes = dict(_flat_shapes(RTS.state_shapes(ref_cfg, ropt).opt_state))
    for name, parts, _ in named_groups(sh.opt_state):
        ref = RS.logical_to_spec(want_o[name], tuple(ref_shapes[name].shape),
                                 rm)
        assert tuple(parts[0].spec) == tuple(ref), name


# ----------------------------------------------------- the elastic plan

@pytest.mark.parametrize("global_batch", [1, 6, 8, 12, 64, 96])
def test_elastic_plan_matches_the_reference(global_batch):
    for dp in (1, 2, 3, 4, 8, 16):
        for cap in (0, 1, 2, 3, 5, 8):
            try:
                want = RE.elastic_plan(global_batch, dp, cap)
            except RE.ElasticError:
                with pytest.raises(E.ElasticError):
                    E.elastic_plan(global_batch, dp, cap)
                continue
            got = E.elastic_plan(global_batch, dp, cap)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.device_batch_total * got.grad_accum == global_batch
