"""The port's sharded step in the layouts the reference's constraints
resolve to, held against the reference's single-device step, in one
4-rank gloo world on the CPU.

The module-scoped `world` fixture spawns ONE world of 4 ranks running
`torch_seq_ranks.cases` (torch and repro_torch only) while this process
computes the reference's side.  Every case starts from the reference's
weights (carried across by `models.convert.params_from_jax`) and is held
to the reference's single-device `make_train_step` at PR 35's bounds
(loss 2e-4; params rtol 2e-3 / atol 2e-4, f32).  The ssm and hybrid
cases run `ssd_impl="xla"` in the reference and the SSD route
(`"pallas"`, the kernel's plain version here) in the port.

  * sequence parallel (`rules="seq_parallel"`): TINY dense on (2, 2) and
    (1, 4), moe under "ep" on (1, 4) at the shipped capacity factor (the
    tokens gathered before routing, so capacity and drops are the single
    device's), ssm on (1, 4) with 12 positions a rank and chunks of 8 (a
    padded last chunk, the conv halo and the state carry across ranks),
    hybrid on (1, 4), vlm on (2, 2) (patch rows whole, the fused trunk
    cut), and TINY dense at 30 positions on (1, 4), which do not divide:
    the default layout (heads over "model"), as the reference's ladder
    falls back;
  * the default rules: ssm on (1, 4) (one Mamba head a rank), hybrid on
    (2, 2) (the Mamba heads and the shared block's heads and columns
    split) and the encoder on (2, 2).

The layout tests read each case's layout log (`sharding.Layout`): every
constraint site of the sharded forward, in order, beside the same site
of a single-device run of the port on the first global microbatch, whose
shape is the site's global shape.  The reference's `logical_to_spec` on that
shape and the reference's mesh must give the spec the port checked, and
the local shape times the mesh sizes on each dimension must give the
global shape.

Without a world: the Mamba state carry (`mamba2.carry_in`,
`ssd_initial_term`) joining four pieces of a sequence against one scan,
forward and gradients.
"""
from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax

from conftest import TINY, tiny_batch
from torch_port_helpers import np_tree, one_torch_thread  # noqa: F401
from torch_port_helpers import port_cfg, port_params
import torch_seq_ranks as R

from repro.distribution import sharding as RS
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models import registry as ref_registry
from repro.train import train_step as RTS
from repro.train.optimizer import OptimizerConfig as RefOptConfig
from repro.train.optimizer import make_optimizer as ref_optimizer
from repro.utils.tree import tree_flatten_with_names as ref_names

from repro_torch.distribution.sharding import record_sites
from repro_torch.launch.world import run_world
from repro_torch.models import mamba2 as M
from repro_torch.models import registry

WORLD_TIMEOUT = 240          # seconds for the whole 4-rank world
LOSS_TOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4

# name: (family, mesh, rules, seq, rows, grad_accum, steps, cfg changes)
CASES = {
    "dense_seq_2x2": ("dense", (2, 2), "seq_parallel", 32, 4, 2, 2, {}),
    "dense_seq_1x4": ("dense", (1, 4), "seq_parallel", 32, 4, 1, 1,
                      dict(remat="full", logits_chunk=16)),
    "dense_fallback_1x4": ("dense", (1, 4), "seq_parallel", 30, 2, 1, 1, {}),
    "moe_seq_1x4": ("moe", (1, 4), "seq_parallel", 32, 4, 1, 1,
                    dict(moe_dispatch="ep")),
    "ssm_heads_1x4": ("ssm", (1, 4), "default", 32, 2, 1, 1, {}),
    "ssm_seq_1x4": ("ssm", (1, 4), "seq_parallel", 48, 2, 1, 1,
                    dict(ssm_chunk=8)),
    "hybrid_heads_2x2": ("hybrid", (2, 2), "default", 32, 4, 1, 1, {}),
    "hybrid_seq_1x4": ("hybrid", (1, 4), "seq_parallel", 32, 2, 1, 1, {}),
    "vlm_seq_2x2": ("vlm", (2, 2), "seq_parallel", 24, 4, 1, 1, {}),
    "encoder_heads_2x2": ("encoder", (2, 2), "default", 32, 4, 1, 1, {}),
}
SEQ = [n for n, c in CASES.items() if c[2] == "seq_parallel"
       and "fallback" not in n]


def _ref_cfg(name):
    fam, _, _, _, _, _, _, kw = CASES[name]
    return TINY[fam].replace(**kw)


def _port_cfg(name):
    cfg = port_cfg(_ref_cfg(name))
    if cfg.family in ("ssm", "hybrid"):
        cfg = cfg.replace(ssd_impl="pallas")
    return cfg


def _batch(name):
    _, _, _, seq, rows, _, _, _ = CASES[name]
    return {k: np.asarray(v) for k, v in
            tiny_batch(_ref_cfg(name), batch=rows, seq=seq, seed=3).items()}


def _names(tree) -> dict:
    return {n: np.asarray(x, np.float32) for n, x in ref_names(tree)}


def _reference(name, params, batch):
    """The reference's single-device steps: (losses, params after)."""
    _, _, _, _, _, ga, steps, _ = CASES[name]
    cfg = _ref_cfg(name)
    opt = ref_optimizer(RefOptConfig(**R.OPT))
    state = RTS.init_train_state(jax.random.key(0), cfg, opt)
    state = state.replace(params=params)
    step = jax.jit(RTS.make_train_step(cfg, opt, grad_accum=ga))
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, _names(state.params)


def _single_log(name, params, batch):
    """The port's single-device constraint sites on the batch's first
    microbatch (its forward, no gradient)."""
    cfg = _port_cfg(name)
    p = port_params(params, _ref_cfg(name))
    rows = CASES[name][4] // CASES[name][5]
    b = {k: torch.tensor(v[:rows]) for k, v in batch.items()}
    with torch.no_grad(), record_sites() as log:
        registry.get_family(cfg).loss_fn(p, cfg, b)
    return log


@pytest.fixture(scope="module")
def world():
    """(the reference's side per case, the ranks' results)."""
    rng = np.random.default_rng(0)
    ref_params, cases = {}, {}
    for i, name in enumerate(CASES):
        fam, shape, rules, _, _, ga, steps, _ = CASES[name]
        cfg = _ref_cfg(name)
        ref_params[name] = ref_registry.get_family(cfg).init(
            jax.random.key(i), cfg)
        cases[name] = {"cfg": dataclasses.asdict(_port_cfg(name)),
                       "mesh": shape, "rules": rules, "grad_accum": ga,
                       "steps": steps, "batch": _batch(name),
                       "params": np_tree(ref_params[name])}
    inp = {"cases": cases,
           "shift_x": rng.standard_normal((4, 3, 5)).astype(np.float32),
           "shift_w": rng.standard_normal((4, 3, 5)).astype(np.float32),
           "rs_x": rng.standard_normal((4, 2, 8, 3)).astype(np.float32),
           "rs_w": rng.standard_normal((4, 2, 2, 3)).astype(np.float32)}
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_world, R.cases, 4, (inp,),
                          timeout=WORLD_TIMEOUT)
        ref = {}
        for name in CASES:
            batch = cases[name]["batch"]
            ref[name] = (_reference(name, ref_params[name], batch),
                         _single_log(name, ref_params[name], batch))
        return inp, ref, ranks.result()


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_reference_single_device(world, name):
    _, ref, ranks = world
    (want_losses, want_params), _ = ref[name]
    got = ranks[0][name]
    assert np.abs(np.array(got["losses"]) - np.array(want_losses)).max() \
        < LOSS_TOL, (got["losses"], want_losses)
    assert set(got["params"]) == set(want_params)
    for k, want in want_params.items():
        np.testing.assert_allclose(got["params"][k], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@pytest.mark.parametrize("name", list(CASES))
def test_every_site_is_this_rank_s_block_of_the_reference_spec(world, name):
    """Each site of the sharded forward against the reference's
    `logical_to_spec` on the single device's global shape.  The "ep"
    dispatch's expert buffers are local to the reference's shard_map
    (no constraint there), while a single device falls back to the
    scatter, which constrains them: those single-device sites are left
    out of the pairing."""
    _, ref, ranks = world
    fam, shape, rules, _, _, _, _, _ = CASES[name]
    single = [s for s in ref[name][1] if s[0][0] != "act_expert"]
    ref_mesh = ref_abstract_mesh(shape, ("data", "model"))
    ref_rules = RS.AxisRules(dict(R.TABLES[rules]))
    for r in (0, 3):
        log = ranks[r][name]["log"]      # every microbatch's forward
        assert len(log) == CASES[name][5] * len(single) > 0
        for (axes1, full, _), (axes, local, spec) in zip(single, log):
            assert tuple(axes) == tuple(axes1)
            want = RS.logical_to_spec(tuple(axes), tuple(full), ref_mesh,
                                      ref_rules)
            assert tuple(spec) == tuple(want), (axes, full, spec, want)
            blocks = [math.prod(ref_mesh.shape[a] for a in _entry_axes(e))
                      for e in want]
            assert tuple(n * k for n, k in zip(local, blocks)) \
                == tuple(full), (axes, local, full, want)


def _sites(world, name, logical):
    """Rank 0's spec entries on every `logical` dimension of the case's
    sites."""
    _, _, ranks = world
    return [spec[axes.index(logical)]
            for axes, _, spec in ranks[0][name]["log"] if logical in axes]


@pytest.mark.parametrize("name", SEQ)
def test_sequence_parallel_cuts_the_sequence_over_model(world, name):
    _, _, ranks = world
    assert ranks[0][name]["split"][1]          # the trunk is cut
    seq = _sites(world, name, "act_seq")
    assert seq and all(e == "model" for e in seq), seq
    for logical in ("act_heads", "act_mlp", "act_vocab", "act_ssm_heads"):
        assert all(e is None for e in _sites(world, name, logical))


def test_an_indivisible_sequence_falls_back_to_the_default_layout(world):
    _, _, ranks = world
    assert ranks[0]["dense_fallback_1x4"]["split"] == (False, False)
    assert all(e is None for e in _sites(world, "dense_fallback_1x4",
                                         "act_seq"))
    assert set(_sites(world, "dense_fallback_1x4", "act_heads")) \
        == {"model"}


@pytest.mark.parametrize("name", ["ssm_heads_1x4", "hybrid_heads_2x2"])
def test_default_rules_split_the_mamba_heads_and_the_shared_block(world,
                                                                  name):
    heads = _sites(world, name, "act_ssm_heads")
    assert heads and set(heads) == {"model"}
    if name.startswith("hybrid"):
        assert set(_sites(world, name, "act_heads")) == {"model"}
        assert set(_sites(world, name, "act_mlp")) == {"model"}


def test_autograd_shift_and_reduce_scatter_backwards(world):
    inp, _, ranks = world
    x, w = inp["shift_x"], inp["shift_w"]
    u, v = inp["rs_x"], inp["rs_w"]
    total = u.sum(0)
    for i, r in enumerate(ranks):
        y, gx, z, gu = r["collectives"]
        np.testing.assert_array_equal(y, x[(i - 1) % 4])
        np.testing.assert_array_equal(gx, w[(i + 1) % 4])
        np.testing.assert_allclose(z, total[:, 2 * i:2 * i + 2], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(gu, np.concatenate(list(v), axis=1),
                                   rtol=1e-6)


# ------------------------------------------------- the Mamba state carry

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_the_carry_joins_four_pieces_into_one_scan(impl):
    """`ssd_chunked` on four blocks of a sequence, each from a zero
    state, joined by `carry_in` and `ssd_initial_term`, against one call
    on the whole sequence: y and the gradients of x, dt, A, B and C
    (f32, rtol 1e-5).  Blocks of 12 positions in chunks of 8 pad their
    last chunk."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, p, n, m = 2, 48, 3, 4, 5, 4

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).requires_grad_()
    x, B, C = leaf(b, s, h, p), leaf(b, s, h, n), leaf(b, s, h, n)
    dt = (torch.rand(b, s, h, generator=gen) * 0.5).requires_grad_()
    A = (-torch.rand(h, generator=gen) - 0.5).requires_grad_()
    w = torch.randn(b, s, h, p, generator=gen)
    leaves = (x, dt, A, B, C)

    whole, _ = M.ssd_chunked(x, dt, A, B, C, 8, impl=impl)
    g_whole = torch.autograd.grad((whole * w).sum(), leaves)

    k = s // m
    cut = [slice(j * k, (j + 1) * k) for j in range(m)]
    outs = [M.ssd_chunked(x[:, c], dt[:, c], A, B[:, c], C[:, c], 8,
                          impl=impl) for c in cut]
    states = torch.stack([S for _, S in outs])
    decays = torch.stack([(dt[:, c] * A).sum(dim=1) for c in cut])
    joined = torch.cat([
        y + M.ssd_initial_term(C[:, c], dt[:, c], A,
                               M.carry_in(states, decays, j))
        for j, ((y, _), c) in enumerate(zip(outs, cut))], dim=1)
    g_joined = torch.autograd.grad((joined * w).sum(), leaves)

    torch.testing.assert_close(joined, whole, rtol=1e-5, atol=1e-5)
    for got, want in zip(g_joined, g_whole):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_carry_in_composes_the_blocks_decays():
    """I_r = sum_{j<r} (prod_{j<k<r} D_k) S_j, and block 0 enters at 0."""
    S = torch.arange(1.0, 5.0).reshape(4, 1, 1, 1, 1)
    D = torch.log(torch.tensor([2.0, 3.0, 5.0, 7.0])).reshape(4, 1, 1)
    got = [float(M.carry_in(S, D, r)) for r in range(4)]
    assert got == pytest.approx([0.0, 1.0, 1.0 * 3 + 2, (1.0 * 3 + 2) * 5 + 3])
